// gn_stats: one robust SE(2) Gauss-Newton update's statistics at a given
// transform, packed into 16 floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:_gn_kernel
// (wrapper gn_stats_pallas; assemble_update unpacks the result).
//
// One block of 1024 threads runs csrc/irls.cuh's gn_stats_block once: the
// same passes, sums and order as one iteration of irls_loop.cu, with the
// transform read from a (6,) device array.  The inputs (5 N floats, 576 KB
// at N = 28,800) and the 2 N-float residual scratch stay resident in L2 and
// the block streams them, as irls_loop.cu does.  What bounds it on this
// card: the serial chain of 11 block-wide passes and their barriers on one
// SM (L2 bandwidth of one SM and latency), not device memory or
// arithmetic.  The 3x3 solve stays with the caller
// (ops/align2d.weighted_gn_update_cuda), as on the TPU.
//
// Output (16 floats), _gn_kernel's layout: S_u, S_uw, S_uw2, S_ur, S_uwr of
// x, the same five of y, the Huber error, the mask-true count, sigma_x,
// sigma_y, 0, 0.
#include "irls.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ dx, const float* __restrict__ dy,
                const float* __restrict__ mask, int n_pts,
                const float* __restrict__ rt, float* scratch,
                icp::IrlsParams P, float* out) {
  __shared__ icp::IrlsShared sh;
  const int n = icp::block_count(mask, n_pts, sh);
  float sig_x, sig_y;
  icp::gn_stats_block(sx, sy, dx, dy, mask, n_pts, scratch, scratch + n_pts,
                      P, sh, n, rt[0], rt[1], rt[2], rt[3], rt[4], rt[5],
                      sig_x, sig_y);
  if (threadIdx.x == 0) {
    for (int k = 0; k < icp::kNumSums; ++k) {
      out[k] = icp::block_total(sh, k);
    }
    out[11] = (float)n;
    out[12] = sig_x;
    out[13] = sig_y;
    out[14] = 0.0f;
    out[15] = 0.0f;
  }
}

}  // namespace

// sx, sy, dx, dy, mask: (n,) float32 each; rt: (6,) r00 r01 r10 r11 tx ty;
// scratch: 2 n floats; out: (16,).  Returns cudaGetLastError().
extern "C" int gn_stats_launch(const float* sx, const float* sy,
                               const float* dx, const float* dy,
                               const float* mask, int n, const float* rt,
                               float* scratch, float* out, float huber_k,
                               float k2, float two_k, void* stream) {
  icp::IrlsParams P{huber_k, k2, two_k, 0.0f, 0.0f, 0, 1.0f, 0.0f};
  gn_stats_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sx, sy, dx, dy, mask, n, rt, scratch, P, out);
  return static_cast<int>(cudaGetLastError());
}
