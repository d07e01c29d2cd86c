// irls_loop: the whole fixed-correspondence robust SE(2) IRLS loop
// (<= inner_max_iter iterations) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _inner_loop_kernel (wrapper estimate_transform_pallas, core _irls_loop).
//
// Design choice (a): ONE block of 1024 threads.  The five input arrays
// (576 KB at N = 28,800) do not fit one SM's 227 KB of shared memory; they
// and the 230 KB rx/ry scratch stay resident in the 50 MB L2, and the
// block streams them on every pass (11 passes per iteration: residuals,
// 4 radix + 1 count/max pass for each of median and MAD, one sums pass).
// What bounds it on this card: the serial chain of block-wide passes and
// barriers on one SM, i.e. L2 bandwidth of one SM and latency, not device
// memory or arithmetic (the whole card's rate is a loose bound here).  A
// thread-block cluster holding the problem in distributed shared memory
// (option b) is left for a later change.
//
// Output (8 floats): r00 r01 r10 r11 tx ty iterations 0.
#include "irls.cuh"

namespace {

__global__ void __launch_bounds__(1024)
irls_loop_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ mask, int n, float* scratch,
                 icp::IrlsParams P, float* out) {
  __shared__ icp::IrlsShared sh;
  float res[7];
  icp::irls_loop(sx, sy, dx, dy, mask, n, scratch, scratch + n, P, sh, res);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 7; ++k) out[k] = res[k];
    out[7] = 0.0f;
  }
}

}  // namespace

extern "C" int irls_loop_launch(const float* sx, const float* sy,
                                const float* dx, const float* dy,
                                const float* mask, int n, float* scratch,
                                float* out, float huber_k, float k2,
                                float two_k, float det_rel_eps, float tol_d2,
                                int max_iter, float point_scale,
                                float small_angle, void* stream) {
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, max_iter,
                    point_scale, small_angle};
  irls_loop_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      sx, sy, dx, dy, mask, n, scratch, P, out);
  return static_cast<int>(cudaGetLastError());
}
