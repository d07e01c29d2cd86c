// gn_stats_batched: one robust SE(2) Gauss-Newton update's statistics for
// each of B pairs at its own transform, packed into (B, 16) floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _gn_batched_kernel (wrapper gn_stats_pallas_batched).
//
// Grid (B,): one block per pair, each running csrc/irls.cuh's
// gn_stats_block once on its pair's columns, with global pointers offset by
// pair as irls_loop_batched.cu passes them; per-pair residual scratch of
// 2 N floats.  Block size from N (icp::block_threads: 256 threads at
// N = 768), so 209 pairs of 768 points fill the 132 SMs in one wave.  The
// TPU kernel pads B to a multiple of 8 with fully masked rows; blocks need
// no padding here, and a fully masked pair gives the same row: zero sums,
// count 0, sigma 0.  What bounds it on this card: each block's 11 passes
// over its pair's five columns (15 KB at N = 768, from L2) with a barrier
// between passes; bytes and operations are both far below the card's
// rates: latency bound.
//
// Output (B, 16): per pair, gn_stats.cu's layout.
#include "irls.cuh"

namespace {

__global__ void __launch_bounds__(1024)
gn_stats_batched_kernel(const float* __restrict__ sx,
                        const float* __restrict__ sy,
                        const float* __restrict__ dx,
                        const float* __restrict__ dy,
                        const float* __restrict__ mask, int n_pts,
                        const float* __restrict__ rt, float* scratch,
                        icp::IrlsParams P, float* out) {
  __shared__ icp::IrlsShared sh;
  const size_t off = (size_t)blockIdx.x * n_pts;
  const float* m = mask + off;
  const float* p = rt + 6 * blockIdx.x;
  const int n = icp::block_count(m, n_pts, sh);
  float sig_x, sig_y;
  icp::gn_stats_block(sx + off, sy + off, dx + off, dy + off, m, n_pts,
                      scratch + 2 * off, scratch + 2 * off + n_pts, P, sh, n,
                      p[0], p[1], p[2], p[3], p[4], p[5], sig_x, sig_y);
  if (threadIdx.x == 0) {
    float* o = out + 16 * blockIdx.x;
    for (int k = 0; k < icp::kNumSums; ++k) {
      o[k] = icp::block_total(sh, k);
    }
    o[11] = (float)n;
    o[12] = sig_x;
    o[13] = sig_y;
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
}

}  // namespace

// sx, sy, dx, dy, mask: (B, n) row-major float32; rt: (B, 6) r00 r01 r10
// r11 tx ty; scratch: 2 B n floats; out: (B, 16).  Returns
// cudaGetLastError().
extern "C" int gn_stats_batched_launch(const float* sx, const float* sy,
                                       const float* dx, const float* dy,
                                       const float* mask, int b, int n,
                                       const float* rt, float* scratch,
                                       float* out, float huber_k, float k2,
                                       float two_k, void* stream) {
  icp::IrlsParams P{huber_k, k2, two_k, 0.0f, 0.0f, 0, 1.0f, 0.0f};
  gn_stats_batched_kernel<<<b, icp::block_threads(n), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      sx, sy, dx, dy, mask, n, rt, scratch, P, out);
  return static_cast<int>(cudaGetLastError());
}
