// irls_loop_batched: the whole fixed-correspondence robust SE(2) IRLS loop
// (<= inner_max_iter iterations) for B pairs in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _inner_loop_batched_kernel (wrapper estimate_transform_pallas_batched),
// which serves the lockstep outer loop of batched ICP.
//
// Grid (B,): one block per pair, each running irls.cuh's irls_loop on its
// pair's columns, with global pointers offset by pair as irls_loop.cu
// passes them; per-pair rx/ry scratch of 2 N floats.  The TPU kernel
// loops each 64-pair block until all its pairs are done, freezing a done
// pair's carry; here each pair stops on its own, which gives the same
// per-pair result.  The iteration count in the output is the pair's own
// (the TPU kernel reports its block's).  Block size from N
// (icp::block_threads: 256 threads at N = 768), so 209 pairs of 768
// points fill the 132 SMs in one wave.
//
// What bounds it on this card: per IRLS iteration each block makes ~11
// passes over its pair's five columns (15 KB at N = 768, from L2) with a
// barrier between passes; the pair with the most iterations sets the
// launch's length.  Bytes and operations are both far below the card's
// rates: latency bound.
//
// Output (B, 8): r00 r01 r10 r11 tx ty iterations 0.
#include "irls.cuh"

namespace {

__global__ void __launch_bounds__(1024)
irls_loop_batched_kernel(const float* __restrict__ sx,
                         const float* __restrict__ sy,
                         const float* __restrict__ dx,
                         const float* __restrict__ dy,
                         const float* __restrict__ mask, int n,
                         float* scratch, icp::IrlsParams P, float* out) {
  __shared__ icp::IrlsShared sh;
  const size_t off = (size_t)blockIdx.x * n;
  float res[7];
  icp::irls_loop(sx + off, sy + off, dx + off, dy + off, mask + off, n,
                 scratch + 2 * off, scratch + 2 * off + n, P, sh, res);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 7; ++k) out[blockIdx.x * 8 + k] = res[k];
    out[blockIdx.x * 8 + 7] = 0.0f;
  }
}

}  // namespace

// sx, sy, dx, dy, mask (B, n) row-major; scratch 2 B n floats; out (B, 8).
extern "C" int irls_loop_batched_launch(const float* sx, const float* sy,
                                        const float* dx, const float* dy,
                                        const float* mask, int b, int n,
                                        float* scratch, float* out,
                                        float huber_k, float k2, float two_k,
                                        float det_rel_eps, float tol_d2,
                                        int max_iter, float point_scale,
                                        float small_angle, void* stream) {
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, max_iter,
                    point_scale, small_angle};
  irls_loop_batched_kernel<<<b, icp::block_threads(n), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      sx, sy, dx, dy, mask, n, scratch, P, out);
  return static_cast<int>(cudaGetLastError());
}
