// icp2d_frame_pairs: B whole warm-started 2D ICP calls in one launch, one
// block per pair, each pair running its own outer loop to its own
// bit-exact fixed point.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_pairs_kernel (wrapper icp2d_frame_pallas_pairs), which
// serves batched icp2d with frame_backend="pairs".
//
// Grid (B,): block p runs frame.cuh's icp2d_frame_block, the body of
// icp2d_frame.cu, on pair p with its own warm start; src, dst and the
// per-point scratch of the pair sit in the block's dynamic shared memory,
// (9N + 2M) * 4 bytes (27.6 KB at 768 x 768, 67.6 KB at the 1536-point
// limit, which needs the opt-in above 48 KB).  Block size from N
// (icp::block_threads: 256 threads at N = 768), so several pairs share an
// SM and 209 pairs run in one wave.  The db is unsorted and
// sentinel-masked, as in icp2d_frame.cu.
//
// What bounds it on this card: each pair's serial chain of outer
// iterations (brute-force NN sweep, then ~11 block-wide passes per IRLS
// iteration); the pair with the longest chain sets the launch's length.
// The NN sweep is N*M ~ 590k distance evaluations per pair and outer
// iteration at 768 x 768.
//
// Output (B, 8): per pair r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations.
#include "frame.cuh"

namespace {

__global__ void __launch_bounds__(1024)
icp2d_frame_pairs_kernel(const float* __restrict__ src,
                         const float* __restrict__ smask,
                         const float* __restrict__ dst, int n, int m,
                         const float* __restrict__ t0, icp::IrlsParams P,
                         int outer_iters, float* out) {
  extern __shared__ float smem[];
  __shared__ icp::FrameShared fs;
  const size_t p = blockIdx.x;
  icp::icp2d_frame_block(src + p * 2 * n, smask + p * n, dst + p * 2 * m, n,
                         m, t0 + p * 6, P, outer_iters, smem, fs,
                         out + p * 8);
}

}  // namespace

// src (B, n, 2), smask (B, n), dst (B, m, 2) sentinel-masked, t0 (B, 6)
// as r00 r01 r10 r11 tx ty; out (B, 8).
extern "C" int icp2d_frame_pairs_launch(const float* src, const float* smask,
                                        const float* dst, int b, int n, int m,
                                        const float* t0, float* out,
                                        float huber_k, float k2, float two_k,
                                        float det_rel_eps, float tol_d2,
                                        int inner_max_iter, float point_scale,
                                        float small_angle, int outer_iters,
                                        void* stream) {
  const int smem = icp::frame_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      icp2d_frame_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  icp2d_frame_pairs_kernel<<<b, icp::block_threads(n), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      src, smask, dst, n, m, t0, P, outer_iters, out);
  return static_cast<int>(cudaGetLastError());
}
