// icp2d_frame: one whole warm-started 2D ICP call (Icp2d::estimate,
// reference src/lib.rs:105-130) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_kernel (wrapper icp2d_frame_pallas, core _icp_outer_loop).
//
// One block of 1024 threads running frame.cuh's icp2d_frame_block (the
// body icp2d_frame_pairs.cu runs per pair); src, dst and all per-point
// scratch (at most 1536 points each, 9N + 2M floats = 66 KB) sit in
// dynamic shared memory.
// What bounds it on this card: at these sizes, the latency of the serial
// chain of block-wide passes and barriers on one SM; the O(N*M) NN sweep
// is ~2.4M distance evaluations per outer iteration.
//
// Output (8 floats): r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations (summed over the outer loop).
#include "frame.cuh"

namespace {

__global__ void __launch_bounds__(1024)
icp2d_frame_kernel(const float* __restrict__ src, const float* __restrict__ smask,
                   const float* __restrict__ dst, int n, int m,
                   const float* __restrict__ t0, icp::IrlsParams P,
                   int outer_iters, float* out) {
  extern __shared__ float smem[];
  __shared__ icp::FrameShared fs;
  icp::icp2d_frame_block(src, smask, dst, n, m, t0, P, outer_iters, smem,
                         fs, out);
}

}  // namespace

extern "C" int icp2d_frame_smem_bytes(int n, int m) {
  return icp::frame_smem_bytes(n, m);
}

extern "C" int icp2d_frame_launch(const float* src, const float* smask,
                                  const float* dst, int n, int m,
                                  const float* t0, float* out, float huber_k,
                                  float k2, float two_k, float det_rel_eps,
                                  float tol_d2, int inner_max_iter,
                                  float point_scale, float small_angle,
                                  int outer_iters, void* stream) {
  const int smem = icp::frame_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      icp2d_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  icp2d_frame_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      src, smask, dst, n, m, t0, P, outer_iters, out);
  return static_cast<int>(cudaGetLastError());
}
