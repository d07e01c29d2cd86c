// icp2d_frame: one whole warm-started 2D ICP call (Icp2d::estimate,
// reference src/lib.rs:105-130) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_kernel (wrapper icp2d_frame_pallas, core _icp_outer_loop).
//
// One block of 1024 threads; src, dst and all per-point scratch (at most
// 1536 points each, 9N + 2M floats = 66 KB) sit in dynamic shared memory.
// Outer loop (<= outer_iters): transform src, exact brute-force 1-NN of
// each query over the unsorted sentinel-masked dst (strict '<' in
// ascending index order: the lowest index wins ties), the IRLS loop of
// irls.cuh (the same routine as irls_loop.cu), scalar left-compose, and
// exit when dT is bitwise the identity (the fixed point is exact).
// What bounds it on this card: at these sizes, the latency of the serial
// chain of block-wide passes and barriers on one SM; the O(N*M) NN sweep
// is ~2.4M distance evaluations per outer iteration.
//
// Output (8 floats): r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations (summed over the outer loop).
#include "irls.cuh"

namespace {

__global__ void __launch_bounds__(1024)
icp2d_frame_kernel(const float* __restrict__ src, const float* __restrict__ smask,
                   const float* __restrict__ dst, int n, int m,
                   const float* __restrict__ t0, icp::IrlsParams P,
                   int outer_iters, float* out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* mk = sy + n;
  float* stx = mk + n;
  float* sty = stx + n;
  float* mdx = sty + n;
  float* mdy = mdx + n;
  float* rx = mdy + n;
  float* ry = rx + n;
  float* ddx = ry + n;
  float* ddy = ddx + m;
  __shared__ icp::IrlsShared sh;
  __shared__ float T[6];
  __shared__ int o_it, o_done, o_inner;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < n; i += nthreads) {
    sx[i] = src[2 * i];
    sy[i] = src[2 * i + 1];
    mk[i] = smask[i];
  }
  for (int j = tid; j < m; j += nthreads) {
    ddx[j] = dst[2 * j];
    ddy[j] = dst[2 * j + 1];
  }
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) T[k] = t0[k];
    o_it = 0;
    o_done = 0;
    o_inner = 0;
  }
  __syncthreads();

  while (o_it < outer_iters && o_done == 0) {
    const float r00 = T[0], r01 = T[1], r10 = T[2], r11 = T[3];
    const float tx = T[4], ty = T[5];
    for (int i = tid; i < n; i += nthreads) {
      stx[i] = __fadd_rn(__fadd_rn(__fmul_rn(r00, sx[i]),
                                   __fmul_rn(r01, sy[i])), tx);
      sty[i] = __fadd_rn(__fadd_rn(__fmul_rn(r10, sx[i]),
                                   __fmul_rn(r11, sy[i])), ty);
    }
    __syncthreads();
    for (int i = tid; i < n; i += nthreads) {
      const float qx = stx[i], qy = sty[i];
      float best = INFINITY;
      int bi = 0;
      for (int j = 0; j < m; ++j) {
        const float ex = __fsub_rn(qx, ddx[j]);
        const float ey = __fsub_rn(qy, ddy[j]);
        const float d = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
        if (d < best) {
          best = d;
          bi = j;
        }
      }
      mdx[i] = ddx[bi];
      mdy[i] = ddy[bi];
    }
    __syncthreads();
    float d[7];
    icp::irls_loop(stx, sty, mdx, mdy, mk, n, rx, ry, P, sh, d);
    if (tid == 0) {
      const bool isid = d[0] == 1.0f && d[1] == 0.0f && d[2] == 0.0f &&
                        d[3] == 1.0f && d[4] == 0.0f && d[5] == 0.0f;
      T[0] = d[0] * r00 + d[1] * r10;
      T[1] = d[0] * r01 + d[1] * r11;
      T[2] = d[2] * r00 + d[3] * r10;
      T[3] = d[2] * r01 + d[3] * r11;
      T[4] = d[0] * tx + d[1] * ty + d[4];
      T[5] = d[2] * tx + d[3] * ty + d[5];
      o_it += 1;
      o_inner += (int)d[6];
      o_done = isid ? 1 : 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) out[k] = T[k];
    out[6] = (float)o_it;
    out[7] = (float)o_inner;
  }
}

}  // namespace

extern "C" int icp2d_frame_smem_bytes(int n, int m) {
  return (9 * n + 2 * m) * static_cast<int>(sizeof(float));
}

extern "C" int icp2d_frame_launch(const float* src, const float* smask,
                                  const float* dst, int n, int m,
                                  const float* t0, float* out, float huber_k,
                                  float k2, float two_k, float det_rel_eps,
                                  float tol_d2, int inner_max_iter,
                                  float point_scale, float small_angle,
                                  int outer_iters, void* stream) {
  const int smem = icp2d_frame_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      icp2d_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  icp2d_frame_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      src, smask, dst, n, m, t0, P, outer_iters, out);
  return static_cast<int>(cudaGetLastError());
}
