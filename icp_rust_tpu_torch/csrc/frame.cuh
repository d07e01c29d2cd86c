// One whole warm-started 2D ICP call (Icp2d::estimate, reference
// src/lib.rs:105-130) as one thread block.
//
// Shared by icp2d_frame.cu (one pair, one launch) and icp2d_frame_pairs.cu
// (one block per pair of a batch), so both run one op sequence, as the
// TPU kernels shared align2d_pallas._icp_outer_loop.
//
// src, dst and all per-point scratch (at most 1536 points each, 9N + 2M
// floats) sit in dynamic shared memory.  Outer loop (<= outer_iters):
// transform src, exact brute-force 1-NN of each query over the unsorted
// sentinel-masked dst (strict '<' in ascending index order: the lowest
// index wins ties), the IRLS loop of irls.cuh, scalar left-compose, and
// exit when dT is bitwise the identity (the fixed point is exact).
#pragma once

#include "irls.cuh"

namespace icp {

struct FrameShared {
  IrlsShared sh;
  float T[6];
  int it;
  int done;
  int inner;
};

__host__ __device__ inline int frame_smem_bytes(int n, int m) {
  return (9 * n + 2 * m) * static_cast<int>(sizeof(float));
}

// src (n, 2) and dst (m, 2) interleaved, smask (n,), t0 6 floats; every
// block thread calls it.  Writes out[0..7] = r00 r01 r10 r11 tx ty,
// outer iterations, inner iterations summed over the outer loop.
__device__ void icp2d_frame_block(const float* __restrict__ src,
                                  const float* __restrict__ smask,
                                  const float* __restrict__ dst, int n,
                                  int m, const float* __restrict__ t0,
                                  const IrlsParams& P, int outer_iters,
                                  float* smem, FrameShared& fs,
                                  float* out) {
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
  float* T = fs.T;

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
    fs.it = 0;
    fs.done = 0;
    fs.inner = 0;
  }
  __syncthreads();

  while (fs.it < outer_iters && fs.done == 0) {
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
    irls_loop(stx, sty, mdx, mdy, mk, n, rx, ry, P, fs.sh, d);
    if (tid == 0) {
      const bool isid = d[0] == 1.0f && d[1] == 0.0f && d[2] == 0.0f &&
                        d[3] == 1.0f && d[4] == 0.0f && d[5] == 0.0f;
      T[0] = d[0] * r00 + d[1] * r10;
      T[1] = d[0] * r01 + d[1] * r11;
      T[2] = d[2] * r00 + d[3] * r10;
      T[3] = d[2] * r01 + d[3] * r11;
      T[4] = d[0] * tx + d[1] * ty + d[4];
      T[5] = d[2] * tx + d[3] * ty + d[5];
      fs.it += 1;
      fs.inner += (int)d[6];
      fs.done = isid ? 1 : 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) out[k] = T[k];
    out[6] = (float)fs.it;
    out[7] = (float)fs.inner;
  }
}

}  // namespace icp
