// The block routine of the plain 1-NN sweep nn_sweep.cu (kernel 5, no
// payload).
//
// One block per group of kSub queries, one thread per query; a leading
// batch axis is folded into the grid (blockIdx.x = pair * n_groups +
// group).  The block stages kStage points of its db (coordinate-major: D
// sentinel-filled coordinate rows, each m_pad long) into shared memory;
// each thread then sweeps them in ascending order against its scalar
// (distance, index) carry with a strict '<': the first seen, i.e. the
// lowest index, wins ties.  Every thread of the block calls sweep_stage
// for the same points (it holds two barriers).
//
// With no valid db point a query gets (+inf, 0): sentinel distances
// overflow to +inf and never win.  The squared distance is
// ((0 + dx*dx) + dy*dy) + dz*dz with every rounding explicit (and the
// file built with --fmad=false), the operations of the plain version in
// ops/nn_sweep_cuda.py, so the two agree bitwise.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace icp_sweep {

constexpr int kSub = 128;
constexpr int kStage = 128;

template <int D>
__device__ __forceinline__ void sweep_stage(const float* __restrict__ db,
                                            int m_pad, int base,
                                            float (&stage)[D][kStage],
                                            const float (&qv)[D],
                                            float& best, int& bi) {
  __syncthreads();
  for (int e = threadIdx.x; e < D * kStage; e += blockDim.x) {
    const int row = e / kStage, col = e % kStage;
    stage[row][col] = db[(size_t)row * m_pad + base + col];
  }
  __syncthreads();
  for (int j = 0; j < kStage; ++j) {
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float df = __fsub_rn(qv[k], stage[k][j]);
      d = __fadd_rn(d, __fmul_rn(df, df));
    }
    if (d < best) {
      best = d;
      bi = base + j;
    }
  }
}

// query (B, qp, D); db_cm (B, D, m_pad); outputs dist/idx (B, qp).
template <int D>
__global__ void __launch_bounds__(kSub)
nn_sweep_kernel(const float* __restrict__ query,
                const float* __restrict__ db_cm, float* __restrict__ dist,
                int* __restrict__ idx, int qp, int m_pad) {
  __shared__ float stage[D][kStage];
  const int n_groups = qp / kSub;
  const int pair = blockIdx.x / n_groups;
  const int group = blockIdx.x % n_groups;
  const size_t q = (size_t)pair * qp + (size_t)group * kSub + threadIdx.x;
  const float* db = db_cm + (size_t)pair * D * m_pad;

  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[q * D + k];
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < m_pad; base += kStage)
    sweep_stage<D>(db, m_pad, base, stage, qv, best, bi);
  dist[q] = best;
  idx[q] = bi;
}

template <int D>
int launch(const float* query, const float* db_cm, float* dist, int* idx,
           int b, int qp, int m_pad, cudaStream_t stream) {
  nn_sweep_kernel<D><<<b * (qp / kSub), kSub, 0, stream>>>(
      query, db_cm, dist, idx, qp, m_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace icp_sweep
