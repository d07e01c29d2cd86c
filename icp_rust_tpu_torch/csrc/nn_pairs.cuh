// The per-chunk step shared by the pair-grid 1-NN kernels nn_pairs.cu
// (static sweep) and nn_pairs_list.cu (survivor lists).
//
// One block per (pair, query subtile), one thread per query.  The block
// stages one 128-point chunk of its pair's coordinate-major db (D
// coordinate rows, then F payload rows, each m_pad long) into shared
// memory; each thread then sweeps the chunk's points in ascending order
// with a strict '<' on its scalar (distance, index, payload) carry.
// Chunks are walked in ascending order, so the lowest index wins ties
// with no extra compare.  Every thread of the block must call walk_chunk
// for the same chunks (it holds two barriers): the walk decision is
// block-uniform.
//
// The squared distance is ((0 + dx*dx) + dy*dy) + dz*dz with every
// rounding explicit (and the files built with --fmad=false), the
// operations of the plain version in ops/nn_pairs_cuda.py, so the two
// agree bitwise.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace icp_nn {

constexpr int kChunk = 128;

template <int D, int F>
__device__ __forceinline__ void walk_chunk(const float* __restrict__ db,
                                           int m_pad, int ch,
                                           float (&tile)[D + F][kChunk],
                                           const float (&qv)[D], float& best,
                                           int& bi, float (&bp)[F]) {
  __syncthreads();
  for (int e = threadIdx.x; e < (D + F) * kChunk; e += blockDim.x) {
    const int row = e / kChunk, col = e % kChunk;
    tile[row][col] = db[(size_t)row * m_pad + (size_t)ch * kChunk + col];
  }
  __syncthreads();
  for (int j = 0; j < kChunk; ++j) {
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float df = __fsub_rn(qv[k], tile[k][j]);
      d = __fadd_rn(d, __fmul_rn(df, df));
    }
    if (d < best) {
      best = d;
      bi = ch * kChunk + j;
#pragma unroll
      for (int f = 0; f < F; ++f) bp[f] = tile[D + f][j];
    }
  }
}

// The (pair, subtile) this block serves, its queries' row, and the
// thread's query coordinates.
struct PairTile {
  int pair;
  int sub;
  int n_qt;
  size_t q;
};

__device__ __forceinline__ PairTile pair_tile(int qp) {
  PairTile t;
  t.n_qt = qp / blockDim.x;
  t.pair = blockIdx.x / t.n_qt;
  t.sub = blockIdx.x % t.n_qt;
  t.q = (size_t)t.pair * qp + (size_t)t.sub * blockDim.x + threadIdx.x;
  return t;
}

template <int D, int F>
__device__ __forceinline__ void store_result(size_t q, float best, int bi,
                                             const float (&bp)[F],
                                             float* __restrict__ dist,
                                             int* __restrict__ idx,
                                             float* __restrict__ pay) {
  dist[q] = best;
  idx[q] = bi;
#pragma unroll
  for (int f = 0; f < F; ++f) pay[q * F + f] = bp[f];
}

}  // namespace icp_nn

// Instantiate a launcher for every supported (D, F): the query's
// coordinates and the payload rows, each 2 or 3.
#define ICP_NN_PAIRS_DISPATCH(LAUNCH, ...)                   \
  if (d_dim == 2 && f_dim == 2) return LAUNCH<2, 2>(__VA_ARGS__); \
  if (d_dim == 2 && f_dim == 3) return LAUNCH<2, 3>(__VA_ARGS__); \
  if (d_dim == 3 && f_dim == 2) return LAUNCH<3, 2>(__VA_ARGS__); \
  if (d_dim == 3 && f_dim == 3) return LAUNCH<3, 3>(__VA_ARGS__); \
  return static_cast<int>(cudaErrorInvalidValue);
