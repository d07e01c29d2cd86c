// The block routine shared by the plain 1-NN sweeps nn_sweep.cu (kernel
// 5, no payload), nn_matched.cu (kernel 4, with the winner's payload) and
// the zig-zag pruned sweep nn_pruned.cu (kernel 6, optional payload).
//
// One block per group of kSub queries, one thread per query.  The block
// stages kStage points of its db (coordinate-major: D sentinel-filled
// coordinate rows, then F payload rows, each m_pad long) into shared
// memory; each thread then sweeps them in ascending order against its
// scalar (distance, index, payload) carry.  Every thread of the block
// calls sweep_stage for the same points (it holds two barriers).
//
// - PRUNED = false (kernels 4 and 5): the whole db, ascending, with a
//   strict '<': the first seen, i.e. the lowest index, wins ties.  A
//   leading batch axis is folded into the grid (blockIdx.x = pair *
//   n_groups + group).
// - PRUNED = true (kernel 6): one cloud.  The db tiles of the block's
//   query tile i are visited diagonal first (s..n-1 ascending, then
//   s-1..0 descending, s = i q_tile / db_tile) and the carry update is
//   lexicographic on (distance, index), so the lowest index wins ties in
//   that order too.  A tile after the first is skipped when the squared
//   distance between the query tile's box and the db tile's box (dims
//   summed in order, deflated by 1 - 16 eps) is above the block's
//   threshold: min(max of its queries' current bests, qb_tile[i]),
//   refreshed by a block-wide max after every swept tile.  The test reads
//   block-uniform values only, so the branch and its barriers are uniform.
//   A skipped tile holds no point of any of the block's queries' tie sets:
//   the result is the unpruned sweep's, bit for bit.
//
// With no valid db point a query gets (+inf, 0, 0): sentinel distances
// overflow to +inf and never win.  The squared distance is
// ((0 + dx*dx) + dy*dy) + dz*dz with every rounding explicit (and the
// files built with --fmad=false), the operations of the plain versions in
// ops/nn_sweep_cuda.py, so the two agree bitwise.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace icp_sweep {

constexpr int kSub = 128;
constexpr int kStage = 128;

template <int F>
struct Carry {
  float best;
  int bi;
  float bp[F > 0 ? F : 1];
};

template <int D, int F, bool LEX>
__device__ __forceinline__ void sweep_stage(const float* __restrict__ db,
                                            int m_pad, int base,
                                            float (&stage)[D + F][kStage],
                                            const float (&qv)[D],
                                            Carry<F>& c) {
  __syncthreads();
  for (int e = threadIdx.x; e < (D + F) * kStage; e += blockDim.x) {
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
    const int gi = base + j;
    const bool better =
        LEX ? (d < c.best || (d == c.best && gi < c.bi)) : (d < c.best);
    if (better) {
      c.best = d;
      c.bi = gi;
#pragma unroll
      for (int f = 0; f < F; ++f) c.bp[f] = stage[D + f][j];
    }
  }
}

// Max of every thread's value, returned to all threads of the block.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kSub / 32; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

// query (B, qp, D); dbf_cm (B, D + F, m_pad); outputs dist/idx (B, qp),
// pay (B, qp, F).  PRUNED: B = 1, qbox (qp / q_tile, 8) and qb_tile
// (qp / q_tile,) per query tile, bbox (m_pad / db_tile, 8) per db tile.
template <int D, int F, bool PRUNED>
__global__ void __launch_bounds__(kSub)
nn_sweep_kernel(const float* __restrict__ query,
                const float* __restrict__ dbf_cm,
                const float* __restrict__ qbox,
                const float* __restrict__ bbox,
                const float* __restrict__ qb_tile, float* __restrict__ dist,
                int* __restrict__ idx, float* __restrict__ pay, int qp,
                int m_pad, int q_tile, int db_tile) {
  __shared__ float stage[D + F][kStage];
  __shared__ float red[kSub / 32];
  const int n_groups = qp / kSub;
  const int pair = blockIdx.x / n_groups;
  const int group = blockIdx.x % n_groups;
  const size_t q = (size_t)pair * qp + (size_t)group * kSub + threadIdx.x;
  const float* db = dbf_cm + (size_t)pair * (D + F) * m_pad;

  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[q * D + k];
  Carry<F> c;
  c.best = INFINITY;
  c.bi = 0;
#pragma unroll
  for (int f = 0; f < (F > 0 ? F : 1); ++f) c.bp[f] = 0.0f;

  if constexpr (!PRUNED) {
    for (int base = 0; base < m_pad; base += kStage)
      sweep_stage<D, F, false>(db, m_pad, base, stage, qv, c);
  } else {
    constexpr float kDeflate = 1.0f - 16.0f * FLT_EPSILON;
    const int qt = group * kSub / q_tile;
    const int n_db = m_pad / db_tile;
    const int start = qt * q_tile / db_tile;
    const float* qb = qbox + (size_t)qt * 8;
    const float bound = qb_tile[qt];
    float maxd = bound;
    for (int j = 0; j < n_db; ++j) {
      const int tile = j >= n_db - start ? n_db - 1 - j : start + j;
      const float* tb = bbox + (size_t)tile * 8;
      float lb = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float a = __fsub_rn(tb[k], qb[4 + k]);
        const float b = __fsub_rn(qb[k], tb[4 + k]);
        const float gap = fmaxf(fmaxf(a, b), 0.0f);
        lb = __fadd_rn(lb, __fmul_rn(gap, gap));
      }
      lb = __fmul_rn(lb, kDeflate);
      if (j == 0 || lb <= maxd) {
        const int end = (tile + 1) * db_tile;
        for (int base = tile * db_tile; base < end; base += kStage)
          sweep_stage<D, F, true>(db, m_pad, base, stage, qv, c);
        maxd = fminf(block_max(c.best, red), bound);
      }
    }
  }
  dist[q] = c.best;
  idx[q] = c.bi;
#pragma unroll
  for (int f = 0; f < F; ++f) pay[q * F + f] = c.bp[f];
}

template <int D, int F, bool PRUNED>
int launch(const float* query, const float* dbf_cm, const float* qbox,
           const float* bbox, const float* qb_tile, float* dist, int* idx,
           float* pay, int b, int qp, int m_pad, int q_tile, int db_tile,
           cudaStream_t stream) {
  nn_sweep_kernel<D, F, PRUNED><<<b * (qp / kSub), kSub, 0, stream>>>(
      query, dbf_cm, qbox, bbox, qb_tile, dist, idx, pay, qp, m_pad, q_tile,
      db_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace icp_sweep
