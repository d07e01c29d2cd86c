// nn_pairs: pair-grid exact 1-NN with matched payload, static sweep.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_pairs_kernel
// (wrapper _nn_pairs_impl, dispatch nn_pallas_matched_pairs), which serves
// the cold outer iteration of batched ICP.
//
// Grid: one block per (pair, subtile of q_sub queries), one thread per
// query, flattened as pair * n_subtiles + subtile.  For each 128-point
// chunk of its pair's db, in ascending order, the block evaluates the
// seed-only prune test lb <= bound: lb is the squared distance between
// the subtile's query box and the chunk's box (dims summed in order,
// deflated by 1 - 16 eps), bound the subtile's upper bound on its
// queries' NN distance².  The test is the same for every thread, so the
// branch and its barriers are block-uniform, as on the TPU.  On the cold
// iteration every bound is +inf and every chunk is walked; padded pairs
// and queries carry -inf and walk nothing.  With no valid point the
// result is (+inf, 0, 0).
//
// What bounds it on this card: at 209 pairs x 768 queries x 768 points,
// 123M (query, point) pairs of ~8 operations each, about 1 GFLOP: 15 us
// at the card's float32 rate; the db (15 KB per pair) is read from L2
// once per block and staged chunk by chunk.  The design spends one barrier
// pair per chunk and one thread per query; 627 blocks of 256 threads fill
// the 132 SMs in one wave.
//
// The per-chunk step (walk_chunk): the block stages one 128-point chunk of
// its pair's coordinate-major db (D coordinate rows, then F payload rows,
// each m_pad long) into shared memory; each thread then sweeps the chunk's
// points in ascending order with a strict '<' on its scalar (distance,
// index, payload) carry, so the lowest index wins ties.  Every thread of
// the block calls it for the same chunks (it holds two barriers): the walk
// decision is block-uniform.  The squared distance is ((0 + dx*dx) +
// dy*dy) + dz*dz with every rounding explicit (the file built with
// --fmad=false), the operations of the plain version in
// ops/nn_pairs_cuda.py, so the two agree bitwise.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

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

template <int D, int F>
__global__ void __launch_bounds__(1024)
nn_pairs_kernel(const float* __restrict__ query,
                const float* __restrict__ dbf_cm,
                const float* __restrict__ qbox,
                const float* __restrict__ cbox,
                const float* __restrict__ qbound, float* __restrict__ dist,
                int* __restrict__ idx, float* __restrict__ pay, int qp,
                int m_pad) {
  __shared__ float tile[D + F][kChunk];
  const PairTile pt = pair_tile(qp);
  const int nc = m_pad / kChunk;
  const float* db = dbf_cm + (size_t)pt.pair * (D + F) * m_pad;
  const size_t row = (size_t)pt.pair * pt.n_qt + pt.sub;
  const float* qb = qbox + row * 8;
  const float* cb = cbox + (size_t)pt.pair * nc * 8;
  const float bound = qbound[row];
  constexpr float kDeflate = 1.0f - 16.0f * FLT_EPSILON;

  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[pt.q * D + k];
  float best = INFINITY;
  int bi = 0;
  float bp[F];
#pragma unroll
  for (int f = 0; f < F; ++f) bp[f] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    float lb = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float a = __fsub_rn(cb[c * 8 + k], qb[4 + k]);
      const float b = __fsub_rn(qb[k], cb[c * 8 + 4 + k]);
      const float gap = fmaxf(fmaxf(a, b), 0.0f);
      lb = __fadd_rn(lb, __fmul_rn(gap, gap));
    }
    lb = __fmul_rn(lb, kDeflate);
    if (lb <= bound) {
      walk_chunk<D, F>(db, m_pad, c, tile, qv, best, bi, bp);
    }
  }
  store_result<D, F>(pt.q, best, bi, bp, dist, idx, pay);
}

template <int D, int F>
int launch(const float* query, const float* dbf_cm, const float* qbox,
           const float* cbox, const float* qbound, float* dist, int* idx,
           float* pay, int b, int qp, int q_sub, int m_pad,
           cudaStream_t stream) {
  nn_pairs_kernel<D, F><<<b * (qp / q_sub), q_sub, 0, stream>>>(
      query, dbf_cm, qbox, cbox, qbound, dist, idx, pay, qp, m_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query (B, qp, d_dim); dbf_cm (B, d_dim + f_dim, m_pad); qbox
// (B, qp / q_sub, 8); cbox (B, m_pad / 128, 8); qbound (B, qp / q_sub);
// outputs dist/idx (B, qp) and pay (B, qp, f_dim).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// (d_dim, f_dim).
extern "C" int nn_pairs_launch(const float* query, const float* dbf_cm,
                               const float* qbox, const float* cbox,
                               const float* qbound, float* dist, int* idx,
                               float* pay, int b, int qp, int q_sub,
                               int d_dim, int f_dim, int m_pad,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_PAIRS_CASE(D, F)                                                 \
  if (d_dim == D && f_dim == F)                                             \
    return launch<D, F>(query, dbf_cm, qbox, cbox, qbound, dist, idx, pay, b, \
                        qp, q_sub, m_pad, s);
  NN_PAIRS_CASE(2, 2) NN_PAIRS_CASE(2, 3) NN_PAIRS_CASE(3, 2)
  NN_PAIRS_CASE(3, 3)
#undef NN_PAIRS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
