// nn_list: survivor-list exact 1-NN with matched payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_list_kernel
// (wrappers _nn_list_2d, _nn_seeded_2d).
//
// One block per query tile of q_tile queries, one thread per query.  For
// each chunk of 128 db points in the tile's survivor list (all n_chunks
// chunks when cnt > cap), the block stages the chunk's D coordinate rows
// and F payload rows from the coordinate-major dbf_cm (D + F, m_pad) into
// shared memory; each thread then sweeps the 128 points in ascending
// order with a strict '<' on (distance, index, payload).  Lists are in
// ascending chunk order, so the lowest index wins ties with no extra
// compare.  With no valid point the result is (+inf, 0, 0).
//
// The squared distance is ((0 + dx*dx) + dy*dy) + dz*dz with every
// rounding explicit (and the file built with --fmad=false), the same
// operations as the plain version in ops/nn_cuda.py, so the two agree
// bitwise.
//
// What bounds it on this card: the longest tile.  The survivor lists keep
// the walked pairs to a few percent of the full sweep (a warm 28,800-point
// iteration walks 13 of 240 chunks per tile on average), and bytes are
// small (a walked chunk is 2.5 KB from L2), but a tile whose list
// overflows the cap walks every chunk alone on one SM, 10 operations per
// (query, point) pair and a barrier per chunk, and the launch lasts as
// long as that tile (PERF.md).  Splitting such a tile over several blocks
// is left for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;

template <int D, int F>
__global__ void nn_list_kernel(const float* __restrict__ query,
                               const float* __restrict__ dbf_cm,
                               const int* __restrict__ lists,
                               const int* __restrict__ cnt,
                               float* __restrict__ dist,
                               int* __restrict__ idx,
                               float* __restrict__ pay, int m_pad,
                               int n_chunks, int cap) {
  __shared__ float chunk[D + F][kChunk];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int q = tile * blockDim.x + tid;
  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[q * D + k];
  float best = INFINITY;
  int bi = 0;
  float bp[F > 0 ? F : 1];
#pragma unroll
  for (int f = 0; f < (F > 0 ? F : 1); ++f) bp[f] = 0.0f;

  const int c = cnt[tile];
  const bool full = c > cap;
  const int walk = full ? n_chunks : c;
  for (int w = 0; w < walk; ++w) {
    const int ch = full ? w : lists[tile * cap + w];
    __syncthreads();
    for (int e = tid; e < (D + F) * kChunk; e += blockDim.x) {
      const int row = e / kChunk, col = e % kChunk;
      chunk[row][col] =
          dbf_cm[(size_t)row * m_pad + (size_t)ch * kChunk + col];
    }
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float df = __fsub_rn(qv[k], chunk[k][j]);
        d = __fadd_rn(d, __fmul_rn(df, df));
      }
      if (d < best) {
        best = d;
        bi = ch * kChunk + j;
#pragma unroll
        for (int f = 0; f < F; ++f) bp[f] = chunk[D + f][j];
      }
    }
  }
  dist[q] = best;
  idx[q] = bi;
#pragma unroll
  for (int f = 0; f < F; ++f) pay[(size_t)q * F + f] = bp[f];
}

template <int D, int F>
cudaError_t launch(const float* query, const float* dbf_cm, const int* lists,
                   const int* cnt, float* dist, int* idx, float* pay,
                   int n_tiles, int q_tile, int m_pad, int cap,
                   cudaStream_t stream) {
  nn_list_kernel<D, F><<<n_tiles, q_tile, 0, stream>>>(
      query, dbf_cm, lists, cnt, dist, idx, pay, m_pad, m_pad / kChunk, cap);
  return cudaGetLastError();
}

}  // namespace

// query (n_tiles*q_tile, d_dim) row-major; dbf_cm (d_dim + f_dim, m_pad);
// lists (n_tiles, cap); cnt (n_tiles,); outputs dist/idx (n_tiles*q_tile,)
// and pay (n_tiles*q_tile, f_dim).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported (d_dim, f_dim).
extern "C" int nn_list_launch(const float* query, const float* dbf_cm,
                              const int* lists, const int* cnt, float* dist,
                              int* idx, float* pay, int n_tiles, int q_tile,
                              int d_dim, int f_dim, int m_pad, int cap,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_LIST_CASE(D, F)                                                  \
  if (d_dim == D && f_dim == F)                                             \
    return static_cast<int>(launch<D, F>(query, dbf_cm, lists, cnt, dist,   \
                                         idx, pay, n_tiles, q_tile, m_pad,  \
                                         cap, s));
  NN_LIST_CASE(2, 0) NN_LIST_CASE(2, 1) NN_LIST_CASE(2, 2)
  NN_LIST_CASE(2, 3) NN_LIST_CASE(2, 4) NN_LIST_CASE(2, 5)
  NN_LIST_CASE(2, 6)
  NN_LIST_CASE(3, 0) NN_LIST_CASE(3, 1) NN_LIST_CASE(3, 2)
  NN_LIST_CASE(3, 3) NN_LIST_CASE(3, 4) NN_LIST_CASE(3, 5)
#undef NN_LIST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
