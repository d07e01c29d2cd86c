// nn_pairs_list: pair-grid survivor-list exact 1-NN with matched payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:
// _nn_pairs_list_kernel (wrapper _nn_pairs_list_impl, dispatch
// nn_pallas_matched_pairs), which serves every warm outer iteration of
// batched ICP.
//
// Grid and threads as nn_pairs.cu: one block per (pair, subtile), one
// thread per query.  The block walks exactly the cnt chunks of its
// subtile's survivor list, built in torch (ops/nn_pairs_cuda.
// _survivor_lists: the prune test per 64-query group, unioned per
// subtile, ascending ids).  The list capacity is the pair's chunk count
// rounded up to even, so no list overflows and there is no full-sweep
// branch.  The per-chunk step is nn_pairs.cuh's, shared with nn_pairs.cu.
//
// What bounds it on this card: the operations of the walked (query,
// point) pairs, ~8 each, over the card's float32 rate, against one
// barrier pair per walked chunk; the lists are read once per block.  The
// launch lasts as long as the longest list's block.
#include "nn_pairs.cuh"

namespace {

using icp_nn::kChunk;

template <int D, int F>
__global__ void __launch_bounds__(1024)
nn_pairs_list_kernel(const float* __restrict__ query,
                     const float* __restrict__ dbf_cm,
                     const int* __restrict__ lists,
                     const int* __restrict__ cnt, float* __restrict__ dist,
                     int* __restrict__ idx, float* __restrict__ pay, int qp,
                     int m_pad, int cap) {
  __shared__ float tile[D + F][kChunk];
  const icp_nn::PairTile pt = icp_nn::pair_tile(qp);
  const float* db = dbf_cm + (size_t)pt.pair * (D + F) * m_pad;
  const size_t row = (size_t)pt.pair * pt.n_qt + pt.sub;

  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[pt.q * D + k];
  float best = INFINITY;
  int bi = 0;
  float bp[F];
#pragma unroll
  for (int f = 0; f < F; ++f) bp[f] = 0.0f;

  const int walk = cnt[row];
  for (int w = 0; w < walk; ++w) {
    icp_nn::walk_chunk<D, F>(db, m_pad, lists[row * cap + w], tile, qv, best,
                             bi, bp);
  }
  icp_nn::store_result<D, F>(pt.q, best, bi, bp, dist, idx, pay);
}

template <int D, int F>
int launch(const float* query, const float* dbf_cm, const int* lists,
           const int* cnt, float* dist, int* idx, float* pay, int b, int qp,
           int q_sub, int m_pad, int cap, cudaStream_t stream) {
  nn_pairs_list_kernel<D, F><<<b * (qp / q_sub), q_sub, 0, stream>>>(
      query, dbf_cm, lists, cnt, dist, idx, pay, qp, m_pad, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query (B, qp, d_dim); dbf_cm (B, d_dim + f_dim, m_pad); lists
// (B, qp / q_sub, cap); cnt (B, qp / q_sub); outputs dist/idx (B, qp)
// and pay (B, qp, f_dim).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported (d_dim, f_dim).
extern "C" int nn_pairs_list_launch(const float* query, const float* dbf_cm,
                                    const int* lists, const int* cnt,
                                    float* dist, int* idx, float* pay, int b,
                                    int qp, int q_sub, int d_dim, int f_dim,
                                    int m_pad, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ICP_NN_PAIRS_DISPATCH(launch, query, dbf_cm, lists, cnt, dist, idx, pay, b,
                        qp, q_sub, m_pad, cap, s)
}
