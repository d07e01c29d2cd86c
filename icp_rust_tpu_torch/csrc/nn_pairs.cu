// nn_pairs: pair-grid exact 1-NN with matched payload and seed-only chunk
// pruning, the sweep split into work items over blocks.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_pairs_kernel
// (wrapper _nn_pairs_impl, dispatch nn_pallas_matched_pairs), which serves
// the cold outer iteration of batched ICP.
//
// The block body is nn_items.cuh's (kernels 4 and 5) with kPrune: grid
// (query groups, work items, pairs), Q queries a thread, each work item a
// contiguous ascending range of `item` 128-point chunks of its pair's
// coordinate-major db, staged by cp.async, double buffered, one barrier a
// chunk, 16-byte broadcast loads of four points per coordinate row; the
// items merged lexicographically on (distance, index) by the group's last
// block (a ticket per (pair, group)), which reads the winner's payload
// from the packed db.  Before staging a chunk, the block evaluates the
// prune test lb <= bound of each of its query slots' subtiles (q_sub
// queries, as on the TPU: lb the squared distance between the subtile's
// query box and the chunk's box, dims summed in order, deflated by
// 1 - 16 eps; bound the subtile's upper bound on its queries' NN
// distance²).  The tests are block-uniform, so the barriers stay uniform;
// a chunk no slot walks is neither staged nor swept.  On the cold
// iteration every bound is +inf and every chunk is walked; padded
// subtiles carry -inf and walk nothing.  With no valid point the result is
// (+inf, 0, 0).  The squared distance is (dx*dx + dy*dy) + dz*dz with
// every rounding explicit (--fmad=false), the plain version's operations
// in ops/nn_pairs_cuda.py, so the two agree bitwise.
//
// What bounds it on this card: instruction issue, 8 instructions a
// (query, db point) pair in 2D (nn_items.cuh); at 209 pairs x 768 queries
// x 768 points, 123M pairs, 29.5 us at the card's float32 issue rate.
// The wrapper's schedule (ops/nn_pairs_cuda.pairs_item_chunks,
// PAIRS_Q) was measured on an H100 (PERF.md).
#include "nn_items.cuh"

// query (b, qp, d_dim), qp a multiple of q_sub; dbf_cm (b, d_dim + f_dim,
// m_pad), m_pad a multiple of 128, 16-byte aligned; qbox (b, qp / q_sub,
// 8); cbox (b, m_pad / 128, 8); qbound (b, qp / q_sub); outputs dist/idx
// (b, qp) and pay (b, qp, f_dim), f_dim 2, 3 or 4 (4: the point-to-plane
// payload [n, c = n . q], whose sentinel c on invalid rows is copied as
// it is).  q_sub a multiple of 128; blocks of 128
// threads with q_per_thread queries each (1, 2 or 4); work items of
// `item` chunks.  part: scratch of b * ceil(qp / G) * n_items * 2 * G
// floats, G = 128 * q_per_thread, n_items = ceil(m_pad / 128 / item)
// (unused when n_items is 1); ticket: b * ceil(qp / G) ints, zero on entry
// and left zero.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an unsupported (d_dim, f_dim) or schedule.
extern "C" int nn_pairs_launch(const float* query, const float* dbf_cm,
                               const float* qbox, const float* cbox,
                               const float* qbound, float* dist, int* idx,
                               float* pay, float* part, int* ticket, int b,
                               int qp, int q_sub, int d_dim, int f_dim,
                               int m_pad, int item, int q_per_thread,
                               void* stream) {
  using icp_items::kChunk;
  using icp_items::kThreads;
  if (f_dim < 2 || f_dim > 4 || item < 1 || m_pad % kChunk != 0
      || b < 1 || qp < 1 || q_sub < kThreads || q_sub % kThreads != 0
      || qp % q_sub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const icp_items::Prune pr{qbox, cbox, qbound, q_sub};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_PAIRS_CASE(D, Q)                                                 \
  if (d_dim == D && q_per_thread == Q)                                      \
    return static_cast<int>(icp_items::launch<D, Q, true, true>(            \
        query, dbf_cm, dist, idx, pay, part, ticket, b, qp, f_dim, m_pad,   \
        item, s, pr));
  NN_PAIRS_CASE(2, 1) NN_PAIRS_CASE(2, 2) NN_PAIRS_CASE(2, 4)
  NN_PAIRS_CASE(3, 1) NN_PAIRS_CASE(3, 2) NN_PAIRS_CASE(3, 4)
#undef NN_PAIRS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
