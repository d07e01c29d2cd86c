// nn_pruned: exact 1-NN by a zig-zag sweep with exact per-tile pruning,
// optional payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_pruned_kernel
// (wrapper _nn_pruned_2d, dispatch nn_pallas and nn_pallas_matched), which
// serves single-cloud searches over dbs of 3 tiles or more: unseeded
// (nn_pallas, F = 0) or matched without a seed or with a wide payload.  On
// the SLAM path: the mean post-alignment NN distance of run_slam3d at full
// width (28,800 x 28,800 points, 15 db tiles of 2048, query tiles of 512),
// once per consecutive pair and once per verified loop candidate.
//
// The block routine is nn_sweep.cuh's (PRUNED = true): diagonal-first tile
// order, lexicographic (distance, index) carry, the query tile's box
// against each db tile's box, the block's threshold refreshed by a
// block-wide max after each swept tile.
//
// What bounds it on this card: operations on the pairs of the tiles it
// sweeps, 11 per pair in 3D (3 sub, 3 mul, 3 add, 2 compares).  The SLAM
// path hands it unsorted frames, whose tile boxes all overlap, so it
// sweeps nearly every tile; the design spends one block of 128 queries
// per SM slot (228 blocks at full width) and one barrier pair per 128 x
// 128 pairs.
#include "nn_sweep.cuh"

// query (qp, d_dim); dbf_cm (d_dim + f_dim, m_pad); qbox (qp / q_tile, 8);
// bbox (m_pad / db_tile, 8); qb_tile (qp / q_tile,); outputs dist/idx
// (qp,) and pay (qp, f_dim) (unused when f_dim is 0).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// (d_dim, f_dim).
extern "C" int nn_pruned_launch(const float* query, const float* dbf_cm,
                                const float* qbox, const float* bbox,
                                const float* qb_tile, float* dist, int* idx,
                                float* pay, int qp, int q_tile, int db_tile,
                                int d_dim, int f_dim, int m_pad,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_PRUNED_CASE(D, F)                                                 \
  if (d_dim == D && f_dim == F)                                             \
    return icp_sweep::launch<D, F, true>(query, dbf_cm, qbox, bbox, qb_tile, \
                                         dist, idx, pay, 1, qp, m_pad,      \
                                         q_tile, db_tile, s);
  // What the callers pass (ops/nn_sweep_cuda.py PRUNED_INSTANCES).
  NN_PRUNED_CASE(2, 0) NN_PRUNED_CASE(3, 0) NN_PRUNED_CASE(2, 2)
  NN_PRUNED_CASE(3, 2) NN_PRUNED_CASE(3, 3) NN_PRUNED_CASE(3, 4)
#undef NN_PRUNED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
