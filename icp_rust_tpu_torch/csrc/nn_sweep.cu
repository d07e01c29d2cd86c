// nn_sweep: exact 1-NN by a plain ascending sweep, no payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_kernel
// (wrapper _nn_pallas_2d, dispatch nn_pallas), which serves nn_pallas on
// dbs of fewer than 3 tiles and on every batched call (vmapped there, one
// grid axis here).  On the SLAM path: the mean post-alignment NN distance
// of run_slam3d on frames of at most 4096 points, and of run_slam2d's
// batched pairs on scans of more than 4096.
//
// The block routine is nn_sweep.cuh's: one thread per query, the db
// staged 128 points at a time, a strict '<'.
//
// What bounds it on this card: operations.  Every (query, db point) pair
// costs 3D - 1 float operations and a compare (8 in 2D, 11 in 3D), and the
// db is re-read from L2 by every block; the design keeps one barrier pair
// per 128 x 128 pairs and fills the card with one block per 128 queries.
#include "nn_sweep.cuh"

// query (B, qp, d_dim); db_cm (B, d_dim, m_pad); outputs dist/idx (B, qp).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// d_dim.
extern "C" int nn_sweep_launch(const float* query, const float* db_cm,
                               float* dist, int* idx, int b, int qp,
                               int d_dim, int m_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_dim == 2)
    return icp_sweep::launch<2>(query, db_cm, dist, idx, b, qp, m_pad, s);
  if (d_dim == 3)
    return icp_sweep::launch<3>(query, db_cm, dist, idx, b, qp, m_pad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
