// nn_matched: exact 1-NN by a plain ascending sweep, carrying the winner's
// payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_matched_kernel
// (wrapper _nn_matched_2d, dispatch nn_pallas_matched), which serves
// matched searches over dbs of fewer than 3 tiles and every batched call
// off the pair-grid route (vmapped there, one grid axis here).  On the
// SLAM path: the point-to-plane ICP of run_slam3d on frames of at most
// 4096 points (D = 3, payload [n, c]: 4 rows) and the batched icp2d of
// run_slam2d on scans of more than 4096 points (D = 2, xy payload).
//
// The block routine is nn_sweep.cuh's (PRUNED = false): one thread per
// query, the db and payload rows staged 128 points at a time, a strict
// '<', the payload selected with the winner.
//
// What bounds it on this card: operations, as nn_sweep (8 per pair in 2D,
// 11 in 3D); the payload rows add bytes staged, not operations per pair.
#include "nn_sweep.cuh"

// query (B, qp, d_dim); dbf_cm (B, d_dim + f_dim, m_pad); outputs
// dist/idx (B, qp) and pay (B, qp, f_dim).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unsupported (d_dim, f_dim).
extern "C" int nn_matched_launch(const float* query, const float* dbf_cm,
                                 float* dist, int* idx, float* pay, int b,
                                 int qp, int d_dim, int f_dim, int m_pad,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_MATCHED_CASE(D, F)                                                \
  if (d_dim == D && f_dim == F)                                             \
    return icp_sweep::launch<D, F, false>(query, dbf_cm, nullptr, nullptr,  \
                                          nullptr, dist, idx, pay, b, qp,   \
                                          m_pad, 0, 0, s);
  // What the callers pass (ops/nn_sweep_cuda.py MATCHED_INSTANCES).
  NN_MATCHED_CASE(2, 2) NN_MATCHED_CASE(3, 2) NN_MATCHED_CASE(3, 3)
  NN_MATCHED_CASE(3, 4)
#undef NN_MATCHED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
