// nn_sweep: exact 1-NN by an ascending sweep split over blocks, no
// payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_kernel
// (wrapper _nn_pallas_2d, dispatch nn_pallas), which serves nn_pallas on
// dbs of fewer than 3 tiles and on every batched call (vmapped there, one
// grid axis here).  On the SLAM path: the mean post-alignment NN distance
// of run_slam3d on frames of at most 4096 points, and of run_slam2d's
// batched pairs on scans of more than 4096.
//
// The block body is nn_items.cuh's, kernel 4's (nn_matched.cu) without
// its payload: work items of 128-point db chunks over blocks, Q queries a
// thread, 16-byte broadcast loads of four db points per coordinate row,
// cp.async double buffering, a strict '<' within an item and the items
// merged lexicographically on (distance, index) by the group's last
// block.
//
// What bounds it on this card: instruction issue, 8 instructions a (query,
// db point) pair in 2D and 11 in 3D (nn_items.cuh).  The wrapper takes
// kernel 4's schedule (nn_sweep_cuda.matched_item_chunks, MATCHED_Q),
// measured on an H100 for this kernel too (PERF.md).
#include "nn_items.cuh"

// query (b, qp, d_dim); db_cm (b, d_dim, m_pad), m_pad a multiple of 128,
// 16-byte aligned; outputs dist/idx (b, qp).  Blocks, work items, part and
// ticket as nn_matched_launch's.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported d_dim or schedule.
extern "C" int nn_sweep_launch(const float* query, const float* db_cm,
                               float* dist, int* idx, float* part,
                               int* ticket, int b, int qp, int d_dim,
                               int m_pad, int item, int q_per_thread,
                               void* stream) {
  return icp_items::dispatch<false>(query, db_cm, dist, idx, nullptr, part,
                                    ticket, b, qp, d_dim, 0, m_pad, item,
                                    q_per_thread,
                                    static_cast<cudaStream_t>(stream));
}
