// nn_matched: exact 1-NN by an ascending sweep split over blocks, the
// winner's payload read after the merge.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_matched_kernel
// (wrapper _nn_matched_2d, dispatch nn_pallas_matched), which serves
// matched searches over dbs of fewer than 3 tiles and every batched call
// off the pair-grid route (vmapped there, one grid axis here).  On the
// paths: the point-to-plane ICP of run_slam3d on frames of at most 4096
// points (D = 3, payload [n, c]: 4 rows), the batched icp2d of run_slam2d
// on scans of more than 4096 points (D = 2, xy payload) and the 2D
// scan-to-submap ICP against its map view (D = 2, xy payload).
//
// The block body is nn_items.cuh's (with nn_sweep.cu, kernel 5, which
// runs it without a payload): work items of 128-point db chunks over
// blocks, Q queries a thread, items merged lexicographically by the
// group's last block, which reads the winner's payload from the packed db.
//
// What bounds it on this card: instruction issue, 8 instructions a (query,
// db point) pair in 2D and 11 in 3D (nn_items.cuh).  The wrapper's
// schedule, 2 queries a thread and work items for at least 8,192 blocks,
// measured best or within 1.3 % of it on an H100 at every path's shape
// (PERF.md).
#include "nn_items.cuh"

// query (b, qp, d_dim); dbf_cm (b, d_dim + f_dim, m_pad), m_pad a multiple
// of 128, 16-byte aligned; outputs dist/idx (b, qp), pay (b, qp, f_dim).
// Blocks of 128 threads with q_per_thread queries each (2, 4 or 8); work
// items of `item` chunks of 128 db points.  part: scratch of
// b * ceil(qp / G) * n_items * 2 * G floats, G = 128 * q_per_thread,
// n_items = ceil(m_pad / 128 / item) (unused when n_items is 1); ticket:
// b * ceil(qp / G) ints, zero on entry and left zero.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// (d_dim, f_dim) or schedule.
extern "C" int nn_matched_launch(const float* query, const float* dbf_cm,
                                 float* dist, int* idx, float* pay,
                                 float* part, int* ticket, int b, int qp,
                                 int d_dim, int f_dim, int m_pad, int item,
                                 int q_per_thread, void* stream) {
  // What the callers pass (ops/nn_sweep_cuda.py MATCHED_INSTANCES).
  const bool served = (d_dim == 2 && f_dim == 2)
                      || (d_dim == 3 && f_dim >= 2 && f_dim <= 4);
  if (!served) return static_cast<int>(cudaErrorInvalidValue);
  return icp_items::dispatch<true>(query, dbf_cm, dist, idx, pay, part,
                                   ticket, b, qp, d_dim, f_dim, m_pad, item,
                                   q_per_thread,
                                   static_cast<cudaStream_t>(stream));
}
