// icp2d_frame: one whole warm-started 2D ICP call (Icp2d::estimate,
// reference src/lib.rs:105-130) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_kernel (wrapper icp2d_frame_pallas, core _icp_outer_loop).
//
// Design: frame_cluster.cuh's body on one thread-block cluster of C blocks
// of 1024 threads (C from N alone, frame_cluster: 16 from 512 points).
// Each block sweeps its ascending slice of src against the whole dst and
// writes its matches into the leader through distributed shared memory;
// the leader runs irls.cuh's loop with its 1024 threads and the bit-exact
// fixed-point exit, and writes T and the exit into every block.  The
// result is bitwise the same at every C.
//
// What bounds it on this card: the serial chain of the IRLS loop's
// block-wide passes and barriers on the leader's SM (28 us of an outer
// iteration's 33 at 768 x 768 on an H100, PERF.md).  The O(N*M) sweep,
// ~590k distance evaluations an outer iteration at 768 x 768, is issue
// bound and spread over C SMs; each cluster barrier costs about 1 us.
#include "frame_cluster.cuh"

namespace {

constexpr int kThreads = 1024;

// Blocks in the cluster for n points: the most, up to 16, that leave at
// least 32 query rows a block, measured best or within 1 % of it at
// every size timed from 128 to 1,536 points on an H100 (PERF.md).
int frame_cluster(int n) {
  int c = 16;
  while (c > 1 && n < 32 * c) c /= 2;
  return c;
}

}  // namespace

extern "C" int icp2d_frame_cluster(int n) { return frame_cluster(n); }

// src (n, 2), smask (n,), dst (m, 2) sentinel-masked, t0 6 floats as r00
// r01 r10 r11 tx ty; out 8 floats.  cluster: blocks in the cluster, 1-16.
// Returns cudaGetLastError(), the launch API's error, or -1 when no
// cluster of that size can be placed on this card.
extern "C" int icp2d_frame_launch_cluster(
    const float* src, const float* smask, const float* dst, int n, int m,
    const float* t0, float* out, float huber_k, float k2, float two_k,
    float det_rel_eps, float tol_d2, int inner_max_iter, float point_scale,
    float small_angle, int outer_iters, int cluster, void* stream) {
  if (cluster < 1 || cluster > 16 || n < 1 || m < 1
      || n > icp_frame::kMaxPoints || m > icp_frame::kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  return icp_frame::launch<kThreads>(src, smask, dst, 1, n, m, t0, out, P,
                                     outer_iters, cluster,
                                     static_cast<cudaStream_t>(stream));
}

// The same launch on frame_cluster(n) blocks.
extern "C" int icp2d_frame_launch(const float* src, const float* smask,
                                  const float* dst, int n, int m,
                                  const float* t0, float* out, float huber_k,
                                  float k2, float two_k, float det_rel_eps,
                                  float tol_d2, int inner_max_iter,
                                  float point_scale, float small_angle,
                                  int outer_iters, void* stream) {
  return icp2d_frame_launch_cluster(src, smask, dst, n, m, t0, out, huber_k,
                                    k2, two_k, det_rel_eps, tol_d2,
                                    inner_max_iter, point_scale, small_angle,
                                    outer_iters, frame_cluster(n), stream);
}
