// icp2d_frame_pairs: B whole warm-started 2D ICP calls in one launch, a
// thread-block cluster per pair, each pair running its own outer loop to
// its own bit-exact fixed point.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_pairs_kernel (wrapper icp2d_frame_pallas_pairs), which
// serves batched icp2d with frame_backend="pairs".
//
// Design: frame_cluster.cuh's body, kernel 3's, with a pair axis: grid
// (B * C,), a cluster of C blocks of T threads per pair.  Each block of
// pair p sweeps its ascending slice of p's src rows up to the last valid
// one against p's dst up to its last real point, the (query group, dst
// segment) tasks dealt round its threads, and writes its matches into the
// pair's leader through distributed shared memory; the leader runs
// irls.cuh's loop over those rows with its T threads and the exit, and
// writes T and the exit into its cluster's blocks.  The wrapper picks
// (C, T) from the shapes (align2d_cuda.frame_pairs_shape): at least 3
// IRLS points a leader thread, then the most threads and blocks a pair of
// which the card holds all B clusters at once, so no pair waits for a
// second wave (2 blocks of 256 threads a pair at 209 x 768, 16 of 512 for
// one pair).  The matches are bitwise the same at every (C, T); the IRLS
// sums' order follows T.
//
// What bounds it on this card: the serial chain of the slowest pair, its
// outer iterations each a sweep and an IRLS loop of ~12 block-wide,
// barrier-ended passes on the leader.  At 209 x 768 on an H100 the
// slowest pair's outer iteration is ~14 us of sweep and ~40 us of IRLS
// loop (PERF.md).  64 registers a thread hold 1,024 threads an SM, so
// all 209 pairs resident leave 512 threads a pair; their leaders share
// SMs with other pairs' sweeps, which slows the loop from ~28 us alone.
// While most pairs iterate, the card's issue rate bounds their sweeps
// together.

// Output (B, 8): per pair r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations.
#include "frame_cluster.cuh"

namespace {

bool valid_shape(int b, int n, int m, int cluster) {
  return b >= 1 && n >= 1 && m >= 1 && n <= icp_frame::kMaxPoints
         && m <= icp_frame::kMaxPoints && cluster >= 1 && cluster <= 16;
}

}  // namespace

// Clusters of `cluster` blocks of `threads` (128, 256 or 512) threads the
// card holds at once for pairs of n x m points: 0 when none can be placed,
// a negative CUDA error on failure.
extern "C" int icp2d_frame_pairs_resident(int n, int m, int cluster,
                                          int threads) {
  if (!valid_shape(1, n, m, cluster)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  switch (threads) {
    case 128: return icp_frame::resident<128>(n, m, cluster);
    case 256: return icp_frame::resident<256>(n, m, cluster);
    case 512: return icp_frame::resident<512>(n, m, cluster);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// src (B, n, 2), smask (B, n), dst (B, m, 2) sentinel-masked, t0 (B, 6) as
// r00 r01 r10 r11 tx ty; out (B, 8).  cluster: blocks a pair, 1-16;
// threads: 128, 256 or 512.  Returns cudaGetLastError(), the launch
// API's error, or -1 when no cluster of that shape can be placed on this
// card.
extern "C" int icp2d_frame_pairs_launch(const float* src, const float* smask,
                                        const float* dst, int b, int n, int m,
                                        const float* t0, float* out,
                                        float huber_k, float k2, float two_k,
                                        float det_rel_eps, float tol_d2,
                                        int inner_max_iter, float point_scale,
                                        float small_angle, int outer_iters,
                                        int cluster, int threads,
                                        void* stream) {
  if (!valid_shape(b, n, m, cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128:
      return icp_frame::launch<128>(src, smask, dst, b, n, m, t0, out, P,
                                    outer_iters, cluster, s);
    case 256:
      return icp_frame::launch<256>(src, smask, dst, b, n, m, t0, out, P,
                                    outer_iters, cluster, s);
    case 512:
      return icp_frame::launch<512>(src, smask, dst, b, n, m, t0, out, P,
                                    outer_iters, cluster, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
