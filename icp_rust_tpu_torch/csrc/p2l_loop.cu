// p2l_loop: the whole fixed-correspondence robust SE(3) point-to-plane
// IRLS loop (<= inner_max_iter iterations) from the identity, in one
// launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align3d_pallas.py:
// _p2l_loop_kernel (wrapper estimate_transform_p2l_pallas; core
// _p2l_stats_core, _median_radix2_single, _chol_solve6).
//
// Design (a) of irls_loop.cu: ONE block, streaming the ten (N,) input
// columns from global memory.  At N = 28,800 they are 1.15 MB, beyond one
// SM's 227 KB of shared memory; they and the 115 KB residual scratch stay
// resident in the 50 MB L2.  Per iteration the block makes 12 passes:
// residuals, 4 radix + 1 count/max pass for each of median and MAD, one
// sums pass; then thread 0 solves the 6x6 system and updates the
// transform (csrc/p2l.cuh).  What bounds it on this card: the serial chain
// of block-wide passes and barriers on one SM (L2 bandwidth of one SM and
// latency), not device memory or arithmetic.
//
// 1024 threads, as irls_loop: the sums pass keeps 28 running sums per
// thread besides the point's J, and 1024 threads cap a thread at 64
// registers.  ptxas (CUDA 12.8) fits that with no spill, where a
// 512-thread bound without a minimum block count made it choose 64
// registers all the same and spill 20 bytes.  chip_smoke.py prints
// ptxas' report.
//
// Output (16 floats): r00..r22 (row-major), tx ty tz, iterations, 0 0 0.
#include "p2l.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
p2l_loop_kernel(icp::P2lCols c, int n_pts, float* r, icp::P2lParams P,
                float* out) {
  __shared__ icp::P2lShared sh;
  const int n = icp::p2l_count(c.mask, n_pts, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.rot[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    sh.t[0] = 0.0f;
    sh.t[1] = 0.0f;
    sh.t[2] = 0.0f;
    sh.prev_err = FLT_MAX;
    sh.it = 0;
    sh.done = 0;
  }
  __syncthreads();
  while (sh.it < P.max_iter && sh.done == 0) {
    const float sig = icp::p2l_stats(c, n_pts, r, n, P, sh);
    if (threadIdx.x == 0) icp::p2l_step(sh, n, sig, P);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) out[k] = sh.rot[k];
    for (int k = 0; k < 3; ++k) out[9 + k] = sh.t[k];
    out[12] = (float)sh.it;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 0.0f;
  }
}

}  // namespace

// Columns sx sy sz dx dy dz nx ny nz mask, each (n,) float32; r: (n,)
// scratch; out: (16,).  Returns cudaGetLastError().
extern "C" int p2l_loop_launch(const float* sx, const float* sy,
                               const float* sz, const float* dx,
                               const float* dy, const float* dz,
                               const float* nx, const float* ny,
                               const float* nz, const float* mask, int n,
                               float* r, float* out, float huber_k, float k2,
                               float two_k, float tol_d2, int max_iter,
                               float s2, float small_angle, void* stream) {
  icp::P2lCols c{sx, sy, sz, dx, dy, dz, nx, ny, nz, mask};
  icp::P2lParams P{huber_k, k2, two_k, tol_d2, max_iter, s2, small_angle};
  p2l_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, n, r, P, out);
  return static_cast<int>(cudaGetLastError());
}
