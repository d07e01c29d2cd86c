// p2l_stats: one robust point-to-plane Gauss-Newton update's statistics
// at a given transform, packed into 32 floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align3d_pallas.py:_p2l_kernel
// (wrapper p2l_stats_pallas; assemble_p2l unpacks the result).
//
// One block runs csrc/p2l.cuh's p2l_stats once: the same passes, sums and
// order as one iteration of p2l_loop.cu, with the transform read from a
// (12,) device array.  What bounds it on this card: as p2l_loop, the
// chain of 12 block-wide passes on one SM; the 6x6 solve stays with the
// caller (ops/align3d.weighted_gn_update_p2l_cuda), as on the TPU.  1024
// threads, as p2l_loop.cu.
//
// Output (32 floats), _p2l_kernel's order: the 21 upper-triangle sums of
// u J J^T row-major, the 6 of u J r, the Huber error, the mask-true count,
// sigma, 0, 0.
#include "p2l.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
p2l_stats_kernel(icp::P2lCols c, int n_pts, const float* rt, float* r,
                 icp::P2lParams P, float* out) {
  __shared__ icp::P2lShared sh;
  const int n = icp::p2l_count(c.mask, n_pts, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) sh.rot[k] = rt[k];
    for (int k = 0; k < 3; ++k) sh.t[k] = rt[9 + k];
  }
  __syncthreads();
  const float sig = icp::p2l_stats(c, n_pts, r, n, P, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < icp::kP2lSums; ++k) out[k] = sh.sums[k];
    out[28] = (float)n;
    out[29] = sig;
    out[30] = 0.0f;
    out[31] = 0.0f;
  }
}

}  // namespace

// Columns sx sy sz dx dy dz nx ny nz mask, each (n,) float32; rt: (12,)
// rot (row-major) then t; r: (n,) scratch; out: (32,).  Returns
// cudaGetLastError().
extern "C" int p2l_stats_launch(const float* sx, const float* sy,
                                const float* sz, const float* dx,
                                const float* dy, const float* dz,
                                const float* nx, const float* ny,
                                const float* nz, const float* mask, int n,
                                const float* rt, float* r, float* out,
                                float huber_k, float k2, float two_k,
                                void* stream) {
  icp::P2lCols c{sx, sy, sz, dx, dy, dz, nx, ny, nz, mask};
  icp::P2lParams P{huber_k, k2, two_k, 0.0f, 0, 1.0f, 0.0f};
  p2l_stats_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, n, rt, r, P, out);
  return static_cast<int>(cudaGetLastError());
}
