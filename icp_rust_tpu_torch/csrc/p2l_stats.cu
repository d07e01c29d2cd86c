// p2l_stats: one robust point-to-plane Gauss-Newton update's statistics
// at a given transform, packed into 32 floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align3d_pallas.py:_p2l_kernel
// (wrapper p2l_stats_pallas; assemble_p2l unpacks the result).
//
// Design: one thread-block cluster of C blocks of 512 threads
// (p2l_cluster.cuh's p2l_cluster_run<false>), launched with
// cudaLaunchKernelEx and a cluster dimension; the wrapper takes C from N
// (ops/align3d_cuda.p2l_cluster, as p2l_loop).  It runs one iteration of
// p2l_loop.cu's cluster loop without the tail, at the transform read
// from a (12,) device array: the same residual pass, exact median and MAD
// (DSMEM-summed radix histograms, bitwise the one-block ones) and the 28
// sums in float64 over the cluster, rounded once.  Each block holds its
// 1/C slice of the points in shared memory (41 bytes a point) or, when
// the slice exceeds 200 KB, reads it in place from global memory; src,
// dst and normals (N, 3) and the bool or float mask are read in place with
// their strides.  Two kernel instances, staged and in place, as
// p2l_loop.cu's (p2l_cluster.cuh's p2l_cluster_cloud).
//
// What bounds it on this card: the serial chain of 12 passes (residuals,
// 4 radix and 1 count/max pass for each of median and MAD, the sums),
// each ending in a barrier, on C SMs instead of one; bytes and operations
// are a loose bound (the data are read once).  The 6x6 solve stays with
// the caller (ops/align3d.weighted_gn_update_p2l_cuda), as on the TPU.
//
// Output (32 floats), _p2l_kernel's order: the 21 upper-triangle sums of
// u J J^T row-major, the 6 of u J r, the Huber error, the mask-true count,
// sigma, 0, 0.
#include "p2l_cluster.cuh"

namespace {

// Shared memory a block may take for its staged slice: above it the
// slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(icp::kP2lClusterThreads)
p2l_stats_kernel(const float* __restrict__ src, long long s0, long long s1,
                 const float* __restrict__ dst, long long d0, long long d1,
                 const float* __restrict__ nrm, long long n0, long long n1,
                 const void* __restrict__ mask, long long m0, int mask_f32,
                 int n_pts, const float* __restrict__ rt, float* scratch,
                 icp::P2lParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::P2lClusterShared sh;
  icp::p2l_cluster_cloud<kStaged, false>(src, s0, s1, dst, d0, d1, nrm, n0,
                                         n1, mask, m0, mask_f32, n_pts,
                                         scratch, P, stage, sh, out, rt);
}

}  // namespace

// src, dst, normals (n, 3) with element strides (s0, s1), (d0, d1), (n0,
// n1); mask (n,) with stride m0, bool (mask_f32 = 0) or float32 (true
// above 0.5); rt: (12,) rot (row-major) then t; scratch: n floats (the
// residuals when the slices are not staged); out: 32 floats.  cluster:
// blocks in the cluster, 1-16.  Returns cudaGetLastError(), the launch
// API's error, or -1 when no cluster of that size can be placed on this
// card.
extern "C" int p2l_stats_launch(const float* src, long long s0, long long s1,
                                const float* dst, long long d0, long long d1,
                                const float* nrm, long long n0, long long n1,
                                const void* mask, long long m0, int mask_f32,
                                int n, const float* rt, float* scratch,
                                float* out, float huber_k, float k2,
                                float two_k, int cluster, void* stream) {
  static bool attributes_set = false;
  static int placed_cluster = 0;
  static size_t placed_smem = 0;
  if (cluster < 1 || cluster > icp::kP2lMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        p2l_stats_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBudget);
    for (auto fn : {p2l_stats_kernel<true>, p2l_stats_kernel<false>}) {
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    attributes_set = true;
  }
  const int per = (n + cluster - 1) / cluster;
  size_t smem = ((size_t)per * icp::kP2lStagedPointBytes + 15) / 16 * 16;
  const bool staged = smem <= (size_t)kStageBudget;
  if (!staged) smem = 0;
  const auto kernel = staged ? p2l_stats_kernel<true>
                             : p2l_stats_kernel<false>;

  // One pass of the loop's body: max_iter 1.
  icp::P2lParams P{huber_k, k2, two_k, 0.0f, 1, 1.0f, 0.0f};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(icp::kP2lClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster != placed_cluster || smem != placed_smem) {
    int n_clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_smem = smem;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, src, s0, s1, dst, d0, d1, nrm, n0, n1,
                         mask, m0, mask_f32, n, rt, scratch, P, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
