// gn_stats: one robust SE(2) Gauss-Newton update's statistics at a given
// transform, packed into 16 floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:_gn_kernel
// (wrapper gn_stats_pallas; assemble_update unpacks the result).
//
// Design: one thread-block cluster of C blocks of 512 threads
// (irls_cluster.cuh's irls_cluster_run<false>), launched with
// cudaLaunchKernelEx and a cluster dimension; the wrapper takes C from N
// (ops/align2d_cuda.gn_cluster).  It runs one iteration of irls_loop.cu's
// cluster loop without the tail, at the transform read from a (6,) device
// array: the same residual pass, exact medians and MADs (DSMEM-summed
// radix histograms, bitwise the one-block ones), and the 11 sums in
// float64 over the cluster, rounded once.  Each block holds its 1/C slice
// of the points in shared memory (25 bytes a point) or, when the slice
// exceeds 200 KB, reads it in place from global memory; src, dst and the
// bool mask are read in place with their strides.
//
// What bounds it on this card: the serial chain of 12 passes (residuals,
// 4 radix and 1 count/max pass for each of median and MAD, the sums),
// each ending in a barrier, on C SMs instead of one; bytes and operations
// are a loose bound (the data are read once).  The 3x3 solve stays with
// the caller (ops/align2d.weighted_gn_update_cuda), as on the TPU.
//
// Output (16 floats), _gn_kernel's layout: S_u, S_uw, S_uw2, S_ur, S_uwr of
// x, the same five of y, the Huber error, the mask-true count, sigma_x,
// sigma_y, 0, 0.
#include "irls_cluster.cuh"

namespace {

// Shared memory a block may take for its staged slice: above it the
// slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;

__global__ void __launch_bounds__(icp::kClusterThreads)
gn_stats_kernel(const float* __restrict__ src, long long s0, long long s1,
                const float* __restrict__ dst, long long d0, long long d1,
                const unsigned char* __restrict__ mask, long long m0,
                int n_pts, int staged, const float* __restrict__ rt,
                float* scratch, icp::IrlsParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::ClusterShared sh;
  icp::irls_cluster_pair<false>(src, s0, s1, dst, d0, d1, mask, m0, n_pts,
                                staged, scratch, P, stage, sh, out, rt);
}

}  // namespace

// src (n, 2) with element strides s0, s1, dst likewise, mask (n,) bool
// with stride m0; rt: (6,) r00 r01 r10 r11 tx ty; scratch: 2n floats (the
// residuals when the slices are not staged); out: 16 floats.  cluster:
// blocks in the cluster, 1-16.  Returns cudaGetLastError(), the launch
// API's error, or -1 when no cluster of that size can be placed on this
// card.
extern "C" int gn_stats_launch(const float* src, long long s0, long long s1,
                               const float* dst, long long d0, long long d1,
                               const unsigned char* mask, long long m0,
                               int n, const float* rt, float* scratch,
                               float* out, float huber_k, float k2,
                               float two_k, int cluster, void* stream) {
  static bool attributes_set = false;
  static int placed_cluster = 0;
  static size_t placed_smem = 0;
  if (cluster < 1 || cluster > icp::kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBudget);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(gn_stats_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    attributes_set = true;
  }
  const int per = (n + cluster - 1) / cluster;
  size_t smem = ((size_t)per * icp::kStagedPointBytes + 15) / 16 * 16;
  const int staged = smem <= (size_t)kStageBudget ? 1 : 0;
  if (!staged) smem = 0;

  // One pass of the loop's body: max_iter 1.
  icp::IrlsParams P{huber_k, k2, two_k, 0.0f, 0.0f, 1, 1.0f, 0.0f};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(icp::kClusterThreads, 1, 1);
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
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n_clusters, gn_stats_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_smem = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_stats_kernel, src, s0, s1, dst, d0, d1, mask, m0, n, staged,
      rt, scratch, P, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
