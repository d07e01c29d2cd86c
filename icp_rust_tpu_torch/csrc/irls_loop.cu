// irls_loop: the whole fixed-correspondence robust SE(2) IRLS loop
// (<= inner_max_iter iterations) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _inner_loop_kernel (wrapper estimate_transform_pallas, core _irls_loop).
//
// Design: one thread-block cluster of C blocks of 512 threads
// (irls_cluster.cuh), launched with cudaLaunchKernelEx and a cluster
// dimension.  Each block holds its 1/C slice of the points in shared
// memory (25 bytes a point: 45 KB at N = 28,800 and C = 16) or, when the
// slice exceeds 200 KB, reads it in place from global memory; src, dst
// and the bool mask are read in place with their strides.
//
// What bounds it on this card: the serial chain of an iteration's 12
// passes (residuals, 4 radix and 1 count/max pass for each of median and
// MAD, the sums), each ending in a barrier, and the scalar tail.  Bytes
// and operations are a loose bound (the data are read once).  Spread
// over C SMs, a pass reads 1/C of the points from each block's own
// shared memory instead of all of them from L2 through one SM, and ends
// in a cluster barrier and a DSMEM exchange of at most 2 x 256 counts.
//
// Output (12 floats): r00 r01 r10 r11 tx ty iterations 0, then the first
// iteration's median x, median y, sigma x, sigma y (0 when max_iter < 1).
#include "irls_cluster.cuh"

namespace {

// Shared memory a block may take for its staged slice: above it the
// slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;

__global__ void __launch_bounds__(icp::kClusterThreads)
irls_cluster_kernel(const float* __restrict__ src, long long s0,
                    long long s1, const float* __restrict__ dst,
                    long long d0, long long d1,
                    const unsigned char* __restrict__ mask, long long m0,
                    int n_pts, int staged, float* scratch, icp::IrlsParams P,
                    float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::ClusterShared sh;
  icp::irls_cluster_pair(src, s0, s1, dst, d0, d1, mask, m0, n_pts, staged,
                         scratch, P, stage, sh, out);
}

}  // namespace

// src (n, 2) with element strides s0, s1, dst likewise, mask (n,) bool
// with stride m0; scratch: 2n floats (the residuals when the slices are
// not staged); out: 12 floats.  cluster: blocks in the cluster, 1-16.
// Returns cudaGetLastError(), the launch API's error, or -1 when no
// cluster of that size can be placed on this card.
extern "C" int irls_loop_launch(const float* src, long long s0, long long s1,
                                const float* dst, long long d0, long long d1,
                                const unsigned char* mask, long long m0,
                                int n, float* scratch, float* out,
                                float huber_k, float k2, float two_k,
                                float det_rel_eps, float tol_d2, int max_iter,
                                float point_scale, float small_angle,
                                int cluster, void* stream) {
  static bool attributes_set = false;
  static int placed_cluster = 0;
  static size_t placed_smem = 0;
  if (cluster < 1 || cluster > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        irls_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBudget);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(irls_cluster_kernel,
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

  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, max_iter,
                    point_scale, small_angle};
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
        &n_clusters, irls_cluster_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_smem = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, irls_cluster_kernel, src, s0, s1, dst, d0, d1, mask, m0, n,
      staged, scratch, P, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
