// p2l_loop: the whole fixed-correspondence robust SE(3) point-to-plane
// IRLS loop (<= inner_max_iter iterations) from the identity, in one
// launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align3d_pallas.py:
// _p2l_loop_kernel (wrapper estimate_transform_p2l_pallas; core
// _p2l_stats_core, _median_radix2_single, _chol_solve6).
//
// Design: one thread-block cluster of C blocks of 512 threads
// (p2l_cluster.cuh), launched with cudaLaunchKernelEx and a cluster
// dimension; the wrapper takes C = 16 above 16,384 points, else 8
// (ops/align3d_cuda.p2l_cluster).  Each block holds its 1/C slice of the
// points in shared memory (41 bytes a point: 74 KB at N = 28,800 and C =
// 16) or, when the slice exceeds 200 KB, reads it in place from global
// memory; src, dst and normals (N, 3) and the bool or float mask are read
// in place with their strides.
//
// What bounds it on this card: the serial chain of an iteration's 12
// passes (residuals, 4 radix and 1 count/max pass for each of median and
// MAD, the sums), each ending in a barrier, and the 6x6 tail.  Bytes and
// operations are a loose bound (the data are read once).  Spread over C
// SMs, a pass reads 1/C of the points from each block's own shared
// memory instead of all of them from L2 through one SM, and ends in a
// cluster barrier and a DSMEM exchange of at most 256 counts or 28 sums.
//
// Output (16 floats): r00..r22 (row-major), tx ty tz, iterations, then
// the first iteration's median, MAD and sigma (0 when max_iter < 1).
#include "p2l_cluster.cuh"

namespace {

// Shared memory a block may take for its staged slice: above it the
// slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;

// Two instances, so that the staged one, the card's usual, keeps its few
// slice registers and ptxas reports each: kStaged holds the block's slice
// in shared memory, else it reads the points in place.
template <bool kStaged>
__global__ void __launch_bounds__(icp::kP2lClusterThreads)
p2l_cluster_kernel(const float* __restrict__ src, long long s0, long long s1,
                   const float* __restrict__ dst, long long d0, long long d1,
                   const float* __restrict__ nrm, long long n0, long long n1,
                   const void* __restrict__ mask, long long m0, int mask_f32,
                   int n_pts, float* scratch, icp::P2lParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::P2lClusterShared sh;
  icp::p2l_cluster_cloud<kStaged, true>(src, s0, s1, dst, d0, d1, nrm, n0,
                                        n1, mask, m0, mask_f32, n_pts,
                                        scratch, P, stage, sh, out, nullptr);
}

}  // namespace

// src, dst, normals (n, 3) with element strides (s0, s1), (d0, d1), (n0,
// n1); mask (n,) with stride m0, bool (mask_f32 = 0) or float32 (true
// above 0.5); scratch: n floats (the residuals when the slices are not
// staged); out: 16 floats.  cluster: blocks in the cluster, 1-16.
// Returns cudaGetLastError(), the launch API's error, or -1 when no
// cluster of that size can be placed on this card.
extern "C" int p2l_loop_launch(const float* src, long long s0, long long s1,
                               const float* dst, long long d0, long long d1,
                               const float* nrm, long long n0, long long n1,
                               const void* mask, long long m0, int mask_f32,
                               int n, float* scratch, float* out,
                               float huber_k, float k2, float two_k,
                               float tol_d2, int max_iter, float s2,
                               float small_angle, int cluster,
                               void* stream) {
  static bool attributes_set = false;
  static int placed_cluster = 0;
  static size_t placed_smem = 0;
  if (cluster < 1 || cluster > icp::kP2lMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        p2l_cluster_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBudget);
    for (auto fn : {p2l_cluster_kernel<true>, p2l_cluster_kernel<false>}) {
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
  const auto kernel =
      staged ? p2l_cluster_kernel<true> : p2l_cluster_kernel<false>;

  icp::P2lParams P{huber_k, k2, two_k, tol_d2, max_iter, s2, small_angle};
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
                         mask, m0, mask_f32, n, scratch, P, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
