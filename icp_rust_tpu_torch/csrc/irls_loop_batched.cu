// irls_loop_batched: the whole fixed-correspondence robust SE(2) IRLS loop
// (<= inner_max_iter iterations) for B pairs in one launch: a
// thread-block cluster per pair, or one block per pair for small pairs.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _inner_loop_batched_kernel (wrapper estimate_transform_pallas_batched),
// which serves the lockstep outer loop of batched ICP.
//
// Cluster route, grid (C, B) with cluster dimension (C, 1, 1): blockIdx.y
// is the pair, and each pair's C blocks run irls_cluster.cuh's loop, the
// body of irls_loop.cu, on the pair's points: block r stages its 1/C
// slice in shared memory (25 bytes a point; read in place above 200 KB a
// block), histograms and float64 partial sums go through DSMEM, and every
// block runs the scalar tail.  One-block route, grid (B,): the pair staged
// in shared memory (28 bytes a point), irls.cuh's one-block loop (float32
// sums), as this kernel ran before the cluster route.  Both read src, dst
// and the bool mask in place with their strides and write the pair's own
// row of the output.  The TPU kernel loops each 64-pair block until all
// its pairs are done, freezing a done pair's carry; here each pair stops
// on its own, which gives the same per-pair result, and the iteration
// count in the output is the pair's own.
//
// The wrapper (ops/align2d_cuda.py batched_cluster) picks the route from
// (B, N): one block a pair up to 4,096 points; else C, the largest of 16,
// 8, 4, 2 that leaves at least 1,024 points a block and keeps all B
// clusters resident at once (irls_loop_batched_resident,
// cudaOccupancyMaxActiveClusters), or 1.  Measured on an H100: at 211
// pairs of 768 points the one-block route takes 0.088 ms and a cluster of
// one block 0.148 (float64 sums and cluster barriers cost more than they
// save on short slices); at 64 pairs of 3,072 one block 0.117, clusters
// of 2 0.131; at 6,144 clusters of 2 are 2 % faster.  The SLAM 2D wide
// call (11 pairs of 28,160 points) runs 11 clusters of 8 blocks in one
// wave: 0.104 ms, against 0.182 for 16 blocks a pair (two waves) and
// 0.148 for 4.
//
// What bounds it on this card: the serial chain of an iteration's 12
// barrier-ended passes and the scalar tail; the pair with the most
// iterations sets the launch's length.  Bytes and operations are far
// below the card's rates.
//
// Output (B, 12): r00 r01 r10 r11 tx ty iterations 0, then (cluster
// route; zeros on the one-block route) the first iteration's median x,
// median y, sigma x, sigma y.
#include "irls_cluster.cuh"

namespace {

// Shared memory a block may take for its staged slice: above it the
// slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;

__global__ void __launch_bounds__(icp::kClusterThreads)
irls_batched_kernel(const float* __restrict__ src, long long sb,
                    long long s0, long long s1,
                    const float* __restrict__ dst, long long db,
                    long long d0, long long d1,
                    const unsigned char* __restrict__ mask, long long mb,
                    long long m0, int n_pts, int staged, float* scratch,
                    icp::IrlsParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::ClusterShared sh;
  const long long pair = blockIdx.y;
  icp::irls_cluster_pair(src + pair * sb, s0, s1, dst + pair * db, d0, d1,
                         mask + pair * mb, m0, n_pts, staged,
                         scratch + pair * 2 * n_pts, P, stage, sh,
                         out + pair * 12);
}

// Pairs of fewer points: one block a pair on irls.cuh's loop (float32
// sums in its block order), the pair staged in shared memory as five
// float columns and two residual columns, 28 bytes a point.
__global__ void __launch_bounds__(1024)
irls_block_kernel(const float* __restrict__ src, long long sb, long long s0,
                  long long s1, const float* __restrict__ dst, long long db,
                  long long d0, long long d1,
                  const unsigned char* __restrict__ mask, long long mb,
                  long long m0, int n, icp::IrlsParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::IrlsShared sh;
  const long long pair = blockIdx.x;
  src += pair * sb;
  dst += pair * db;
  mask += pair * mb;
  float* sx = stage;
  float* sy = sx + n;
  float* dx = sy + n;
  float* dy = dx + n;
  float* m = dy + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long k = i;
    sx[i] = src[k * s0];
    sy[i] = src[k * s0 + s1];
    dx[i] = dst[k * d0];
    dy[i] = dst[k * d0 + d1];
    m[i] = mask[k * m0] ? 1.0f : 0.0f;
  }
  __syncthreads();
  float res[7];
  icp::irls_loop(sx, sy, dx, dy, m, n, m + n, m + 2 * n, P, sh, res);
  if (threadIdx.x == 0) {
    float* o = out + pair * 12;
    for (int k = 0; k < 7; ++k) o[k] = res[k];
    for (int k = 7; k < 12; ++k) o[k] = 0.0f;
  }
}

// cluster 0: the one-block route (threads 64-1024); 1-16: blocks in a
// pair's cluster (threads 64-512).  Threads a multiple of 32.
bool config_ok(int cluster, int threads) {
  const int most = cluster == 0 ? 1024 : icp::kClusterThreads;
  return cluster >= 0 && cluster <= icp::kMaxCluster && threads >= 64
         && threads <= most && threads % 32 == 0;
}

// The launch configuration of B pairs of n points: dynamic shared memory
// and whether the slices are staged.
cudaLaunchConfig_t make_config(int b, int n, int cluster, int threads,
                               cudaLaunchAttribute* attr, int* staged) {
  const int per = (n + cluster - 1) / cluster;
  size_t smem = ((size_t)per * icp::kStagedPointBytes + 15) / 16 * 16;
  *staged = smem <= (size_t)kStageBudget ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = *staged ? smem : 0;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      irls_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBudget);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(irls_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageBudget);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(irls_batched_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  }
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// How many clusters of `cluster` blocks of `threads` threads, each pair
// of n points, this card holds at once; a negative CUDA error, or -1 for
// an unsupported configuration.
extern "C" int irls_loop_batched_resident(int n, int cluster, int threads) {
  if (cluster < 1 || !config_ok(cluster, threads) || n < 1) return -1;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  int staged = 0;
  cudaLaunchConfig_t cfg = make_config(1, n, cluster, threads, attr, &staged);
  int n_clusters = 0;
  const cudaError_t q =
      cudaOccupancyMaxActiveClusters(&n_clusters, irls_batched_kernel, &cfg);
  return q == cudaSuccess ? n_clusters : -static_cast<int>(q);
}

// src (b, n, 2) with element strides sb, s0, s1, dst likewise, mask (b, n)
// bool with strides mb, m0; scratch: 2 b n floats (the residuals when the
// slices are not staged); out (b, 12).  cluster: blocks a pair, 1-16, or
// 0 for the one-block route (n * 28 bytes at most 200 KB); threads: a
// block's, a multiple of 32 in [64, 512] ([64, 1024] for the one-block
// route).  Returns cudaGetLastError(), the launch API's error, or -1 when
// no cluster of that size can be placed on this card.
extern "C" int irls_loop_batched_launch(
    const float* src, long long sb, long long s0, long long s1,
    const float* dst, long long db, long long d0, long long d1,
    const unsigned char* mask, long long mb, long long m0, int b, int n,
    float* scratch, float* out, float huber_k, float k2, float two_k,
    float det_rel_eps, float tol_d2, int max_iter, float point_scale,
    float small_angle, int cluster, int threads, void* stream) {
  static int placed_cluster = 0, placed_threads = 0;
  static size_t placed_smem = 0;
  if (!config_ok(cluster, threads) || b < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, max_iter,
                    point_scale, small_angle};
  if (cluster == 0) {
    const size_t smem = (size_t)n * 7 * sizeof(float);
    if (smem > (size_t)kStageBudget) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    irls_block_kernel<<<b, threads, smem, static_cast<cudaStream_t>(
                                                stream)>>>(
        src, sb, s0, s1, dst, db, d0, d1, mask, mb, m0, n, P, out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  int staged = 0;
  cudaLaunchConfig_t cfg = make_config(b, n, cluster, threads, attr, &staged);
  cfg.stream = static_cast<cudaStream_t>(stream);
  if (cluster != placed_cluster || threads != placed_threads
      || cfg.dynamicSmemBytes != placed_smem) {
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, irls_batched_kernel,
                                       &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_threads = threads;
    placed_smem = cfg.dynamicSmemBytes;
  }
  e = cudaLaunchKernelEx(&cfg, irls_batched_kernel, src, sb, s0, s1, dst, db,
                         d0, d1, mask, mb, m0, n, staged, scratch, P, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
