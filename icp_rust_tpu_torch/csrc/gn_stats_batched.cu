// gn_stats_batched: one robust SE(2) Gauss-Newton update's statistics for
// each of B pairs at its own transform, packed into (B, 16) floats.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _gn_batched_kernel (wrapper gn_stats_pallas_batched).
//
// Two routes; the wrapper picks one from (B, N)
// (ops/align2d_cuda.gn_batched_route, measured on an H100, PERF.md).
//
// One block a pair (route 0), grid (B,): each thread holds P points (P =
// ceil(N / threads), a compile-time constant) in registers, point
// k * threads + tid as its k-th: src, the residuals and the mask bit,
// read once from src, dst and the bool mask in place with their strides.
// Nothing goes to global memory but the output.  The passes run on those
// registers: the count; each exact median (and then each MAD) by four
// 8-bit radix passes over the order-preserving keys, with shared
// histograms in three rotating buffers (a pass fills one; after its
// barrier every warp picks both digits from it itself, and the buffer of
// the pass before is cleared, so one barrier a pass), then one count/max
// pass for the lower order statistic (even-length average); the sums
// pass.  12 barriers against the 38 of irls.cuh's gn_stats_block, which
// this route ran before from a global residual scratch.  The histograms
// take one plain shared atomic add a point: on an H100 that measured
// faster than irls.cuh's warp-aggregated adds (__match_any_sync) and
// than per-warp histograms summed at the select (PERF.md).  Each point's
// terms, each thread's sums (its points in ascending order), the warp
// shuffles and the warps' order are gn_stats_block's, so at one thread
// count the output is bitwise the earlier kernel's.
//
// A cluster a pair (route C >= 1), grid (C, B), cluster dimension (C, 1,
// 1): blockIdx.y is the pair, whose C blocks run gn_stats.cu's body
// (irls_cluster.cuh's irls_cluster_run<false>, one iteration of the
// cluster loop without its tail) on the pair's points: each block stages
// its 1/C slice in shared memory (in place above 200 KB), histograms and
// float64 partial sums go through DSMEM.
//
// What bounds it on this card: the serial chain of barrier-ended passes
// and the launch; bytes (the columns are read once) and operations are
// far below the card's rates.
//
// Output (B, 16): per pair, gn_stats.cu's layout.
#include "irls_cluster.cuh"

namespace {

// Shared memory a cluster block may take for its staged slice: above it
// the slice stays in global memory.
constexpr int kStageBudget = 200 * 1024;
// Points a thread on the one-block route.
constexpr int kMaxPoints = 8;

struct BlockShared {
  unsigned hist[3][2][256];  // rotating radix histograms [buffer][dim]
  int cnt[icp::kMaxWarps];
  int lo_cnt[2][icp::kMaxWarps][2];  // [median, MAD][warp][dim]
  float lo_max[2][icp::kMaxWarps][2];
  float red[icp::kMaxWarps][icp::kNumSums];
};

// One warp picks the digit of rank `rank` from a 256-bin histogram (the
// first bin whose cumulative count exceeds it), as irls.cuh's select_bin,
// and every lane gets the new rank and prefix.  No owner means no
// candidates (n == 0): nothing moves.
__device__ __forceinline__ void select_digit(const unsigned* hist, int lane,
                                             int shift, int& rank,
                                             unsigned& prefix) {
  unsigned c[8];
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[lane * 8 + j];
    s += c[j];
  }
  unsigned inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(icp::kFull, inc, o);
    if (lane >= o) inc += v;
  }
  const unsigned excl = inc - s;
  const unsigned r = (unsigned)rank;
  const unsigned ball = __ballot_sync(icp::kFull, r >= excl && r < inc);
  if (ball == 0) return;
  // The first of this lane's bins whose cumulative count exceeds r
  // (unrolled, so c stays in registers).
  unsigned cum = excl;
  int j = 0;
  bool below = true;
#pragma unroll
  for (int jj = 0; jj < 7; ++jj) {
    below = below && r >= cum + c[jj];
    if (below) {
      cum += c[jj];
      j = jj + 1;
    }
  }
  const int owner = __ffs(ball) - 1;
  rank = __shfl_sync(icp::kFull, (int)(r - cum), owner);
  prefix |= (unsigned)__shfl_sync(icp::kFull, lane * 8 + j, owner) << shift;
}

// Exact masked medians of v0 and v1 over the block's n valid points, v =
// a[k] or |a[k] - c| (absdev); every thread gets both.  `pass` counts the
// radix passes run so far (buffer pass % 3 is zero on entry); `which`
// picks the count/max buffers.
template <int P>
__device__ __forceinline__ void median_pair(
    const float (&a0)[P], const float (&a1)[P], unsigned valid, bool absdev,
    float c0, float c1, int n, BlockShared& sh, int& pass, int which,
    float& out0, float& out1) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int h = n / 2;
  int rank0 = h, rank1 = h;
  unsigned pre0 = 0u, pre1 = 0u, pmask = 0u;
  for (int p = 0; p < 4; ++p, ++pass) {
    const int shift = 24 - 8 * p;
    unsigned* h0 = sh.hist[pass % 3][0];
    unsigned* h1 = sh.hist[pass % 3][1];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      int bin0 = 256, bin1 = 256;
      if ((valid >> k) & 1u) {
        float v0 = a0[k], v1 = a1[k];
        if (absdev) {
          v0 = fabsf(__fsub_rn(v0, c0));
          v1 = fabsf(__fsub_rn(v1, c1));
        }
        const unsigned k0 = icp::order_key(v0), k1 = icp::order_key(v1);
        if ((k0 & pmask) == pre0) bin0 = (int)((k0 >> shift) & 0xffu);
        if ((k1 & pmask) == pre1) bin1 = (int)((k1 >> shift) & 0xffu);
      }
      if (bin0 < 256) atomicAdd(&h0[bin0], 1u);
      if (bin1 < 256) atomicAdd(&h1[bin1], 1u);
    }
    __syncthreads();
    select_digit(h0, lane, shift, rank0, pre0);
    select_digit(h1, lane, shift, rank1, pre1);
    // Every warp read the previous pass's buffer before this barrier, and
    // the pass after next fills it after the next one.
    unsigned* old = &sh.hist[(pass + 2) % 3][0][0];
    for (int b = tid; b < 512; b += nthreads) old[b] = 0u;
    pmask |= 0xffu << shift;
  }
  // All surviving candidates share the full key: it is the upper order
  // statistic.  The lower one: the max below it if exactly h are below.
  const float vhi0 = icp::key_value(pre0);
  const float vhi1 = icp::key_value(pre1);
  int cl0 = 0, cl1 = 0;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if ((valid >> k) & 1u) {
      float v0 = a0[k], v1 = a1[k];
      if (absdev) {
        v0 = fabsf(__fsub_rn(v0, c0));
        v1 = fabsf(__fsub_rn(v1, c1));
      }
      if (v0 < vhi0) { ++cl0; mx0 = fmaxf(mx0, v0); }
      if (v1 < vhi1) { ++cl1; mx1 = fmaxf(mx1, v1); }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cl0 += __shfl_down_sync(icp::kFull, cl0, o);
    cl1 += __shfl_down_sync(icp::kFull, cl1, o);
    mx0 = fmaxf(mx0, __shfl_down_sync(icp::kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_down_sync(icp::kFull, mx1, o));
  }
  if (lane == 0) {
    sh.lo_cnt[which][warp][0] = cl0;
    sh.lo_cnt[which][warp][1] = cl1;
    sh.lo_max[which][warp][0] = mx0;
    sh.lo_max[which][warp][1] = mx1;
  }
  __syncthreads();
  int c[2] = {0, 0};
  float m[2] = {-INFINITY, -INFINITY};
  for (int w = 0; w < (nthreads >> 5); ++w) {
    c[0] += sh.lo_cnt[which][w][0];
    c[1] += sh.lo_cnt[which][w][1];
    m[0] = fmaxf(m[0], sh.lo_max[which][w][0]);
    m[1] = fmaxf(m[1], sh.lo_max[which][w][1]);
  }
  const float vhi[2] = {vhi0, vhi1};
  float med[2];
  for (int d = 0; d < 2; ++d) {
    const float vlo = (c[d] == h) ? m[d] : vhi[d];
    const float md = (n % 2 == 1) ? vhi[d] : 0.5f * (vlo + vhi[d]);
    med[d] = (n > 0) ? md : 0.0f;
  }
  out0 = med[0];
  out1 = med[1];
}

// src (b, n, 2) with element strides sb, s0, s1, dst likewise, mask (b, n)
// bool with strides mb, m0; rt (b, 6); out (b, 16).
template <int P>
__global__ void __launch_bounds__(P <= 4 ? 1024 : 512)
gn_block_kernel(const float* __restrict__ src, long long sb, long long s0,
                long long s1, const float* __restrict__ dst, long long db,
                long long d0, long long d1,
                const unsigned char* __restrict__ mask, long long mb,
                long long m0, int n_pts, const float* __restrict__ rt,
                icp::IrlsParams Pr, float* __restrict__ out) {
  __shared__ BlockShared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const long long pair = blockIdx.x;
  src += pair * sb;
  dst += pair * db;
  mask += pair * mb;
  const float* p = rt + 6 * pair;
  const float r00 = p[0], r01 = p[1], r10 = p[2], r11 = p[3];
  const float tx = p[4], ty = p[5];

  float sx[P], sy[P], rx[P], ry[P];
  unsigned valid = 0u;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const long long i = (long long)k * nthreads + tid;
    sx[k] = sy[k] = rx[k] = ry[k] = 0.0f;
    if (i < n_pts) {
      sx[k] = src[i * s0];
      sy[k] = src[i * s0 + s1];
      rx[k] = icp::residual(r00, r01, sx[k], sy[k], tx, dst[i * d0]);
      ry[k] = icp::residual(r10, r11, sx[k], sy[k], ty, dst[i * d0 + d1]);
      if (mask[i * m0]) {
        valid |= 1u << k;
        ++cnt;
      }
    }
  }
  for (int b = tid; b < 3 * 512; b += nthreads) (&sh.hist[0][0][0])[b] = 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(icp::kFull, cnt, o);
  if (lane == 0) sh.cnt[warp] = cnt;
  __syncthreads();
  int n = 0;
  for (int w = 0; w < (nthreads >> 5); ++w) n += sh.cnt[w];

  int pass = 0;
  float med_x, med_y, mad_x, mad_y;
  median_pair<P>(rx, ry, valid, false, 0.0f, 0.0f, n, sh, pass, 0, med_x,
                 med_y);
  median_pair<P>(rx, ry, valid, true, med_x, med_y, n, sh, pass, 1, mad_x,
                 mad_y);
  const float sig_x = icp::kMadScale * mad_x;
  const float sig_y = icp::kMadScale * mad_y;
  const float g_x = (sig_x != 0.0f) ? 1.0f / sig_x : 0.0f;
  const float g_y = (sig_y != 0.0f) ? 1.0f / sig_y : 0.0f;

  // The sums pass, gn_stats_block's terms in its order.
  float acc[icp::kNumSums];
#pragma unroll
  for (int k = 0; k < icp::kNumSums; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!((valid >> k) & 1u)) continue;
    const float ax = rx[k], ay = ry[k];
    const float ex = ax * ax, ey = ay * ay;
    const float wgt_x = (ex <= Pr.k2) ? 1.0f : Pr.huber_k / sqrtf(ex);
    const float wgt_y = (ey <= Pr.k2) ? 1.0f : Pr.huber_k / sqrtf(ey);
    const float u_x = wgt_x * g_x;
    const float u_y = wgt_y * g_y;
    const float w_x = -r00 * sy[k] + r01 * sx[k];
    const float w_y = -r10 * sy[k] + r11 * sx[k];
    acc[0] += u_x;
    acc[1] += u_x * w_x;
    acc[2] += u_x * w_x * w_x;
    acc[3] += u_x * ax;
    acc[4] += u_x * w_x * ax;
    acc[5] += u_y;
    acc[6] += u_y * w_y;
    acc[7] += u_y * w_y * w_y;
    acc[8] += u_y * ay;
    acc[9] += u_y * w_y * ay;
    const float e = ex + ey;
    acc[10] += (e <= Pr.k2) ? e : Pr.two_k * sqrtf(e) - Pr.k2;
  }
#pragma unroll
  for (int k = 0; k < icp::kNumSums; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc[k] += __shfl_down_sync(icp::kFull, acc[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < icp::kNumSums; ++k) sh.red[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid == 0) {
    float* o = out + 16 * pair;
    for (int k = 0; k < icp::kNumSums; ++k) {
      float s = 0.0f;
      for (int w = 0; w < (nthreads >> 5); ++w) s += sh.red[w][k];
      o[k] = s;
    }
    o[11] = (float)n;
    o[12] = sig_x;
    o[13] = sig_y;
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
}

// A cluster a pair: blockIdx.y the pair, gn_stats.cu's body on its points.
__global__ void __launch_bounds__(icp::kClusterThreads)
gn_cluster_kernel(const float* __restrict__ src, long long sb, long long s0,
                  long long s1, const float* __restrict__ dst, long long db,
                  long long d0, long long d1,
                  const unsigned char* __restrict__ mask, long long mb,
                  long long m0, int n_pts, int staged,
                  const float* __restrict__ rt, float* scratch,
                  icp::IrlsParams P, float* out) {
  extern __shared__ __align__(16) float stage[];
  __shared__ icp::ClusterShared sh;
  const long long pair = blockIdx.y;
  icp::irls_cluster_pair<false>(
      src + pair * sb, s0, s1, dst + pair * db, d0, d1, mask + pair * mb, m0,
      n_pts, staged, staged ? nullptr : scratch + pair * 2 * n_pts, P, stage,
      sh, out + 16 * pair, rt + 6 * pair);
}

// The cluster route's launch configuration for B pairs of n points:
// dynamic shared memory and whether the slices are staged.
cudaLaunchConfig_t cluster_config(int b, int n, int cluster,
                                  cudaLaunchAttribute* attr, int* staged) {
  const int per = (n + cluster - 1) / cluster;
  size_t smem = ((size_t)per * icp::kStagedPointBytes + 15) / 16 * 16;
  *staged = smem <= (size_t)kStageBudget ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, 1);
  cfg.blockDim = dim3(icp::kClusterThreads, 1, 1);
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
      gn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBudget);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gn_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  }
  done = e == cudaSuccess;
  return e;
}

template <int P>
cudaError_t launch_block(const float* src, long long sb, long long s0,
                         long long s1, const float* dst, long long db,
                         long long d0, long long d1,
                         const unsigned char* mask, long long mb,
                         long long m0, int b, int n, const float* rt,
                         const icp::IrlsParams& Pr, float* out, int threads,
                         cudaStream_t stream) {
  gn_block_kernel<P><<<b, threads, 0, stream>>>(
      src, sb, s0, s1, dst, db, d0, d1, mask, mb, m0, n, rt, Pr, out);
  return cudaGetLastError();
}

}  // namespace

// How many clusters of `cluster` blocks, each pair of n points, this card
// holds at once; a negative CUDA error, or -1 for an unsupported size.
extern "C" int gn_stats_batched_resident(int n, int cluster) {
  if (cluster < 1 || cluster > icp::kMaxCluster || n < 1) return -1;
  const cudaError_t e = set_attributes();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  int staged = 0;
  cudaLaunchConfig_t cfg = cluster_config(1, n, cluster, attr, &staged);
  int n_clusters = 0;
  const cudaError_t q =
      cudaOccupancyMaxActiveClusters(&n_clusters, gn_cluster_kernel, &cfg);
  return q == cudaSuccess ? n_clusters : -static_cast<int>(q);
}

// src (b, n, 2) with element strides sb, s0, s1, dst likewise, mask (b, n)
// bool with strides mb, m0; rt: (b, 6) r00 r01 r10 r11 tx ty; out (b,
// 16).  cluster 0: one block a pair of `threads` threads (a multiple of 32
// in [32, 1024], at most 512 above 4 points a thread, at most 8 points a
// thread); cluster 1-16: blocks in a pair's cluster, scratch 2 b n floats
// where a block's slice exceeds 200 KB (else unused, and may be null).
// Returns cudaGetLastError(), the launch API's error,
// cudaErrorInvalidValue for an unsupported shape or a null scratch that
// the slices need, or -1 when no cluster of that size can be placed on
// this card.
extern "C" int gn_stats_batched_launch(
    const float* src, long long sb, long long s0, long long s1,
    const float* dst, long long db, long long d0, long long d1,
    const unsigned char* mask, long long mb, long long m0, int b, int n,
    const float* rt, float* scratch, float* out, float huber_k, float k2,
    float two_k, int cluster, int threads, void* stream) {
  static int placed_cluster = 0;
  static size_t placed_smem = 0;
  if (b < 1 || n < 1 || cluster < 0 || cluster > icp::kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // One update at the given transform: max_iter 1.
  const icp::IrlsParams P{huber_k, k2, two_k, 0.0f, 0.0f, 1, 1.0f, 0.0f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    if (threads < 32 || threads > 1024 || threads % 32 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int per = (n + threads - 1) / threads;
    if (per > kMaxPoints || (per > 4 && threads > 512)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define GN_BLOCK_CASE(K)                                                   \
  if (per == K)                                                            \
    return static_cast<int>(launch_block<K>(src, sb, s0, s1, dst, db, d0,  \
                                            d1, mask, mb, m0, b, n, rt, P, \
                                            out, threads, s));
    GN_BLOCK_CASE(1) GN_BLOCK_CASE(2) GN_BLOCK_CASE(3) GN_BLOCK_CASE(4)
    GN_BLOCK_CASE(5) GN_BLOCK_CASE(6) GN_BLOCK_CASE(7) GN_BLOCK_CASE(8)
#undef GN_BLOCK_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  int staged = 0;
  cudaLaunchConfig_t cfg = cluster_config(b, n, cluster, attr, &staged);
  if (!staged && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cfg.stream = s;
  if (cluster != placed_cluster || cfg.dynamicSmemBytes != placed_smem) {
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, gn_cluster_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_smem = cfg.dynamicSmemBytes;
  }
  e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel, src, sb, s0, s1, dst, db,
                         d0, d1, mask, mb, m0, n, staged, rt, scratch, P,
                         out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
