// One whole warm-started 2D ICP call (Icp2d::estimate, reference
// src/lib.rs:105-130) on one thread-block cluster: the body of
// icp2d_frame.cu (one call, kernel 3) and icp2d_frame_pairs.cu (one
// cluster per pair of a batch, kernel 10), so both run one op sequence, as
// the TPU kernels shared align2d_pallas._icp_outer_loop.
//
// Grid (B * C,): clusters of C blocks of T threads (T in 128..1024,
// launched with cudaLaunchKernelEx and a cluster dimension), cluster p on
// pair p.  Every block holds the pair's whole sentinel-filled dst in
// shared memory as two coordinate rows, and src.  Set-up: every block
// finds n_eff, the rows up to the last valid src point, and m_eff, the
// rows up to the last dst point that is not the sentinel.  Trailing
// masked src rows take no part in the sweep (their matches stay zero, and
// no pass of the IRLS loop reads a masked point's), and trailing sentinel
// dst rows never win (their squared distance overflows to +inf and the
// carry is strict), so sweeping [0, n_eff) x [0, m_eff) gives every valid
// point the match of the full sweep, and the IRLS loop over [0, n_eff)
// the result of the loop over all N.  Outer loop (<= outer_iters):
//   1. block r transforms its contiguous, ascending slice of the n_eff src
//      rows and sweeps them against dst: kQ queries a thread, one 16-byte
//      broadcast load of four dst points per coordinate row, and dst cut
//      into ascending segments (sweep_segments: the count that keeps the
//      threads busiest), (query group, segment) tasks dealt round the
//      threads, the segments' partials merged lexicographically on
//      (distance, index) in shared memory.  Within a
//      segment a strict '<' in ascending index order, so the lowest index
//      wins ties, and each distance is ex*ex + ey*ey with every rounding
//      explicit (--fmad=false): the matches are bitwise those of one
//      thread sweeping all of dst (align2d_cuda.frame_sweep emulates the
//      schedule);
//   2. each block writes its slice's matched points into the leader's
//      (block 0's) shared memory (distributed shared memory); a cluster
//      barrier;
//   3. the leader runs irls.cuh's IRLS loop over the n_eff rows with its
//      T threads (the rows past them are masked and add nothing to any
//      sum, histogram or count; the sums' order follows T, not C), then
//      the scalar tail:
//      left-compose, and the exit when dT is bitwise the identity (the
//      fixed point is exact), decided once, by the leader;
//   4. the leader writes T and the exit into every block's shared memory;
//      a cluster barrier.  No block reads another's shared memory after
//      it, so every block may leave once the loop ends.
//
// Output (8 floats a pair): r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations (summed over the outer loop).
#pragma once

#include <cooperative_groups.h>

#include "irls.cuh"

// Internal linkage (an unnamed namespace): each library that includes this
// header keeps its own kernels and its own set-once launch state; a static
// local of a template with external linkage would be one object across
// every library loaded in the process.
namespace icp_frame {
namespace {

namespace cg = cooperative_groups;

// Queries a thread in the sweep.
constexpr int kQ = 2;
// Room for the sweep's per-segment partials, (distance, index) pairs a
// thread: 6 below 1,024 threads, where a block's slice can outnumber its
// threads; 2 at 1,024 (icp2d_frame's slices of at most 96 rows), where
// the larger room measured 1.5-2 % slower on an H100 (PERF.md).
__host__ __device__ constexpr int partials(int threads) {
  return threads >= 1024 ? 2 : 6;
}
// The coordinate of dst's padding rows up to a multiple of 4: as the
// wrapper's sentinel (ops/nn_cuda.py _SENTINEL), its squared distance
// overflows to +inf and never wins.
constexpr float kSentinel = 3e19f;
// The largest pair (ops/align2d_cuda.py FRAME_MAX_POINTS).
constexpr int kMaxPoints = 1536;

struct FrameShared {
  icp::IrlsShared sh;
  float T[6];
  int it;
  int done;
  int inner;
  int n_eff;
  int m_eff;
  // The block's sweep, kept here rather than in registers across the
  // leader's IRLS loop.
  int row0, s_n, ng, nseg, seg_len, m4_eff;
};

__host__ __device__ inline int round4(int m) { return (m + 3) & ~3; }

// Dynamic shared memory of every block: dst's two coordinate rows, src's
// 9 per-point rows (sx sy mask stx sty mdx mdy rx ry) and the sweep's
// per-segment partials (nseg * s_n <= threads * partials(threads)
// distances and indices).
__host__ __device__ inline int smem_bytes(int n, int m, int threads) {
  return (2 * round4(m) + 9 * n + 2 * threads * partials(threads))
         * static_cast<int>(sizeof(float));
}

// The sweep's dst segments for ng groups of kQ queries (s_n rows) against
// m4 dst rows on T threads: thread tid takes (group, segment) tasks tid,
// tid + T, ... of ng * nseg; the count whose rounds of tasks times segment
// length is least, at most the partials' room over s_n and
// m4 / 4 (segments of at least 4 points), the fewest among equals.
__host__ __device__ inline int sweep_segments(int ng, int s_n, int m4,
                                              int threads) {
  int best = 1;
  long long best_cost = -1;
  const int most = s_n > 0 ? partials(threads) * threads / s_n : 1;
  for (int ns = 1; ns <= most && (ns == 1 || 4 * ns <= m4); ++ns) {
    const long long len = round4((m4 + ns - 1) / ns);
    const long long cost = (((long long)ng * ns + threads - 1) / threads)
                           * len;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = ns;
    }
  }
  return best;
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// src (B, n, 2) and dst (B, m, 2) interleaved, smask (B, n), t0 (B, 6),
// out (B, 8).
template <int T>
__global__ void __launch_bounds__(T, 1024 / T)
frame_kernel(const float* __restrict__ src, const float* __restrict__ smask,
             const float* __restrict__ dst, int n, int m,
             const float* __restrict__ t0, icp::IrlsParams P,
             int outer_iters, float* out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ FrameShared fs;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const size_t pair = blockIdx.x / n_blocks;
  const int tid = threadIdx.x;
  const int m4 = round4(m);
  src += pair * 2 * n;
  smask += pair * n;
  dst += pair * 2 * m;
  float* ddx = smem;
  float* ddy = ddx + m4;
  float* sx = ddy + m4;
  float* sy = sx + n;
  float* mk = sy + n;
  float* stx = mk + n;
  float* sty = stx + n;
  float* mdx = sty + n;
  float* mdy = mdx + n;
  float* rx = mdy + n;
  float* ry = rx + n;
  float* part_d = ry + n;
  int* part_i = reinterpret_cast<int*>(part_d + T * partials(T));
  float* Tm = fs.T;

  if (tid == 0) {
    fs.n_eff = 0;
    fs.m_eff = 0;
  }
  int ne = 0, me = 0;
  for (int i = tid; i < n; i += T) {
    sx[i] = src[2 * i];
    sy[i] = src[2 * i + 1];
    mk[i] = smask[i];
    mdx[i] = 0.0f;
    mdy[i] = 0.0f;
    if (mk[i] > 0.5f) ne = i + 1;
  }
  for (int j = tid; j < m4; j += T) {
    ddx[j] = j < m ? dst[2 * j] : kSentinel;
    ddy[j] = j < m ? dst[2 * j + 1] : kSentinel;
    if (ddx[j] != kSentinel || ddy[j] != kSentinel) me = j + 1;
  }
  ne = __reduce_max_sync(icp::kFull, ne);
  me = __reduce_max_sync(icp::kFull, me);
  __syncthreads();
  if ((tid & 31) == 0) {
    atomicMax(&fs.n_eff, ne);
    atomicMax(&fs.m_eff, me);
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) Tm[k] = t0[pair * 6 + k];
    fs.it = 0;
    fs.done = 0;
    fs.inner = 0;
    // This block's slice of the n_eff swept rows, [row0, row0 + s_n), and
    // its sweep: ng groups of kQ queries (query s * ng + g of the slice is
    // group g's s-th), nseg ascending segments of seg_len dst points (a
    // multiple of 4) of the m4_eff swept; task k is group k % ng of
    // segment k / ng.
    const int n_eff = fs.n_eff;
    const int per = (n_eff + n_blocks - 1) / n_blocks;
    fs.m4_eff = round4(fs.m_eff);
    fs.row0 = min(n_eff, rank * per);
    fs.s_n = min(n_eff, fs.row0 + per) - fs.row0;
    fs.ng = (fs.s_n + kQ - 1) / kQ;
    fs.nseg = sweep_segments(fs.ng, fs.s_n, fs.m4_eff, T);
    fs.seg_len = round4((fs.m4_eff + fs.nseg - 1) / fs.nseg);
  }
  // Every block has started before any writes into the leader.
  cluster.sync();

  while (fs.it < outer_iters && fs.done == 0) {
    const float r00 = Tm[0], r01 = Tm[1], r10 = Tm[2], r11 = Tm[3];
    const float tx = Tm[4], ty = Tm[5];
    const int row0 = fs.row0, s_n = fs.s_n, ng = fs.ng, nseg = fs.nseg;
    for (int task = tid; task < ng * nseg; task += T) {
      const int g = task % ng, seg = task / ng;
      const int lo = min(fs.m4_eff, seg * fs.seg_len);
      const int hi = min(fs.m4_eff, lo + fs.seg_len);
      float qx[kQ], qy[kQ], best[kQ];
      int bi[kQ];
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const int i = row0 + min(s * ng + g, s_n - 1);
        qx[s] = __fadd_rn(__fadd_rn(__fmul_rn(r00, sx[i]),
                                    __fmul_rn(r01, sy[i])), tx);
        qy[s] = __fadd_rn(__fadd_rn(__fmul_rn(r10, sx[i]),
                                    __fmul_rn(r11, sy[i])), ty);
        best[s] = INFINITY;
        bi[s] = 0;
      }
      for (int e = lo; e < hi; e += 4) {
        const float4 cx = *reinterpret_cast<const float4*>(&ddx[e]);
        const float4 cy = *reinterpret_cast<const float4*>(&ddy[e]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float px = u == 0 ? cx.x : u == 1 ? cx.y : u == 2 ? cx.z
                                                                  : cx.w;
          const float py = u == 0 ? cy.x : u == 1 ? cy.y : u == 2 ? cy.z
                                                                  : cy.w;
#pragma unroll
          for (int s = 0; s < kQ; ++s) {
            const float ex = __fsub_rn(qx[s], px);
            const float ey = __fsub_rn(qy[s], py);
            const float d = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
            if (d < best[s]) {
              best[s] = d;
              bi[s] = e + u;
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const int ql = s * ng + g;
        if (ql >= s_n) continue;
        if (nseg > 1) {
          part_d[seg * s_n + ql] = best[s];
          part_i[seg * s_n + ql] = bi[s];
        } else {
          cluster.map_shared_rank(mdx, 0)[row0 + ql] = ddx[bi[s]];
          cluster.map_shared_rank(mdy, 0)[row0 + ql] = ddy[bi[s]];
        }
      }
    }
    if (nseg > 1) {
      // Thread ql merges query ql's partials in segment order.
      __syncthreads();
      for (int ql = tid; ql < s_n; ql += T) {
        float b = part_d[ql];
        int j = part_i[ql];
        for (int k = 1; k < nseg; ++k) {
          const float d = part_d[k * s_n + ql];
          const int i = part_i[k * s_n + ql];
          if (lex_less(d, i, b, j)) {
            b = d;
            j = i;
          }
        }
        cluster.map_shared_rank(mdx, 0)[row0 + ql] = ddx[j];
        cluster.map_shared_rank(mdy, 0)[row0 + ql] = ddy[j];
      }
    }
    if (rank == 0) {
      for (int i = tid; i < fs.n_eff; i += T) {
        stx[i] = __fadd_rn(__fadd_rn(__fmul_rn(r00, sx[i]),
                                     __fmul_rn(r01, sy[i])), tx);
        sty[i] = __fadd_rn(__fadd_rn(__fmul_rn(r10, sx[i]),
                                     __fmul_rn(r11, sy[i])), ty);
      }
    }
    cluster.sync();  // the matches are in the leader
    if (rank == 0) {
      float d[7];
      irls_loop(stx, sty, mdx, mdy, mk, fs.n_eff, rx, ry, P, fs.sh, d);
      if (tid == 0) {
        const bool isid = d[0] == 1.0f && d[1] == 0.0f && d[2] == 0.0f &&
                          d[3] == 1.0f && d[4] == 0.0f && d[5] == 0.0f;
        float nt[6];
        nt[0] = d[0] * r00 + d[1] * r10;
        nt[1] = d[0] * r01 + d[1] * r11;
        nt[2] = d[2] * r00 + d[3] * r10;
        nt[3] = d[2] * r01 + d[3] * r11;
        nt[4] = d[0] * tx + d[1] * ty + d[4];
        nt[5] = d[2] * tx + d[3] * ty + d[5];
        fs.inner += (int)d[6];
        const int it = fs.it + 1;
        for (int r = 0; r < n_blocks; ++r) {
          FrameShared* to = cluster.map_shared_rank(&fs, r);
          for (int k = 0; k < 6; ++k) to->T[k] = nt[k];
          to->it = it;
          to->done = isid ? 1 : 0;
        }
      }
    }
    cluster.sync();  // T and the exit are in every block
  }
  if (rank == 0 && tid == 0) {
    float* o = out + pair * 8;
    for (int k = 0; k < 6; ++k) o[k] = Tm[k];
    o[6] = (float)fs.it;
    o[7] = (float)fs.inner;
  }
}

// The launch configuration of B clusters of `cluster` blocks of T threads
// for pairs of n x m points; attr holds the cluster dimension.
template <int T>
cudaLaunchConfig_t config(int b, int n, int m, int cluster,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cluster, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(n, m, T);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest pair's shared memory and clusters of up to 16 blocks, set
// once per instance.
template <int T>
cudaError_t set_attributes() {
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      frame_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxPoints, kMaxPoints, T));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(frame_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  }
  set = e == cudaSuccess;
  return e;
}

// Clusters the card holds at once (0 when none can be placed), or a
// negative CUDA error.
template <int T>
int resident(int n, int m, int cluster) {
  cudaError_t e = set_attributes<T>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<T>(1, n, m, cluster, attr, 0);
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, frame_kernel<T>, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return n_clusters;
}

// Returns cudaGetLastError(), the launch API's error, or -1 when no
// cluster of that size can be placed on this card (checked when the
// shape changes).
template <int T>
int launch(const float* src, const float* smask, const float* dst, int b,
           int n, int m, const float* t0, float* out,
           const icp::IrlsParams& P, int outer_iters, int cluster,
           cudaStream_t stream) {
  static int placed_cluster = 0;
  static int placed_smem = 0;
  cudaError_t e = set_attributes<T>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<T>(b, n, m, cluster, attr, stream);
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  if (cluster != placed_cluster || smem != placed_smem) {
    const int held = resident<T>(n, m, cluster);
    if (held < 0) return -held;
    if (held < 1) return -1;
    placed_cluster = cluster;
    placed_smem = smem;
  }
  e = cudaLaunchKernelEx(&cfg, frame_kernel<T>, src, smask, dst, n, m, t0, P,
                         outer_iters, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace icp_frame
