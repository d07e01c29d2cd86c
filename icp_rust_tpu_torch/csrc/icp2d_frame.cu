// icp2d_frame: one whole warm-started 2D ICP call (Icp2d::estimate,
// reference src/lib.rs:105-130) in one launch.
//
// Replaces the TPU kernel icp_rust_tpu/ops/align2d_pallas.py:
// _icp2d_frame_kernel (wrapper icp2d_frame_pallas, core _icp_outer_loop).
//
// Design: one thread-block cluster of C blocks of 1024 threads (C from N
// alone, frame_cluster: 16 from 512 points), launched with
// cudaLaunchKernelEx and a cluster dimension.
// Every block holds the whole sentinel-filled dst in shared memory as two
// coordinate rows, and src.  Outer loop (<= outer_iters):
//   1. block r transforms its contiguous, ascending slice of the src
//      points and sweeps them against the whole dst: Q queries a thread,
//      one 16-byte broadcast load of four dst points per coordinate row,
//      and, where the slice is too small to fill the block, dst cut into
//      ascending segments over the block's threads, their partials merged
//      lexicographically on (distance, index) in shared memory.  Within a
//      segment a strict '<' in ascending index order, so the lowest index
//      wins ties, and each distance is ex*ex + ey*ey with every rounding
//      explicit (--fmad=false): the matches are bitwise those of the
//      one-block sweep of frame.cuh, which icp2d_frame_pairs.cu runs;
//   2. each block writes its slice's matched points into the leader's
//      (block 0's) shared memory (distributed shared memory); a cluster
//      barrier;
//   3. the leader runs irls.cuh's IRLS loop over all N points with its
//      1024 threads (the loop of frame.cuh, on the same block size, so the
//      result is bitwise that of the one-block kernel), then the scalar
//      tail: left-compose, and the exit when dT is bitwise the identity
//      (the fixed point is exact), decided once, by the leader;
//   4. the leader writes T and the exit into every block's shared memory;
//      a cluster barrier.  No block reads another's shared memory after
//      it, so every block may leave once the loop ends.
//
// What bounds it on this card: the serial chain of the IRLS loop's
// block-wide passes and barriers on the leader's SM (28 us of an outer
// iteration's 33 at 768 x 768 on an H100, PERF.md).  The O(N*M) sweep,
// ~590k distance evaluations an outer iteration at 768 x 768, is issue
// bound and spread over C SMs; each cluster barrier costs about 1 us.
//
// Output (8 floats): r00 r01 r10 r11 tx ty outer_iterations
// inner_iterations (summed over the outer loop).
#include <cooperative_groups.h>

#include "irls.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
// Queries a thread in the sweep.
constexpr int kQ = 2;
// The coordinate of dst's padding rows up to a multiple of 4: as the
// wrapper's sentinel (ops/nn_cuda.py _SENTINEL), its squared distance
// overflows to +inf and never wins.
constexpr float kSentinel = 3e19f;

struct FrameShared {
  icp::IrlsShared sh;
  float T[6];
  int it;
  int done;
  int inner;
  // The block's sweep, kept here rather than in registers across the
  // leader's IRLS loop.
  int row0, s_n, ng, nseg, seg_len;
};

__host__ __device__ inline int round4(int m) { return (m + 3) & ~3; }

// Dynamic shared memory of every block: dst's two coordinate rows, src's
// 9 per-point rows (sx sy mask stx sty mdx mdy rx ry) and the sweep's
// per-segment partials (nseg * s_n <= kThreads * kQ distances and
// indices).
__host__ __device__ inline int frame_smem_bytes(int n, int m) {
  return (2 * round4(m) + 9 * n + 2 * kThreads * kQ)
         * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// src (n, 2) and dst (m, 2) interleaved, smask (n,), t0 6 floats.
__global__ void __launch_bounds__(kThreads)
icp2d_frame_kernel(const float* __restrict__ src,
                   const float* __restrict__ smask,
                   const float* __restrict__ dst, int n, int m,
                   const float* __restrict__ t0, icp::IrlsParams P,
                   int outer_iters, float* out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ FrameShared fs;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int m4 = round4(m);
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
  int* part_i = reinterpret_cast<int*>(part_d + kThreads * kQ);
  float* T = fs.T;

  for (int i = tid; i < n; i += kThreads) {
    sx[i] = src[2 * i];
    sy[i] = src[2 * i + 1];
    mk[i] = smask[i];
  }
  for (int j = tid; j < m4; j += kThreads) {
    ddx[j] = j < m ? dst[2 * j] : kSentinel;
    ddy[j] = j < m ? dst[2 * j + 1] : kSentinel;
  }
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) T[k] = t0[k];
    fs.it = 0;
    fs.done = 0;
    fs.inner = 0;
    // This block's slice of the queries, rows [row0, row0 + s_n), and its
    // sweep: ng groups of kQ queries (query s * ng + g of the slice is
    // thread g's s-th, g < ng), nseg ascending segments of seg_len dst
    // points (a multiple of 4), thread tid on group tid % ng of segment
    // tid / ng.
    const int per = (n + n_blocks - 1) / n_blocks;
    fs.row0 = min(n, rank * per);
    fs.s_n = min(n, fs.row0 + per) - fs.row0;
    fs.ng = (fs.s_n + kQ - 1) / kQ;
    fs.nseg = fs.ng > 0 ? max(1, kThreads / fs.ng) : 1;
    fs.seg_len = round4((m4 + fs.nseg - 1) / fs.nseg);
  }
  // Every block has started before any writes into the leader.
  cluster.sync();

  while (fs.it < outer_iters && fs.done == 0) {
    const float r00 = T[0], r01 = T[1], r10 = T[2], r11 = T[3];
    const float tx = T[4], ty = T[5];
    const int row0 = fs.row0, s_n = fs.s_n, ng = fs.ng, nseg = fs.nseg;
    const int seg = ng > 0 ? tid / ng : nseg;
    if (seg < nseg) {
      const int lo = min(m4, seg * fs.seg_len);
      const int hi = min(m4, lo + fs.seg_len);
      for (int g = tid % ng; g < ng; g += kThreads) {
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
    }
    if (nseg > 1) {
      // Thread ql merges query ql's partials in segment order.
      __syncthreads();
      for (int ql = tid; ql < s_n; ql += kThreads) {
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
      for (int i = tid; i < n; i += kThreads) {
        stx[i] = __fadd_rn(__fadd_rn(__fmul_rn(r00, sx[i]),
                                     __fmul_rn(r01, sy[i])), tx);
        sty[i] = __fadd_rn(__fadd_rn(__fmul_rn(r10, sx[i]),
                                     __fmul_rn(r11, sy[i])), ty);
      }
    }
    cluster.sync();  // the matches are in the leader
    if (rank == 0) {
      float d[7];
      irls_loop(stx, sty, mdx, mdy, mk, n, rx, ry, P, fs.sh, d);
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
    for (int k = 0; k < 6; ++k) out[k] = T[k];
    out[6] = (float)fs.it;
    out[7] = (float)fs.inner;
  }
}

// Blocks in the cluster for n points: the most, up to 16, that leave at
// least 32 query rows a block, measured best or within 1 % of it at
// every size timed from 128 to 1,536 points on an H100 (PERF.md).
int frame_cluster(int n) {
  int c = 16;
  while (c > 1 && n < 32 * c) c /= 2;
  return c;
}

}  // namespace

extern "C" int icp2d_frame_cluster(int n) { return frame_cluster(n); }

// src (n, 2), smask (n,), dst (m, 2) sentinel-masked, t0 6 floats as r00
// r01 r10 r11 tx ty; out 8 floats.  cluster: blocks in the cluster, 1-16.
// Returns cudaGetLastError(), the launch API's error, or -1 when no
// cluster of that size can be placed on this card.
extern "C" int icp2d_frame_launch_cluster(
    const float* src, const float* smask, const float* dst, int n, int m,
    const float* t0, float* out, float huber_k, float k2, float two_k,
    float det_rel_eps, float tol_d2, int inner_max_iter, float point_scale,
    float small_angle, int outer_iters, int cluster, void* stream) {
  static bool attributes_set = false;
  static int placed_cluster = 0;
  static int placed_smem = 0;
  if (cluster < 1 || cluster > 16 || n < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = frame_smem_bytes(n, m);
  if (!attributes_set) {
    // The largest frame's shared memory, set once.
    cudaError_t e = cudaFuncSetAttribute(
        icp2d_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        frame_smem_bytes(1536, 1536));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(icp2d_frame_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    attributes_set = true;
  }
  icp::IrlsParams P{huber_k, k2, two_k, det_rel_eps, tol_d2, inner_max_iter,
                    point_scale, small_angle};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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
        &n_clusters, icp2d_frame_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return -1;
    placed_cluster = cluster;
    placed_smem = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, icp2d_frame_kernel, src,
                                           smask, dst, n, m, t0, P,
                                           outer_iters, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The same launch on frame_cluster(n) blocks.
extern "C" int icp2d_frame_launch(const float* src, const float* smask,
                                  const float* dst, int n, int m,
                                  const float* t0, float* out, float huber_k,
                                  float k2, float two_k, float det_rel_eps,
                                  float tol_d2, int inner_max_iter,
                                  float point_scale, float small_angle,
                                  int outer_iters, void* stream) {
  return icp2d_frame_launch_cluster(src, smask, dst, n, m, t0, out, huber_k,
                                    k2, two_k, det_rel_eps, tol_d2,
                                    inner_max_iter, point_scale, small_angle,
                                    outer_iters, frame_cluster(n), stream);
}
