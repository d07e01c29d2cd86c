// The fixed-correspondence robust SE(3) point-to-plane IRLS loop on one
// thread-block cluster (p2l_loop.cu), and one GN update's statistics on
// one (p2l_stats.cu): p2l_cluster_run<false> runs one iteration of the
// loop's body, the statistics at a given transform, without the tail, so
// the two run one op sequence.
//
// A cluster of C blocks shares each iteration, as irls_cluster.cuh
// shares the SE(2) loop.  Block r of the cluster owns the contiguous
// slice [r*per, (r+1)*per) of the N points, per = ceil(N / C), held in
// its shared memory (src, dst, normals, the mask as a byte and the
// residual: 41 bytes a point; P2lStagedSlice) when the slice fits, else
// read in place from global memory with the residuals in a scratch array
// (P2lGlobalSlice).  Every pass over the points is a pass over each
// block's slice, and the cluster reduces over its blocks through
// distributed shared memory (DSMEM), each block reading its peers'
// partials after a cluster barrier:
//   - each of the four radix passes of the exact median and of the MAD:
//     every block builds its own 256-bin histogram, then sums the C
//     histograms bin by bin (all C loads in flight) and picks the digit
//     itself with select_bin.  Every block holds the same integer
//     counts, so every block picks the same digit with no broadcast.
//     The histograms are double-buffered: a block clears the next pass's
//     buffer while its peers may still read this pass's;
//   - the count/max pass of the even-length lower order statistic: C
//     counts and maxima, one lane per peer, combined exactly.  So the
//     median and the MAD are the exact masked median's, bitwise;
//   - the sums pass: each point's 28 terms (21 of u J J^T, 6 of u J r,
//     the Huber error) in float32, in _p2l_stats_core's op order,
//     accumulated in float64 (per thread, its warp's shuffle tree, its
//     block's warps in order, then the blocks by one fixed shuffle tree in
//     every block) and rounded to float32 once.  The order is fixed, so
//     runs repeat bitwise, and the sums are the exact sums correctly
//     rounded to within float64's roundoff: the stop tests (err >
//     prev_err, d2_phys < tol_d2) go as the exact sums would take them,
//     whatever C is.
// In the loop every block then runs p2l.cuh's scalar tail p2l_step on
// thread 0 with the same sums (the 6x6 Cholesky, ok, the three stops in
// _p2l_loop_kernel's order, the SE(3) exp, the compose), so every block
// holds the same transform and stop flag and runs the same number of
// iterations and cluster barriers.  A last cluster barrier keeps every
// block resident until no peer reads its shared memory.
#pragma once

#include <cooperative_groups.h>

#include "p2l.cuh"

namespace icp {

namespace cg = cooperative_groups;

constexpr int kP2lClusterThreads = 512;
constexpr int kP2lMaxCluster = 16;
constexpr int kP2lClusterWarps = kP2lClusterThreads / 32;
// Shared-memory bytes of one staged point: s, d, n, the residual, the
// mask.
constexpr int kP2lStagedPointBytes = 10 * 4 + 1;

struct P2lClusterShared {
  // The transform, stop state and float sums of p2l.cuh's tail, and the
  // median's per-warp partials.
  P2lShared one;
  unsigned hist[2][256];  // [buffer][bin], this block's
  unsigned total[256];    // the cluster's counts of the current pass
  double dred[kP2lClusterWarps][kP2lSums];
  double part[kP2lSums];  // this block's sums, read by its peers
  int icnt;               // this block's count, read by its peers
  float imax;             // this block's maximum, read by its peers
};

// One block's points read in place from global memory: src s, dst d and
// normals nrm, (n, 3) each with element (i, k) at p[i*rs + k*cs]; the
// mask as bytes m or, when mf is set, as floats (true above 0.5),
// element i at [i * mstr]; the residuals r[i] in a scratch array.
struct P2lGlobalSlice {
  const float* sp;
  const float* dp;
  const float* np;
  long long srs, scs, drs, dcs, nrs, ncs;
  const unsigned char* m;
  const float* mf;
  long long mstr;
  float* r;
  int n;
  __device__ __forceinline__ bool valid(int i) const {
    return mf ? mf[i * mstr] > 0.5f : m[i * mstr] != 0;
  }
  __device__ __forceinline__ float s(int i, int k) const {
    return sp[i * srs + k * scs];
  }
  __device__ __forceinline__ float d(int i, int k) const {
    return dp[i * drs + k * dcs];
  }
  __device__ __forceinline__ float nrm(int i, int k) const {
    return np[i * nrs + k * ncs];
  }
};

// One block's points staged in its shared memory: columns sx sy sz dx dy
// dz nx ny nz r of `per` floats each from f, then the mask bytes m.  Its
// few registers leave the sums pass's 28 float64 sums room.
struct P2lStagedSlice {
  float* f;
  const unsigned char* m;
  int per;
  int n;
  float* r;
  __device__ __forceinline__ bool valid(int i) const { return m[i] != 0; }
  __device__ __forceinline__ float s(int i, int k) const {
    return f[k * per + i];
  }
  __device__ __forceinline__ float d(int i, int k) const {
    return f[(3 + k) * per + i];
  }
  __device__ __forceinline__ float nrm(int i, int k) const {
    return f[(6 + k) * per + i];
  }
};

// p = R s + t for point i of a slice, left to right as _p2l_stats_core
// writes it.
template <class Slice>
__device__ __forceinline__ void p2l_moved(const Slice& S, int i,
                                          const float* rt, float& px,
                                          float& py, float& pz) {
  const float sx = S.s(i, 0), sy = S.s(i, 1), sz = S.s(i, 2);
  px = rt[0] * sx + rt[1] * sy + rt[2] * sz + rt[9];
  py = rt[3] * sx + rt[4] * sy + rt[5] * sz + rt[10];
  pz = rt[6] * sx + rt[7] * sy + rt[8] * sz + rt[11];
}

// Exact masked median of v over the cluster's n mask-true points, v = r[i]
// or |r[i] - c|; every thread of every block gets it.  Entry and exit:
// this block's hist[0] is zero.
template <class Slice>
__device__ float p2l_cluster_median(const Slice& S, bool absdev, float c,
                                    int n, P2lClusterShared& sh,
                                    cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n_blocks = (int)cluster.num_blocks();
  const int n_ceil = ((S.n + nthreads - 1) / nthreads) * nthreads;
  const int h = n / 2;
  if (tid == 0) {
    sh.one.rank = h;
    sh.one.prefix = 0u;
  }
  __syncthreads();
  unsigned pmask = 0u;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    unsigned* hist = sh.hist[p & 1];
    const unsigned pv = sh.one.prefix;
    for (int i = tid; i < n_ceil; i += nthreads) {
      int bin = 256;
      if (i < S.n && S.valid(i)) {
        float v = S.r[i];
        if (absdev) v = fabsf(__fsub_rn(v, c));
        const unsigned k = order_key(v);
        if ((k & pmask) == pv) bin = (int)((k >> shift) & 0xffu);
      }
      warp_aggregated_add(hist, bin, lane);
    }
    // Every block's histogram of this pass is complete; every peer is
    // done reading the other buffer (last pass's), which is cleared here.
    cluster.sync();
    for (int b = tid; b < 256; b += nthreads) {
      unsigned v[kP2lMaxCluster];
#pragma unroll
      for (int r = 0; r < kP2lMaxCluster; ++r) {
        v[r] = r < n_blocks ? cluster.map_shared_rank(hist, r)[b] : 0u;
      }
      unsigned s = 0u;
#pragma unroll
      for (int r = 0; r < kP2lMaxCluster; ++r) s += v[r];
      sh.total[b] = s;
      sh.hist[(p + 1) & 1][b] = 0u;
    }
    __syncthreads();
    if (warp == 0) {
      select_bin(sh.total, lane, shift, &sh.one.rank, &sh.one.prefix);
    }
    pmask |= 0xffu << shift;
    __syncthreads();
  }
  // All surviving candidates share the full key: it is the upper order
  // statistic.  The lower one: the max below it if exactly h are below.
  const float vhi = key_value(sh.one.prefix);
  int cl = 0;
  float mx = -INFINITY;
  for (int i = tid; i < S.n; i += nthreads) {
    if (S.valid(i)) {
      float v = S.r[i];
      if (absdev) v = fabsf(__fsub_rn(v, c));
      if (v < vhi) {
        ++cl;
        mx = fmaxf(mx, v);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cl += __shfl_down_sync(kFull, cl, o);
    mx = fmaxf(mx, __shfl_down_sync(kFull, mx, o));
  }
  if (lane == 0) {
    sh.one.ired[warp] = cl;
    sh.one.red[warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    float m = -INFINITY;
    for (int w = 0; w < (nthreads >> 5); ++w) {
      cnt += sh.one.ired[w];
      m = fmaxf(m, sh.one.red[w]);
    }
    sh.icnt = cnt;
    sh.imax = m;
  }
  cluster.sync();
  if (warp == 0) {
    // Lane r reads block r's count and maximum; exact integer sums and
    // maxima over the lanes.
    int cnt = 0;
    float m = -INFINITY;
    if (lane < n_blocks) {
      cnt = *cluster.map_shared_rank(&sh.icnt, lane);
      m = *cluster.map_shared_rank(&sh.imax, lane);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cnt += __shfl_down_sync(kFull, cnt, o);
      m = fmaxf(m, __shfl_down_sync(kFull, m, o));
    }
    if (lane == 0) {
      const float vlo = (cnt == h) ? m : vhi;
      const float med = (n % 2 == 1) ? vhi : 0.5f * (vlo + vhi);
      sh.one.med = (n > 0) ? med : 0.0f;
    }
  }
  __syncthreads();
  return sh.one.med;
}

// kLoop: the whole p2l IRLS loop from the identity on the cluster.  Block
// rank 0's thread 0 writes out: r00..r22 (row-major), tx ty tz,
// iterations, then the first iteration's median, MAD and sigma (0 when
// max_iter < 1).
// Not kLoop: one GN update's statistics at `at` = (R row-major, t), one
// pass of the loop's body (P.max_iter is 1) without the tail.  Block rank
// 0's thread 0 writes out's 32 floats in _p2l_kernel's layout: the 21
// upper-triangle sums of u J J^T, the 6 of u J r, the Huber error, the
// count, sigma, 0, 0.
template <bool kLoop, class Slice>
__device__ void p2l_cluster_run(const Slice& S, const P2lParams& P,
                                P2lClusterShared& sh, float* out,
                                const float* at) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const bool writer = cluster.block_rank() == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;

  for (int b = tid; b < 512; b += nthreads) (&sh.hist[0][0])[b] = 0u;
  int cnt = 0;
  for (int i = tid; i < S.n; i += nthreads) cnt += S.valid(i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if (lane == 0) sh.one.ired[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (nthreads >> 5); ++w) total += sh.one.ired[w];
    sh.icnt = total;
    if constexpr (kLoop) {
#pragma unroll
      for (int k = 0; k < 9; ++k) sh.one.rot[k] = (k % 4 == 0) ? 1.0f : 0.0f;
      sh.one.t[0] = 0.0f;
      sh.one.t[1] = 0.0f;
      sh.one.t[2] = 0.0f;
    } else {
      for (int k = 0; k < 9; ++k) sh.one.rot[k] = at[k];
      for (int k = 0; k < 3; ++k) sh.one.t[k] = at[9 + k];
    }
    sh.one.prev_err = FLT_MAX;
    sh.one.it = 0;
    sh.one.done = 0;
    if (kLoop && writer) {
      for (int k = 13; k < 16; ++k) out[k] = 0.0f;
    }
  }
  cluster.sync();
  if (warp == 0) {
    int total = lane < n_blocks ? *cluster.map_shared_rank(&sh.icnt, lane)
                                : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_down_sync(kFull, total, o);
    }
    if (lane == 0) sh.one.n = total;
  }
  __syncthreads();
  const int n = sh.one.n;

  while (sh.one.it < P.max_iter && sh.one.done == 0) {
    float rt[12];
#pragma unroll
    for (int k = 0; k < 9; ++k) rt[k] = sh.one.rot[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) rt[9 + k] = sh.one.t[k];
    for (int i = tid; i < S.n; i += nthreads) {
      float px, py, pz;
      p2l_moved(S, i, rt, px, py, pz);
      S.r[i] = S.nrm(i, 0) * (px - S.d(i, 0)) + S.nrm(i, 1) * (py - S.d(i, 1))
               + S.nrm(i, 2) * (pz - S.d(i, 2));
    }
    __syncthreads();
    const float med = p2l_cluster_median(S, false, 0.0f, n, sh, cluster);
    const float mad = p2l_cluster_median(S, true, med, n, sh, cluster);
    const float sig = kMadScale * mad;
    const float g = (sig != 0.0f) ? 1.0f / sig : 0.0f;

    double acc[kP2lSums];
#pragma unroll
    for (int k = 0; k < kP2lSums; ++k) acc[k] = 0.0;
    for (int i = tid; i < S.n; i += nthreads) {
      if (!S.valid(i)) continue;
      float px, py, pz;
      p2l_moved(S, i, rt, px, py, pz);
      const float nx = S.nrm(i, 0), ny = S.nrm(i, 1), nz = S.nrm(i, 2);
      const float ri = S.r[i];
      const float e = ri * ri;
      const float u = ((e <= P.k2) ? 1.0f : P.huber_k / sqrtf(e)) * g;
      const float j[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz,
                          px * ny - py * nx};
      // Each term rounded to float32 as in p2l.cuh; summed in float64.
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) acc[upper6(a, b)] += u * j[a] * j[b];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += u * j[a] * ri;
      acc[27] += (e <= P.k2) ? e : P.two_k * sqrtf(e) - P.k2;
    }
#pragma unroll
    for (int k = 0; k < kP2lSums; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[k] += __shfl_down_sync(kFull, acc[k], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kP2lSums; ++k) sh.dred[warp][k] = acc[k];
    }
    __syncthreads();
    if (tid < kP2lSums) {
      double s = 0.0;
      for (int w = 0; w < (nthreads >> 5); ++w) s += sh.dred[w][tid];
      sh.part[tid] = s;
    }
    cluster.sync();

    if (warp == 0) {
      // Lane r reads block r's sums; a fixed shuffle tree over the lanes
      // adds them, the same in every block.
      double v[kP2lSums];
      const double* rp = cluster.map_shared_rank(
          &sh.part[0], lane < n_blocks ? lane : 0);
#pragma unroll
      for (int k = 0; k < kP2lSums; ++k) v[k] = lane < n_blocks ? rp[k] : 0.0;
#pragma unroll
      for (int k = 0; k < kP2lSums; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v[k] += __shfl_down_sync(kFull, v[k], o);
        }
      }
      if (!kLoop && lane == 0) {
        if (writer) {
          for (int k = 0; k < kP2lSums; ++k) out[k] = (float)v[k];
          out[28] = (float)n;
          out[29] = sig;
          out[30] = 0.0f;
          out[31] = 0.0f;
        }
        sh.one.it += 1;
      }
      if (kLoop && lane == 0) {
#pragma unroll
        for (int k = 0; k < kP2lSums; ++k) sh.one.sums[k] = (float)v[k];
        if (writer && sh.one.it == 0) {
          out[13] = med;
          out[14] = mad;
          out[15] = sig;
        }
        p2l_step(sh.one, n, sig, P);
      }
    }
    __syncthreads();
  }
  if (kLoop && writer && tid == 0) {
    for (int k = 0; k < 9; ++k) out[k] = sh.one.rot[k];
    for (int k = 0; k < 3; ++k) out[9 + k] = sh.one.t[k];
    out[12] = (float)sh.one.it;
  }
  // No block leaves while a peer may still read its shared memory.
  cluster.sync();
}

// A cluster's whole loop (kLoop) or one update's statistics at `at` (not
// kLoop) over one cloud of n_pts points: src, dst and normals (n, 3) with
// element strides (s0, s1), (d0, d1), (n0, n1), the bool or float32
// (mask_f32, true above 0.5) mask with stride m0.  kStaged: block r
// stages its slice into `stage`, the block's dynamic shared memory
// (kP2lStagedPointBytes a point), else it reads it in place with the
// residuals in scratch (n_pts floats); then runs p2l_cluster_run.  The
// body of p2l_loop.cu's and p2l_stats.cu's kernels.
template <bool kStaged, bool kLoop>
__device__ __forceinline__ void p2l_cluster_cloud(
    const float* __restrict__ src, long long s0, long long s1,
    const float* __restrict__ dst, long long d0, long long d1,
    const float* __restrict__ nrm, long long n0, long long n1,
    const void* __restrict__ mask, long long m0, int mask_f32, int n_pts,
    float* scratch, const P2lParams& P, float* stage, P2lClusterShared& sh,
    float* out, const float* at) {
  const int n_blocks = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int per = (n_pts + n_blocks - 1) / n_blocks;
  const int lo = min(n_pts, rank * per);
  const int n_loc = min(n_pts, lo + per) - lo;
  const unsigned char* mb = static_cast<const unsigned char*>(mask);
  const float* mf = static_cast<const float*>(mask);
  if constexpr (kStaged) {
    // Columns sx sy sz dx dy dz nx ny nz r, per floats each, then the
    // mask bytes.
    float* f = stage;
    unsigned char* m = reinterpret_cast<unsigned char*>(stage + 10 * per);
    for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
      const long long k = lo + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f[c * per + i] = src[k * s0 + c * s1];
        f[(3 + c) * per + i] = dst[k * d0 + c * d1];
        f[(6 + c) * per + i] = nrm[k * n0 + c * n1];
      }
      m[i] = mask_f32 ? (mf[k * m0] > 0.5f) : (mb[k * m0] != 0);
    }
    __syncthreads();
    p2l_cluster_run<kLoop>(P2lStagedSlice{f, m, per, n_loc, f + 9 * per}, P,
                           sh, out, at);
  } else {
    p2l_cluster_run<kLoop>(
        P2lGlobalSlice{src + lo * s0, dst + lo * d0, nrm + lo * n0, s0, s1,
                       d0, d1, n0, n1, mask_f32 ? nullptr : mb + lo * m0,
                       mask_f32 ? mf + lo * m0 : nullptr, m0, scratch + lo,
                       n_loc},
        P, sh, out, at);
  }
}

}  // namespace icp
