// The fixed-correspondence robust SE(2) IRLS loop on one thread-block
// cluster (irls_loop.cu, irls_loop_batched.cu's cluster route), and one
// GN update's statistics on one (gn_stats.cu): irls_cluster_run<false>
// runs one iteration of the loop's body, the statistics at a given
// transform, without the tail, so the two run one op sequence.
//
// irls.cuh runs the loop as one block; here a cluster of C blocks shares
// it.  Block r of the cluster owns the contiguous slice [r*per,
// (r+1)*per) of the N points, per = ceil(N / C), held in its shared
// memory (src, dst, mask and the residuals) when the slice fits, else
// read in place from global memory with the residuals in a scratch
// array.  Every pass over the points is a pass over each block's slice;
// what the one-block loop reduces over its warps, the cluster reduces
// over its blocks through distributed shared memory (DSMEM), each block
// reading its peers' partials after a cluster barrier, all its loads in
// flight at once (a lane or an unrolled load per peer):
//   - each radix pass of the exact medians: every block builds its own
//     2 x 256-bin histogram, then sums the C histograms bin by bin and
//     picks the digit itself.  Every block holds the same integer
//     counts, so every block picks the same digit with no broadcast.
//     The histograms are double-buffered: a block clears the next pass's
//     buffer while its peers may still be reading this pass's;
//   - the count/max pass of the lower order statistic: C counts and
//     maxima, combined exactly.  So the medians and MADs are bitwise
//     those of the one-block loop;
//   - the sums pass: each point's terms in float32, as the one-block
//     loop's and the plain version's, accumulated in float64 (per
//     thread, its warp's tree, its block's warps in order, then the
//     blocks by one fixed shuffle tree in every block) and rounded to
//     float32 once.
//     The order is fixed, so runs repeat bitwise, and the sums are
//     correctly rounded to within float64's roundoff: a stop decision
//     (an error that rose by one or two float32 ulps) goes as the exact
//     sums would take it, whatever the cluster size.  Results differ
//     from the one-block loop's by float32 roundoff.
// Every block then runs the scalar tail on the same sums (thread 0, in
// _irls_loop's op order, as irls.cuh's tail), so every block holds the
// same transform and stop flag and runs the same number of iterations
// and cluster barriers.  A last cluster barrier keeps every block
// resident until no peer reads its shared memory.
#pragma once

#include <cooperative_groups.h>

#include "irls.cuh"

namespace icp {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kClusterWarps = kClusterThreads / 32;
// Shared-memory bytes of one staged point: sx sy dx dy rx ry, the mask.
constexpr int kStagedPointBytes = 6 * 4 + 1;

struct ClusterShared {
  unsigned hist[2][2][256];  // [buffer][dimension][bin], this block's
  unsigned total[2][256];    // the cluster's counts of the current pass
  float red[kClusterWarps][2];
  int ired[kClusterWarps][2];
  double dred[kClusterWarps][kNumSums];
  double part[kNumSums];     // this block's sums, read by its peers
  int icnt[2];               // this block's counts, read by its peers
  float imax[2];             // this block's maxima, read by its peers
  float rot[4];
  float t[2];
  float med[2];
  int rank[2];
  unsigned prefix[2];
  float prev_err;
  int n;
  int it;
  int done;
};

// One block's points: element i of x is sx[i * sstr], of y sy[i * sstr],
// of the dst dx/dy likewise with dstr, of the mask m[i * mstr]; the
// residuals rx[i], ry[i].
struct Slice {
  const float* sx;
  const float* sy;
  const float* dx;
  const float* dy;
  long long sstr;
  long long dstr;
  const unsigned char* m;
  long long mstr;
  float* rx;
  float* ry;
  int n;
  __device__ __forceinline__ bool valid(int i) const {
    return m[i * mstr] != 0;
  }
  __device__ __forceinline__ float x(int i) const { return sx[i * sstr]; }
  __device__ __forceinline__ float y(int i) const { return sy[i * sstr]; }
  __device__ __forceinline__ float u(int i) const { return dx[i * dstr]; }
  __device__ __forceinline__ float v(int i) const { return dy[i * dstr]; }
};

// Exact masked medians of v0 and v1 over the cluster's n mask-true
// points, v = r[i] or |r[i] - c|; every thread of every block gets both.
// Entry and exit: this block's hist[0] is zero.
__device__ void cluster_median_pair(const Slice& S, bool absdev, float c0,
                                    float c1, int n, ClusterShared& sh,
                                    cg::cluster_group& cluster,
                                    float& out0, float& out1) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n_blocks = (int)cluster.num_blocks();
  const int n_ceil = ((S.n + nthreads - 1) / nthreads) * nthreads;
  const int h = n / 2;
  if (tid == 0) {
    sh.rank[0] = h;
    sh.rank[1] = h;
    sh.prefix[0] = 0u;
    sh.prefix[1] = 0u;
  }
  __syncthreads();
  unsigned pmask = 0u;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    unsigned(*hist)[256] = sh.hist[p & 1];
    const unsigned pv0 = sh.prefix[0];
    const unsigned pv1 = sh.prefix[1];
    for (int i = tid; i < n_ceil; i += nthreads) {
      int bin0 = 256, bin1 = 256;
      if (i < S.n && S.valid(i)) {
        float v0 = S.rx[i], v1 = S.ry[i];
        if (absdev) {
          v0 = fabsf(__fsub_rn(v0, c0));
          v1 = fabsf(__fsub_rn(v1, c1));
        }
        const unsigned k0 = order_key(v0), k1 = order_key(v1);
        if ((k0 & pmask) == pv0) bin0 = (int)((k0 >> shift) & 0xffu);
        if ((k1 & pmask) == pv1) bin1 = (int)((k1 >> shift) & 0xffu);
      }
      warp_aggregated_add(hist[0], bin0, lane);
      warp_aggregated_add(hist[1], bin1, lane);
    }
    // Every block's histogram of this pass is complete; every peer is
    // done reading the other buffer (last pass's), which is cleared here.
    cluster.sync();
    for (int b = tid; b < 512; b += nthreads) {
      // All C loads in flight at once, then their sum.
      unsigned v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        v[r] = r < n_blocks ? cluster.map_shared_rank(&hist[0][0], r)[b]
                            : 0u;
      }
      unsigned s = 0u;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) s += v[r];
      (&sh.total[0][0])[b] = s;
      (&sh.hist[(p + 1) & 1][0][0])[b] = 0u;
    }
    __syncthreads();
    if (warp < 2) select_bin(sh.total[warp], lane, shift, &sh.rank[warp],
                             &sh.prefix[warp]);
    pmask |= 0xffu << shift;
    __syncthreads();
  }
  // All surviving candidates share the full key: it is the upper order
  // statistic.  The lower one: the max below it if exactly h are below.
  const float vhi0 = key_value(sh.prefix[0]);
  const float vhi1 = key_value(sh.prefix[1]);
  int cl0 = 0, cl1 = 0;
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int i = tid; i < S.n; i += nthreads) {
    if (S.valid(i)) {
      float v0 = S.rx[i], v1 = S.ry[i];
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
    cl0 += __shfl_down_sync(kFull, cl0, o);
    cl1 += __shfl_down_sync(kFull, cl1, o);
    mx0 = fmaxf(mx0, __shfl_down_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_down_sync(kFull, mx1, o));
  }
  if (lane == 0) {
    sh.ired[warp][0] = cl0;
    sh.ired[warp][1] = cl1;
    sh.red[warp][0] = mx0;
    sh.red[warp][1] = mx1;
  }
  __syncthreads();
  if (tid == 0) {
    int c[2] = {0, 0};
    float m[2] = {-INFINITY, -INFINITY};
    for (int w = 0; w < (nthreads >> 5); ++w) {
      c[0] += sh.ired[w][0];
      c[1] += sh.ired[w][1];
      m[0] = fmaxf(m[0], sh.red[w][0]);
      m[1] = fmaxf(m[1], sh.red[w][1]);
    }
    sh.icnt[0] = c[0];
    sh.icnt[1] = c[1];
    sh.imax[0] = m[0];
    sh.imax[1] = m[1];
  }
  cluster.sync();
  if (warp == 0) {
    // Lane r reads block r's counts and maxima; exact integer sums and
    // maxima over the lanes.
    int c[2] = {0, 0};
    float m[2] = {-INFINITY, -INFINITY};
    if (lane < n_blocks) {
      const int* rc = cluster.map_shared_rank(&sh.icnt[0], lane);
      const float* rm = cluster.map_shared_rank(&sh.imax[0], lane);
      for (int d = 0; d < 2; ++d) {
        c[d] = rc[d];
        m[d] = rm[d];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      for (int d = 0; d < 2; ++d) {
        c[d] += __shfl_down_sync(kFull, c[d], o);
        m[d] = fmaxf(m[d], __shfl_down_sync(kFull, m[d], o));
      }
    }
    if (lane == 0) {
      const float vhi[2] = {vhi0, vhi1};
      for (int d = 0; d < 2; ++d) {
        const float vlo = (c[d] == h) ? m[d] : vhi[d];
        float med = (n % 2 == 1) ? vhi[d] : 0.5f * (vlo + vhi[d]);
        sh.med[d] = (n > 0) ? med : 0.0f;
      }
    }
  }
  __syncthreads();
  out0 = sh.med[0];
  out1 = sh.med[1];
}

// kLoop: the whole IRLS loop from identity on the cluster.  Block rank
// 0's thread 0 writes out: r00 r01 r10 r11 tx ty iterations 0, then the
// first iteration's median and sigma of x and y.
// Not kLoop: one GN update's statistics at rt = (r00 r01 r10 r11 tx ty),
// one pass of the loop's body (P.max_iter is 1) without the tail.  Block
// rank 0's thread 0 writes out's 16 floats in _gn_kernel's layout: the 11
// sums (S_u, S_uw, S_uw2, S_ur, S_uwr of x, of y, the Huber error), the
// count, sigma_x, sigma_y, 0, 0.
template <bool kLoop>
__device__ void irls_cluster_run(const Slice& S, const IrlsParams& P,
                                 ClusterShared& sh, float* out,
                                 const float* rt) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const bool writer = cluster.block_rank() == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;

  for (int b = tid; b < 512; b += nthreads) (&sh.hist[0][0][0])[b] = 0u;
  int cnt = 0;
  for (int i = tid; i < S.n; i += nthreads) cnt += S.valid(i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if (lane == 0) sh.ired[warp][0] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (nthreads >> 5); ++w) total += sh.ired[w][0];
    sh.icnt[0] = total;
    if constexpr (kLoop) {
      sh.rot[0] = 1.0f; sh.rot[1] = 0.0f; sh.rot[2] = 0.0f; sh.rot[3] = 1.0f;
      sh.t[0] = 0.0f; sh.t[1] = 0.0f;
    } else {
      for (int k = 0; k < 4; ++k) sh.rot[k] = rt[k];
      sh.t[0] = rt[4];
      sh.t[1] = rt[5];
    }
    sh.prev_err = FLT_MAX;
    sh.it = 0;
    sh.done = 0;
    if (kLoop && writer) {
      for (int k = 8; k < 12; ++k) out[k] = 0.0f;
    }
  }
  cluster.sync();
  if (warp == 0) {
    int total = lane < n_blocks ? cluster.map_shared_rank(&sh.icnt[0], lane)[0]
                                : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_down_sync(kFull, total, o);
    }
    if (lane == 0) sh.n = total;
  }
  __syncthreads();
  const int n = sh.n;

  while (sh.it < P.max_iter && sh.done == 0) {
    const float r00 = sh.rot[0], r01 = sh.rot[1];
    const float r10 = sh.rot[2], r11 = sh.rot[3];
    const float tx = sh.t[0], ty = sh.t[1];
    for (int i = tid; i < S.n; i += nthreads) {
      S.rx[i] = residual(r00, r01, S.x(i), S.y(i), tx, S.u(i));
      S.ry[i] = residual(r10, r11, S.x(i), S.y(i), ty, S.v(i));
    }
    __syncthreads();
    float med_x, med_y, mad_x, mad_y;
    cluster_median_pair(S, false, 0.0f, 0.0f, n, sh, cluster, med_x,
                        med_y);
    cluster_median_pair(S, true, med_x, med_y, n, sh, cluster, mad_x,
                        mad_y);
    const float sig_x = kMadScale * mad_x;
    const float sig_y = kMadScale * mad_y;
    const float g_x = (sig_x != 0.0f) ? 1.0f / sig_x : 0.0f;
    const float g_y = (sig_y != 0.0f) ? 1.0f / sig_y : 0.0f;

    double acc[kNumSums];
#pragma unroll
    for (int k = 0; k < kNumSums; ++k) acc[k] = 0.0;
    for (int i = tid; i < S.n; i += nthreads) {
      if (!S.valid(i)) continue;
      const float sxi = S.x(i), syi = S.y(i);
      const float ax = S.rx[i], ay = S.ry[i];
      const float ex = ax * ax, ey = ay * ay;
      const float wgt_x = (ex <= P.k2) ? 1.0f : P.huber_k / sqrtf(ex);
      const float wgt_y = (ey <= P.k2) ? 1.0f : P.huber_k / sqrtf(ey);
      const float u_x = wgt_x * g_x;
      const float u_y = wgt_y * g_y;
      const float w_x = -r00 * syi + r01 * sxi;
      const float w_y = -r10 * syi + r11 * sxi;
      // Each term rounded to float32 as in irls.cuh; summed in float64.
      const float uw_x = u_x * w_x, uw_y = u_y * w_y;
      acc[0] += u_x;
      acc[1] += uw_x;
      acc[2] += uw_x * w_x;
      acc[3] += u_x * ax;
      acc[4] += uw_x * ax;
      acc[5] += u_y;
      acc[6] += uw_y;
      acc[7] += uw_y * w_y;
      acc[8] += u_y * ay;
      acc[9] += uw_y * ay;
      const float e = ex + ey;
      acc[10] += (e <= P.k2) ? e : P.two_k * sqrtf(e) - P.k2;
    }
#pragma unroll
    for (int k = 0; k < kNumSums; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[k] += __shfl_down_sync(kFull, acc[k], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) sh.dred[warp][k] = acc[k];
    }
    __syncthreads();
    if (tid < kNumSums) {
      double s = 0.0;
      for (int w = 0; w < (nthreads >> 5); ++w) s += sh.dred[w][tid];
      sh.part[tid] = s;
    }
    cluster.sync();

    if (warp == 0) {
      // Lane r reads block r's sums; a fixed shuffle tree over the lanes
      // adds them, the same in every block.
      double v[kNumSums];
      const double* rp = cluster.map_shared_rank(
          &sh.part[0], lane < n_blocks ? lane : 0);
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) v[k] = lane < n_blocks ? rp[k] : 0.0;
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v[k] += __shfl_down_sync(kFull, v[k], o);
        }
      }
      float s[kNumSums];
#pragma unroll
      for (int k = 0; k < kNumSums; ++k) s[k] = (float)v[k];
      if (!kLoop && lane == 0) {
        if (writer) {
          for (int k = 0; k < kNumSums; ++k) out[k] = s[k];
          out[11] = (float)n;
          out[12] = sig_x;
          out[13] = sig_y;
          out[14] = 0.0f;
          out[15] = 0.0f;
        }
        sh.it += 1;
      }
      if (kLoop && lane == 0) {
        if (writer && sh.it == 0) {
          out[8] = med_x;
          out[9] = med_y;
          out[10] = sig_x;
          out[11] = sig_y;
        }
        const float s_u_x = s[0], s_uw_x = s[1], s_uw2_x = s[2];
        const float s_ur_x = s[3], s_uwr_x = s[4];
        const float s_u_y = s[5], s_uw_y = s[6], s_uw2_y = s[7];
        const float s_ur_y = s[8], s_uwr_y = s[9];
        const float err = s[10];

        // Normal equations (align2d_pallas._irls_loop), as irls.cuh.
        const float h00 = r00 * r00 * s_u_x + r10 * r10 * s_u_y;
        const float h01 = r00 * r01 * s_u_x + r10 * r11 * s_u_y;
        const float h02 = r00 * s_uw_x + r10 * s_uw_y;
        const float h11 = r01 * r01 * s_u_x + r11 * r11 * s_u_y;
        const float h12 = r01 * s_uw_x + r11 * s_uw_y;
        const float h22 = s_uw2_x + s_uw2_y;
        const float b0 = r00 * s_ur_x + r10 * s_ur_y;
        const float b1 = r01 * s_ur_x + r11 * s_ur_y;
        const float b2 = s_uwr_x + s_uwr_y;

        const float det = h00 * (h11 * h22 - h12 * h12)
                          - h01 * (h01 * h22 - h12 * h02)
                          + h02 * (h01 * h12 - h11 * h02);
        bool ok;
        if (P.det_rel_eps > 0.0f) {
          const float mx = fmaxf(fmaxf(fabsf(h00), fabsf(h01)),
                                 fmaxf(fmaxf(fabsf(h02), fabsf(h11)),
                                       fmaxf(fabsf(h12), fabsf(h22))));
          ok = fabsf(det) > P.det_rel_eps * mx * mx * mx;
        } else {
          ok = det != 0.0f;
        }
        ok = ok && (n >= 2);
        const float safe_det = ok ? det : 1.0f;
        const float a00 = h11 * h22 - h12 * h12;
        const float a01 = h02 * h12 - h01 * h22;
        const float a02 = h01 * h12 - h02 * h11;
        const float a11 = h00 * h22 - h02 * h02;
        const float a12 = h01 * h02 - h00 * h12;
        const float a22 = h00 * h11 - h01 * h01;
        float d0 = -(a00 * b0 + a01 * b1 + a02 * b2) / safe_det;
        float d1 = -(a01 * b0 + a11 * b1 + a12 * b2) / safe_det;
        float d2 = -(a02 * b0 + a12 * b1 + a22 * b2) / safe_det;
        if (!ok) { d0 = 0.0f; d1 = 0.0f; d2 = 0.0f; }

        // Stop conditions, in estimate_transform's order.
        bool stop = !ok;
        const float sd0 = d0 * P.point_scale, sd1 = d1 * P.point_scale;
        const float d2_phys = sd0 * sd0 + sd1 * sd1 + d2 * d2;
        stop = stop || (d2_phys < P.tol_d2);
        stop = stop || (err > sh.prev_err);

        if (!stop) {
          // SE(2) exp of the twist (geometry.se2 small-angle branch), then
          // T <- Exp(delta) o T.
          const float th = d2;
          const bool small = fabsf(th) < P.small_angle;
          const float safe_th = small ? 1.0f : th;
          const float t2 = th * th;
          const float av = small ? 1.0f - t2 / 6.0f : sinf(safe_th) / safe_th;
          const float bv = small ? th / 2.0f - t2 * th / 24.0f
                                 : (1.0f - cosf(safe_th)) / safe_th;
          const float tdx = av * d0 - bv * d1;
          const float tdy = bv * d0 + av * d1;
          const float cth = cosf(th), sth = sinf(th);
          sh.rot[0] = cth * r00 - sth * r10;
          sh.rot[1] = cth * r01 - sth * r11;
          sh.rot[2] = sth * r00 + cth * r10;
          sh.rot[3] = sth * r01 + cth * r11;
          sh.t[0] = cth * tx - sth * ty + tdx;
          sh.t[1] = sth * tx + cth * ty + tdy;
          sh.prev_err = err;
        }
        sh.done = stop ? 1 : 0;
        sh.it += 1;
      }
    }
    __syncthreads();
  }
  if (kLoop && writer && tid == 0) {
    for (int k = 0; k < 4; ++k) out[k] = sh.rot[k];
    out[4] = sh.t[0];
    out[5] = sh.t[1];
    out[6] = (float)sh.it;
    out[7] = 0.0f;
  }
  // No block leaves while a peer may still read its shared memory.
  cluster.sync();
}

// A cluster's whole loop (kLoop) or one update's statistics at rt (not
// kLoop) over one pair of n_pts points: block r stages its slice (src/dst
// (n, 2) with element strides s0/s1 and d0/d1, the bool mask with stride
// m0) into `stage`, the block's dynamic shared memory (kStagedPointBytes
// a point), or, when not `staged`, reads it in place with the residuals
// in scratch (2 n_pts floats); then runs irls_cluster_run.  Shared by
// irls_loop.cu (one pair), irls_loop_batched.cu (a cluster per pair,
// pointers offset by pair) and gn_stats.cu.
template <bool kLoop = true>
__device__ __forceinline__ void irls_cluster_pair(
    const float* __restrict__ src, long long s0, long long s1,
    const float* __restrict__ dst, long long d0, long long d1,
    const unsigned char* __restrict__ mask, long long m0, int n_pts,
    int staged, float* scratch, const IrlsParams& P, float* stage,
    ClusterShared& sh, float* out, const float* rt = nullptr) {
  const int n_blocks = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int per = (n_pts + n_blocks - 1) / n_blocks;
  const int lo = min(n_pts, rank * per);
  const int n_loc = min(n_pts, lo + per) - lo;
  Slice S;
  if (staged) {
    float* f = stage;
    unsigned char* m = reinterpret_cast<unsigned char*>(stage + 6 * per);
    for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
      const long long k = lo + i;
      f[i] = src[k * s0];
      f[per + i] = src[k * s0 + s1];
      f[2 * per + i] = dst[k * d0];
      f[3 * per + i] = dst[k * d0 + d1];
      m[i] = mask[k * m0];
    }
    __syncthreads();
    S = Slice{f, f + per, f + 2 * per, f + 3 * per, 1, 1, m, 1,
              f + 4 * per, f + 5 * per, n_loc};
  } else {
    S = Slice{src + lo * s0, src + lo * s0 + s1, dst + lo * d0,
              dst + lo * d0 + d1, s0, d0, mask + lo * m0, m0,
              scratch + lo, scratch + n_pts + lo, n_loc};
  }
  irls_cluster_run<kLoop>(S, P, sh, out, rt);
}

}  // namespace icp
