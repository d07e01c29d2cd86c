// The fixed-correspondence robust SE(2) IRLS loop as one thread block.
//
// Shared by irls_loop_batched.cu's one-block route (one block per pair of
// a batch) and the frame kernels of frame_cluster.cuh (the whole 2D ICP
// call, arrays in the leader block's shared memory), so all run one op
// sequence, as the TPU kernels shared align2d_pallas._irls_loop;
// irls_cluster.cuh spreads its passes over a cluster for irls_loop.cu,
// irls_loop_batched.cu's cluster route and gn_stats.cu.  The routine takes
// any block of 64 to 1024 threads, a multiple of 32 (two warps pick the
// two medians' digits).
//
// Steps 1-4 are gn_stats_block, one GN update's statistics at a given
// transform, which gn_stats_batched.cu also runs (as the TPU's
// _gn_batched_kernel and _irls_loop share align2d_pallas._gn_stats_core).
//
// Per iteration, with the whole block:
//   1. residuals r = R s + t - d into the rx/ry scratch (one pass);
//   2. exact masked medians of rx and ry together: four 8-bit radix
//      passes over the order-preserving u32 keys (align2d_pallas.
//      _order_keys_u32), 256-bin shared histograms with warp-aggregated
//      atomics, a warp-wide scan to pick each digit; the upper order
//      statistic is the key itself, the lower one comes from a count/max
//      pass (even-length average, reference src/stats.rs:18-27);
//   3. the MAD the same way on |r - median|;
//   4. one pass for the 10 normal-equation sums and the Huber error;
//   5. the scalar tail on thread 0 in _irls_loop's op order: adjugate 3x3
//      solve with the det_rel_eps test and n >= 2, the three stop
//      conditions, SE(2) exp with the eps_f32**0.25 small-angle branch,
//      left-compose; a stopping iteration discards its delta.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace icp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kNumSums = 11;
constexpr float kMadScale = 1.482602218505602f;

struct IrlsParams {
  float huber_k;      // k in solver units
  float k2;           // k * k, rounded once to f32
  float two_k;        // 2 * k, rounded once to f32
  float det_rel_eps;
  float tol_d2;
  int max_iter;
  float point_scale;
  float small_angle;  // eps_f32 ** 0.25
};

struct IrlsShared {
  unsigned hist[2][256];
  float red[kMaxWarps][kNumSums];
  int ired[kMaxWarps][2];
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

// Threads for a block that serves one pair of n points: about three
// points a thread, a multiple of 32 in [64, 1024] (256 at n = 768).
__host__ __device__ inline int block_threads(int n) {
  int t = ((n + 2) / 3 + 31) / 32 * 32;
  return t < 64 ? 64 : (t > 1024 ? 1024 : t);
}

// Monotone float -> u32 key: flip all bits of negatives, the sign bit of
// non-negatives.
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  unsigned b = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(b);
}

// rx = r00*sx + r01*sy + tx - dx, every rounding explicit so that each
// pass over the data sees the same value.
__device__ __forceinline__ float residual(float a, float b, float sx,
                                          float sy, float t, float d) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, sx), __fmul_rn(b, sy)),
                             t), d);
}

__device__ __forceinline__ void warp_aggregated_add(unsigned* hist, int bin,
                                                    int lane) {
  unsigned peers = __match_any_sync(kFull, bin);
  if (bin < 256 && lane == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], (unsigned)__popc(peers));
  }
}

// One warp: pick the bin holding rank *rank (the first bin whose
// cumulative count exceeds it), subtract the counts below it, append the
// digit to *prefix.  No owner means no candidates (n == 0): nothing moves.
__device__ __forceinline__ void select_bin(const unsigned* hist, int lane,
                                           int shift, int* rank,
                                           unsigned* prefix) {
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
    unsigned v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  const unsigned excl = inc - s;
  const unsigned r = (unsigned)(*rank);
  const unsigned ball = __ballot_sync(kFull, r >= excl && r < inc);
  if (ball != 0 && lane == __ffs(ball) - 1) {
    unsigned cum = excl;
    int j = 0;
    for (; j < 7; ++j) {
      if (r < cum + c[j]) break;
      cum += c[j];
    }
    *rank = (int)(r - cum);
    *prefix |= (unsigned)(lane * 8 + j) << shift;
  }
}

// Exact masked medians of v0 and v1 over the n mask-true points, where
// v = a[i], or |a[i] - c| when absdev.  Every thread gets both results.
__device__ void median_pair(const float* a0, const float* a1,
                            const float* mask, int n_pts, bool absdev,
                            float c0, float c1, int n, IrlsShared& sh,
                            float& out0, float& out1) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n_ceil = ((n_pts + nthreads - 1) / nthreads) * nthreads;
  const int h = n / 2;
  if (tid == 0) {
    sh.rank[0] = h;
    sh.rank[1] = h;
    sh.prefix[0] = 0u;
    sh.prefix[1] = 0u;
  }
  unsigned pmask = 0u;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    for (int b = tid; b < 512; b += nthreads) (&sh.hist[0][0])[b] = 0u;
    __syncthreads();
    const unsigned pv0 = sh.prefix[0];
    const unsigned pv1 = sh.prefix[1];
    for (int i = tid; i < n_ceil; i += nthreads) {
      int bin0 = 256, bin1 = 256;
      if (i < n_pts && mask[i] > 0.5f) {
        float v0 = a0[i], v1 = a1[i];
        if (absdev) {
          v0 = fabsf(__fsub_rn(v0, c0));
          v1 = fabsf(__fsub_rn(v1, c1));
        }
        const unsigned k0 = order_key(v0), k1 = order_key(v1);
        if ((k0 & pmask) == pv0) bin0 = (int)((k0 >> shift) & 0xffu);
        if ((k1 & pmask) == pv1) bin1 = (int)((k1 >> shift) & 0xffu);
      }
      warp_aggregated_add(sh.hist[0], bin0, lane);
      warp_aggregated_add(sh.hist[1], bin1, lane);
    }
    __syncthreads();
    if (warp < 2) select_bin(sh.hist[warp], lane, shift, &sh.rank[warp],
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
  for (int i = tid; i < n_pts; i += nthreads) {
    if (mask[i] > 0.5f) {
      float v0 = a0[i], v1 = a1[i];
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
    const float vhi[2] = {vhi0, vhi1};
    for (int d = 0; d < 2; ++d) {
      const float vlo = (c[d] == h) ? m[d] : vhi[d];
      float med = (n % 2 == 1) ? vhi[d] : 0.5f * (vlo + vhi[d]);
      sh.med[d] = (n > 0) ? med : 0.0f;
    }
  }
  __syncthreads();
  out0 = sh.med[0];
  out1 = sh.med[1];
}

// Count of mask-true points; every thread gets it.  (irls_loop counts with
// the same passes, fused with its set-up.)
__device__ inline int block_count(const float* mask, int n_pts,
                                  IrlsShared& sh) {
  const int tid = threadIdx.x;
  int cnt = 0;
  for (int i = tid; i < n_pts; i += blockDim.x) cnt += (mask[i] > 0.5f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if ((tid & 31) == 0) sh.ired[tid >> 5][0] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += sh.ired[w][0];
    sh.n = total;
  }
  __syncthreads();
  return sh.n;
}

// One robust GN update's statistics at (r00 r01 r10 r11, tx ty), steps 1-4
// above: the residual pass into rx/ry, the median and MAD of each
// dimension, then one pass for the 10 normal-equation sums and the Huber
// error over the n mask-true points, reduced by warp shuffles.  On return
// (after a barrier) sh.red[w][k] holds warp w's part of sum k (S_u, S_uw,
// S_uw2, S_ur, S_uwr for x, then for y, then the error; block_total adds
// them up in warp order); every thread gets sigma_x and sigma_y.
__device__ void gn_stats_block(const float* sx, const float* sy,
                               const float* dx, const float* dy,
                               const float* mask, int n_pts, float* rx,
                               float* ry, const IrlsParams& P,
                               IrlsShared& sh, int n, float r00, float r01,
                               float r10, float r11, float tx, float ty,
                               float& sig_x, float& sig_y) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  for (int i = tid; i < n_pts; i += nthreads) {
    rx[i] = residual(r00, r01, sx[i], sy[i], tx, dx[i]);
    ry[i] = residual(r10, r11, sx[i], sy[i], ty, dy[i]);
  }
  __syncthreads();

  float med_x, med_y, mad_x, mad_y;
  median_pair(rx, ry, mask, n_pts, false, 0.0f, 0.0f, n, sh, med_x, med_y);
  median_pair(rx, ry, mask, n_pts, true, med_x, med_y, n, sh, mad_x, mad_y);
  sig_x = kMadScale * mad_x;
  sig_y = kMadScale * mad_y;
  const float g_x = (sig_x != 0.0f) ? 1.0f / sig_x : 0.0f;
  const float g_y = (sig_y != 0.0f) ? 1.0f / sig_y : 0.0f;

  float acc[kNumSums];
#pragma unroll
  for (int k = 0; k < kNumSums; ++k) acc[k] = 0.0f;
  for (int i = tid; i < n_pts; i += nthreads) {
    if (!(mask[i] > 0.5f)) continue;
    const float ax = rx[i], ay = ry[i];
    const float ex = ax * ax, ey = ay * ay;
    const float wgt_x = (ex <= P.k2) ? 1.0f : P.huber_k / sqrtf(ex);
    const float wgt_y = (ey <= P.k2) ? 1.0f : P.huber_k / sqrtf(ey);
    const float u_x = wgt_x * g_x;
    const float u_y = wgt_y * g_y;
    const float w_x = -r00 * sy[i] + r01 * sx[i];
    const float w_y = -r10 * sy[i] + r11 * sx[i];
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
    for (int k = 0; k < kNumSums; ++k) sh.red[warp][k] = acc[k];
  }
  __syncthreads();
}

// Sum k of gn_stats_block over the block: its warps' parts in warp order.
__device__ __forceinline__ float block_total(const IrlsShared& sh, int k) {
  float s = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sh.red[w][k];
  return s;
}

// The whole IRLS loop from identity.  sx/sy: src, dx/dy: matched dst,
// mask: 1.0 for valid points; rx/ry: n_pts-float scratch each.  Every
// thread returns out = (r00, r01, r10, r11, tx, ty, iterations).
__device__ void irls_loop(const float* sx, const float* sy, const float* dx,
                          const float* dy, const float* mask, int n_pts,
                          float* rx, float* ry, const IrlsParams& P,
                          IrlsShared& sh, float out[7]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;

  int cnt = 0;
  for (int i = tid; i < n_pts; i += nthreads) cnt += (mask[i] > 0.5f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if (lane == 0) sh.ired[warp][0] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (nthreads >> 5); ++w) total += sh.ired[w][0];
    sh.n = total;
    sh.rot[0] = 1.0f; sh.rot[1] = 0.0f; sh.rot[2] = 0.0f; sh.rot[3] = 1.0f;
    sh.t[0] = 0.0f; sh.t[1] = 0.0f;
    sh.prev_err = FLT_MAX;
    sh.it = 0;
    sh.done = 0;
  }
  __syncthreads();
  const int n = sh.n;

  while (sh.it < P.max_iter && sh.done == 0) {
    const float r00 = sh.rot[0], r01 = sh.rot[1];
    const float r10 = sh.rot[2], r11 = sh.rot[3];
    const float tx = sh.t[0], ty = sh.t[1];
    float sig_x, sig_y;
    gn_stats_block(sx, sy, dx, dy, mask, n_pts, rx, ry, P, sh, n, r00, r01,
                   r10, r11, tx, ty, sig_x, sig_y);

    if (tid == 0) {
      float s[kNumSums];
      for (int k = 0; k < kNumSums; ++k) {
        s[k] = 0.0f;
        for (int w = 0; w < (nthreads >> 5); ++w) s[k] += sh.red[w][k];
      }
      const float s_u_x = s[0], s_uw_x = s[1], s_uw2_x = s[2];
      const float s_ur_x = s[3], s_uwr_x = s[4];
      const float s_u_y = s[5], s_uw_y = s[6], s_uw2_y = s[7];
      const float s_ur_y = s[8], s_uwr_y = s[9];
      const float err = s[10];

      // Normal equations (align2d_pallas._irls_loop).
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
    __syncthreads();
  }
  out[0] = sh.rot[0];
  out[1] = sh.rot[1];
  out[2] = sh.rot[2];
  out[3] = sh.rot[3];
  out[4] = sh.t[0];
  out[5] = sh.t[1];
  out[6] = (float)sh.it;
  __syncthreads();
}

}  // namespace icp
