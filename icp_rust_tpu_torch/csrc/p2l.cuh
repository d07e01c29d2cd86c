// The robust SE(3) point-to-plane statistics of one transform as one
// thread block, shared by p2l_loop.cu (the whole IRLS loop) and
// p2l_stats.cu (one update's statistics), so both run one op sequence, as
// the TPU kernels shared align3d_pallas._p2l_stats_core.  The routine
// takes any block of 32 to 1024 threads, a multiple of 32.
//
// Per call, with the whole block, at the transform (sh.rot, sh.t):
//   1. residuals r = n . (R s + t - d) into the r scratch (one pass);
//   2. the exact masked median of r: four 8-bit radix passes over the
//      order-preserving u32 keys (irls.cuh's order_key, warp-aggregated
//      256-bin shared histograms, select_bin), then a count/max pass for
//      the even-length lower order statistic; an exact order statistic,
//      so it equals the TPU's sixteen 2-bit passes;
//   3. the MAD the same way on |r - median|; sigma = 1.4826 MAD;
//   4. one pass for the 21 upper-triangle sums of u J J^T, the 6 of
//      u J r and the Huber error, J = [n | p x n], u = drho(r^2) / sigma,
//      reduced over the block in a fixed order (warp shuffles, then one
//      thread per sum over the warps).
// p2l_step is the scalar tail of one loop iteration on thread 0, in
// _p2l_loop_kernel's order: the 6x6 Cholesky of _chol_solve6, ok, the
// three stop conditions, the SE(3) exp (eps_f32**0.25 Taylor branch) and
// the left-compose; a stopping iteration discards its delta.
//
// The Huber weight is k / sqrt(e) where the TPU takes k * rsqrt(e), as in
// irls.cuh: f32 roundoff.
#pragma once

#include "irls.cuh"

namespace icp {

constexpr int kP2lSums = 28;  // 21 JtJ (upper, row-major), 6 Jtr, error

struct P2lCols {
  const float* sx;
  const float* sy;
  const float* sz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* nx;
  const float* ny;
  const float* nz;
  const float* mask;
};

struct P2lParams {
  float huber_k;      // k in solver units
  float k2;           // k * k, rounded once to f32
  float two_k;        // 2 * k, rounded once to f32
  float tol_d2;
  int max_iter;
  float s2;           // point_scale ** 2, rounded once to f32
  float small_angle;  // eps_f32 ** 0.25
};

struct P2lShared {
  unsigned hist[256];
  float red[kMaxWarps][kP2lSums];
  int ired[kMaxWarps];
  float sums[kP2lSums];
  float rot[9];
  float t[3];
  float med;
  int rank;
  unsigned prefix;
  float prev_err;
  int n;
  int it;
  int done;
};

// False for inf and NaN.
__device__ __forceinline__ bool finite_f(float x) {
  return fabsf(x) <= FLT_MAX;
}

// Index of (i, j), i <= j, in the row-major upper triangle of a 6x6.
__host__ __device__ constexpr int upper6(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Count of mask-true points; every thread gets it.
__device__ inline int p2l_count(const float* mask, int n_pts,
                                P2lShared& sh) {
  const int tid = threadIdx.x;
  int cnt = 0;
  for (int i = tid; i < n_pts; i += blockDim.x) cnt += (mask[i] > 0.5f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  if ((tid & 31) == 0) sh.ired[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += sh.ired[w];
    sh.n = total;
  }
  __syncthreads();
  return sh.n;
}

// Exact masked median of v over the n mask-true points, v = a[i], or
// |a[i] - c| when absdev (irls.cuh's median_pair on one dimension).
// Every thread gets the result.
__device__ float median_single(const float* a, const float* mask, int n_pts,
                               bool absdev, float c, int n, P2lShared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n_ceil = ((n_pts + nthreads - 1) / nthreads) * nthreads;
  const int h = n / 2;
  if (tid == 0) {
    sh.rank = h;
    sh.prefix = 0u;
  }
  unsigned pmask = 0u;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    for (int b = tid; b < 256; b += nthreads) sh.hist[b] = 0u;
    __syncthreads();
    const unsigned pv = sh.prefix;
    for (int i = tid; i < n_ceil; i += nthreads) {
      int bin = 256;
      if (i < n_pts && mask[i] > 0.5f) {
        float v = a[i];
        if (absdev) v = fabsf(__fsub_rn(v, c));
        const unsigned k = order_key(v);
        if ((k & pmask) == pv) bin = (int)((k >> shift) & 0xffu);
      }
      warp_aggregated_add(sh.hist, bin, lane);
    }
    __syncthreads();
    if (warp == 0) select_bin(sh.hist, lane, shift, &sh.rank, &sh.prefix);
    pmask |= 0xffu << shift;
    __syncthreads();
  }
  // All surviving candidates share the full key: it is the upper order
  // statistic.  The lower one: the max below it if exactly h are below.
  const float vhi = key_value(sh.prefix);
  int cl = 0;
  float mx = -INFINITY;
  for (int i = tid; i < n_pts; i += nthreads) {
    if (mask[i] > 0.5f) {
      float v = a[i];
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
    sh.ired[warp] = cl;
    sh.red[warp][0] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    float m = -INFINITY;
    for (int w = 0; w < (nthreads >> 5); ++w) {
      cnt += sh.ired[w];
      m = fmaxf(m, sh.red[w][0]);
    }
    const float vlo = (cnt == h) ? m : vhi;
    const float med = (n % 2 == 1) ? vhi : 0.5f * (vlo + vhi);
    sh.med = (n > 0) ? med : 0.0f;
  }
  __syncthreads();
  return sh.med;
}

// p = R s + t for point i, left to right as _p2l_stats_core writes it.
__device__ __forceinline__ void p2l_point(const P2lCols& c, int i,
                                          const float* rt, float& px,
                                          float& py, float& pz) {
  const float sx = c.sx[i], sy = c.sy[i], sz = c.sz[i];
  px = rt[0] * sx + rt[1] * sy + rt[2] * sz + rt[9];
  py = rt[3] * sx + rt[4] * sy + rt[5] * sz + rt[10];
  pz = rt[6] * sx + rt[7] * sy + rt[8] * sz + rt[11];
}

// The statistics at (sh.rot, sh.t), which the caller has synchronised.
// r: n_pts floats of scratch; n: the mask-true count.  On return
// sh.sums holds the 28 sums and every thread gets sigma.
__device__ float p2l_stats(const P2lCols& c, int n_pts, float* r, int n,
                           const P2lParams& P, P2lShared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  float rt[12];
#pragma unroll
  for (int k = 0; k < 9; ++k) rt[k] = sh.rot[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) rt[9 + k] = sh.t[k];

  for (int i = tid; i < n_pts; i += nthreads) {
    float px, py, pz;
    p2l_point(c, i, rt, px, py, pz);
    r[i] = c.nx[i] * (px - c.dx[i]) + c.ny[i] * (py - c.dy[i])
           + c.nz[i] * (pz - c.dz[i]);
  }
  __syncthreads();

  const float med = median_single(r, c.mask, n_pts, false, 0.0f, n, sh);
  const float mad = median_single(r, c.mask, n_pts, true, med, n, sh);
  const float sig = kMadScale * mad;
  const float g = (sig != 0.0f) ? 1.0f / sig : 0.0f;

  float acc[kP2lSums];
#pragma unroll
  for (int k = 0; k < kP2lSums; ++k) acc[k] = 0.0f;
  for (int i = tid; i < n_pts; i += nthreads) {
    if (!(c.mask[i] > 0.5f)) continue;
    float px, py, pz;
    p2l_point(c, i, rt, px, py, pz);
    const float nx = c.nx[i], ny = c.ny[i], nz = c.nz[i];
    const float ri = r[i];
    const float e = ri * ri;
    const float u = ((e <= P.k2) ? 1.0f : P.huber_k / sqrtf(e)) * g;
    const float j[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz,
                        px * ny - py * nx};
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
    for (int k = 0; k < kP2lSums; ++k) sh.red[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < kP2lSums) {
    float s = 0.0f;
    for (int w = 0; w < (nthreads >> 5); ++w) s += sh.red[w][tid];
    sh.sums[tid] = s;
  }
  __syncthreads();
  return sig;
}

// One iteration's scalar tail on thread 0 (align3d_pallas.py:281-355):
// solve, stop tests, and T <- Exp(delta) o T unless stopping.
__device__ void p2l_step(P2lShared& sh, int n, float sig,
                         const P2lParams& P) {
  const float* s = sh.sums;
  // 6x6 Cholesky of _chol_solve6: inv_lii = 1 / lii for L, divisions
  // for y and x.
  float l[6][6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) l[i][j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float d = s[upper6(i, i)];
#pragma unroll
    for (int k = 0; k < i; ++k) d = d - l[i][k] * l[i][k];
    ok = ok && (d > 0.0f);
    const float lii = sqrtf((d > 0.0f) ? d : 1.0f);
    l[i][i] = lii;
    const float inv_lii = 1.0f / lii;
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float v = s[upper6(i, j)];
#pragma unroll
      for (int k = 0; k < i; ++k) v = v - l[j][k] * l[i][k];
      l[j][i] = v * inv_lii;
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = s[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = v - l[i][k] * y[k];
    y[i] = v / l[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v = v - l[k][i] * x[k];
    x[i] = v / l[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && finite_f(x[i]);
  ok = ok && (n >= 6) && (sig != 0.0f);
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = ok ? -x[i] : 0.0f;

  const float err = s[27];
  bool stop = !ok;
  const float d2_phys = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * P.s2
                        + (d[3] * d[3] + d[4] * d[4] + d[5] * d[5]);
  stop = stop || (d2_phys < P.tol_d2);
  stop = stop || (err > sh.prev_err);

  if (!stop) {
    // SE(3) exp of (v, w) with geometry.se3's Taylor branches.
    const float w0 = d[3], w1 = d[4], w2 = d[5];
    const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
    const float th = sqrtf(th2);
    const bool small = th < P.small_angle;
    const float safe2 = small ? 1.0f : th2;
    const float safe = sqrtf(safe2);
    const float av = small ? 1.0f - th2 / 6.0f : sinf(safe) / safe;
    const float bv = small ? 0.5f - th2 / 24.0f
                           : (1.0f - cosf(safe)) / safe2;
    const float cv = small ? 1.0f / 6.0f - th2 / 120.0f
                           : (safe - sinf(safe)) / (safe2 * safe);
    const float k2_00 = -(w1 * w1 + w2 * w2);
    const float k2_11 = -(w0 * w0 + w2 * w2);
    const float k2_22 = -(w0 * w0 + w1 * w1);
    const float k2_01 = w0 * w1;
    const float k2_02 = w0 * w2;
    const float k2_12 = w1 * w2;
    // R_delta = I + a K + b K^2
    const float e00 = 1.0f + bv * k2_00;
    const float e01 = -av * w2 + bv * k2_01;
    const float e02 = av * w1 + bv * k2_02;
    const float e10 = av * w2 + bv * k2_01;
    const float e11 = 1.0f + bv * k2_11;
    const float e12 = -av * w0 + bv * k2_12;
    const float e20 = -av * w1 + bv * k2_02;
    const float e21 = av * w0 + bv * k2_12;
    const float e22 = 1.0f + bv * k2_22;
    // V = I + b K + c K^2; t_delta = V v
    const float v00 = 1.0f + cv * k2_00;
    const float v01 = -bv * w2 + cv * k2_01;
    const float v02 = bv * w1 + cv * k2_02;
    const float v10 = bv * w2 + cv * k2_01;
    const float v11 = 1.0f + cv * k2_11;
    const float v12 = -bv * w0 + cv * k2_12;
    const float v20 = -bv * w1 + cv * k2_02;
    const float v21 = bv * w0 + cv * k2_12;
    const float v22 = 1.0f + cv * k2_22;
    const float tdx = v00 * d[0] + v01 * d[1] + v02 * d[2];
    const float tdy = v10 * d[0] + v11 * d[1] + v12 * d[2];
    const float tdz = v20 * d[0] + v21 * d[1] + v22 * d[2];
    // compose: R <- E R, t <- E t + t_delta
    const float* R = sh.rot;
    const float nr[9] = {
        e00 * R[0] + e01 * R[3] + e02 * R[6],
        e00 * R[1] + e01 * R[4] + e02 * R[7],
        e00 * R[2] + e01 * R[5] + e02 * R[8],
        e10 * R[0] + e11 * R[3] + e12 * R[6],
        e10 * R[1] + e11 * R[4] + e12 * R[7],
        e10 * R[2] + e11 * R[5] + e12 * R[8],
        e20 * R[0] + e21 * R[3] + e22 * R[6],
        e20 * R[1] + e21 * R[4] + e22 * R[7],
        e20 * R[2] + e21 * R[5] + e22 * R[8]};
    const float tx = sh.t[0], ty = sh.t[1], tz = sh.t[2];
    const float ntx = e00 * tx + e01 * ty + e02 * tz + tdx;
    const float nty = e10 * tx + e11 * ty + e12 * tz + tdy;
    const float ntz = e20 * tx + e21 * ty + e22 * tz + tdz;
#pragma unroll
    for (int k = 0; k < 9; ++k) sh.rot[k] = nr[k];
    sh.t[0] = ntx;
    sh.t[1] = nty;
    sh.t[2] = ntz;
    sh.prev_err = err;
  }
  sh.done = stop ? 1 : 0;
  sh.it += 1;
}

}  // namespace icp
