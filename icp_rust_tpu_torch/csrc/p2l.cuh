// The robust SE(3) point-to-plane solver's shared state and scalar tail,
// shared by p2l_cluster.cuh's loop (p2l_loop.cu) and one-update
// statistics (p2l_stats.cu), as the TPU kernels shared
// align3d_pallas._p2l_stats_core.
//
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
  float red[kMaxWarps];
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
