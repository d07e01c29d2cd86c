// Native host-side oracle: the reference algorithm (tier4/icp_rust) in C++.
//
// The reference is 100% native Rust with no Python anywhere (SURVEY.md §2);
// this translation unit is the build's native analogue.  It serves two
// roles:
//   1. the single-CPU performance baseline for bench.py (KD-tree 1-NN +
//      robust Gauss-Newton, f64 — the same algorithmic budget as the
//      crate: reference src/lib.rs:59-174), and
//   2. a second, independent parity oracle cross-checking utils/oracle_np.py.
//
// Exported C ABI (ctypes): icp2d_estimate / icp3d_estimate / *_once.
//
// Behavior citations:
//   - Huber rho/drho on squared errors: reference src/huber.rs:6-26
//   - median (even length averages two central order stats): src/stats.rs:11-28
//   - sigma = 1.482602218505602 * MAD per dimension: src/stats.rs:39-60
//   - weighted GN accumulation over rows of J, skipping sigma==0 dims:
//     src/lib.rs:218-261
//   - adjugate 3x3 inverse, det==0 guard: src/linalg.rs:3-29
//   - inner loop stop conditions and order: src/lib.rs:59-84
//   - outer loop, no convergence test: src/lib.rs:105-130
//   - 3D: match in 3D, solve on xy: src/lib.rs:133-174

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kHuberK = 1.345;               // src/lib.rs:32
constexpr double kMadScale = 1.482602218505602; // src/stats.rs:42
constexpr int kInnerMaxIter = 200;              // src/lib.rs:61
constexpr double kDeltaSqTol = 1e-6;            // src/lib.rs:60

struct Transform {
  double r00 = 1, r01 = 0, r10 = 0, r11 = 1;
  double tx = 0, ty = 0;

  static Transform from_twist(double vx, double vy, double theta) {
    // src/se2.rs:21-41 (exact theta == 0 branch).
    Transform t;
    const double c = std::cos(theta), s = std::sin(theta);
    t.r00 = c; t.r01 = -s; t.r10 = s; t.r11 = c;
    if (theta == 0.0) {
      t.tx = vx; t.ty = vy;
    } else {
      t.tx = (s * vx - (1.0 - c) * vy) / theta;
      t.ty = ((1.0 - c) * vx + s * vy) / theta;
    }
    return t;
  }

  inline void apply(double x, double y, double& ox, double& oy) const {
    ox = r00 * x + r01 * y + tx;
    oy = r10 * x + r11 * y + ty;
  }

  Transform compose(const Transform& rhs) const {
    // src/transform.rs:42-51: this * rhs.
    Transform o;
    o.r00 = r00 * rhs.r00 + r01 * rhs.r10;
    o.r01 = r00 * rhs.r01 + r01 * rhs.r11;
    o.r10 = r10 * rhs.r00 + r11 * rhs.r10;
    o.r11 = r10 * rhs.r01 + r11 * rhs.r11;
    o.tx = r00 * rhs.tx + r01 * rhs.ty + tx;
    o.ty = r10 * rhs.tx + r11 * rhs.ty + ty;
    return o;
  }
};

inline double huber_drho(double e, double k) {
  // src/huber.rs:17-26.
  const double k2 = k * k;
  return e <= k2 ? 1.0 : k / std::sqrt(e);
}

inline double huber_rho(double e, double k) {
  // src/huber.rs:6-15.
  const double k2 = k * k;
  return e <= k2 ? e : 2.0 * k * std::sqrt(e) - k2;
}

double median_inplace(std::vector<double>& v) {
  // src/stats.rs:11-28.
  const size_t n = v.size();
  const size_t h = n / 2;
  std::nth_element(v.begin(), v.begin() + h, v.end());
  if (n % 2 == 1) return v[h];
  std::nth_element(v.begin(), v.begin() + (h - 1), v.begin() + h);
  return (v[h - 1] + v[h]) / 2.0;
}

// sigma per dimension; returns false iff empty (src/stats.rs:49-60).
bool calc_stddevs(const std::vector<double>& rx, const std::vector<double>& ry,
                  double sigma[2]) {
  if (rx.empty()) return false;
  std::vector<double> tmp;
  for (int j = 0; j < 2; ++j) {
    const std::vector<double>& col = j == 0 ? rx : ry;
    tmp = col;
    const double m = median_inplace(tmp);
    for (double& e : tmp) e = std::fabs(e - m);
    sigma[j] = kMadScale * median_inplace(tmp);
  }
  return true;
}

// Adjugate 3x3 solve of (jtj) x = jtr; false iff det == 0 (src/linalg.rs).
bool solve3x3(const double m[3][3], const double b[3], double x[3]) {
  const double det = m[0][0] * (m[2][2] * m[1][1] - m[2][1] * m[1][2]) -
                     m[1][0] * (m[2][2] * m[0][1] - m[2][1] * m[0][2]) +
                     m[2][0] * (m[1][2] * m[0][1] - m[1][1] * m[0][2]);
  if (det == 0.0) return false;
  double adj[3][3] = {
      {m[2][2] * m[1][1] - m[2][1] * m[1][2],
       -(m[2][2] * m[0][1] - m[2][1] * m[0][2]),
       m[1][2] * m[0][1] - m[1][1] * m[0][2]},
      {-(m[2][2] * m[1][0] - m[2][0] * m[1][2]),
       m[2][2] * m[0][0] - m[2][0] * m[0][2],
       -(m[1][2] * m[0][0] - m[1][0] * m[0][2])},
      {m[2][1] * m[1][0] - m[2][0] * m[1][1],
       -(m[2][1] * m[0][0] - m[2][0] * m[0][1]),
       m[1][1] * m[0][0] - m[1][0] * m[0][1]}};
  for (int i = 0; i < 3; ++i) {
    x[i] = (adj[i][0] * b[0] + adj[i][1] * b[1] + adj[i][2] * b[2]) / det;
  }
  return true;
}

double huber_error(const Transform& t, const double* src, const double* dst,
                   size_t n) {
  // src/lib.rs:45-50.
  double sum = 0.0;
  for (size_t i = 0; i < n; ++i) {
    double px, py;
    t.apply(src[2 * i], src[2 * i + 1], px, py);
    const double rx = px - dst[2 * i], ry = py - dst[2 * i + 1];
    sum += huber_rho(rx * rx + ry * ry, kHuberK);
  }
  return sum;
}

// src/lib.rs:218-261.
bool weighted_gauss_newton_update(const Transform& t, const double* src,
                                  const double* dst, size_t n,
                                  double delta[3]) {
  if (!(n > 0 && n >= 2)) return false;  // check_input_size src/lib.rs:186-189
  std::vector<double> rx(n), ry(n);
  for (size_t i = 0; i < n; ++i) {
    double px, py;
    t.apply(src[2 * i], src[2 * i + 1], px, py);
    rx[i] = px - dst[2 * i];
    ry[i] = py - dst[2 * i + 1];
  }
  double sigma[2];
  if (!calc_stddevs(rx, ry, sigma)) return false;

  double jtr[3] = {0, 0, 0};
  double jtj[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  for (size_t i = 0; i < n; ++i) {
    const double ax = src[2 * i], ay = src[2 * i + 1];
    // J = [R | R*(-ay, ax)^T]  (src/lib.rs:176-184)
    const double bx = t.r00 * (-ay) + t.r01 * ax;
    const double by = t.r10 * (-ay) + t.r11 * ax;
    const double jrow[2][3] = {{t.r00, t.r01, bx}, {t.r10, t.r11, by}};
    const double r[2] = {rx[i], ry[i]};
    for (int j = 0; j < 2; ++j) {
      if (sigma[j] == 0.0) continue;  // src/lib.rs:245-247
      const double g = 1.0 / sigma[j];
      const double w = huber_drho(r[j] * r[j], kHuberK);
      const double wg = w * g;
      for (int k = 0; k < 3; ++k) {
        jtr[k] += wg * jrow[j][k] * r[j];
        for (int l = 0; l < 3; ++l) jtj[k][l] += wg * jrow[j][k] * jrow[j][l];
      }
    }
  }
  double x[3];
  if (!solve3x3(jtj, jtr, x)) return false;
  delta[0] = -x[0]; delta[1] = -x[1]; delta[2] = -x[2];
  return true;
}

// src/lib.rs:59-84.
Transform estimate_transform(const double* src, const double* dst, size_t n) {
  double prev_error = std::numeric_limits<double>::max();
  Transform t;
  for (int it = 0; it < kInnerMaxIter; ++it) {
    double delta[3];
    if (!weighted_gauss_newton_update(t, src, dst, n, delta)) break;
    const double d2 =
        delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2];
    if (d2 < kDeltaSqTol) break;
    const double e = huber_error(t, src, dst, n);
    if (e > prev_error) break;
    prev_error = e;
    t = Transform::from_twist(delta[0], delta[1], delta[2]).compose(t);
  }
  return t;
}

// ---------------- KD-tree (exact 1-NN, any dim) -----------------------------
//
// Replaces the reference's external nearest_neighbor crate (Cargo.toml:22-25,
// leaf_size=1 semantics).  Median-split build; branch-and-bound search.

template <int D>
struct KdTree {
  const double* pts;  // (n, D) row-major
  std::vector<uint32_t> idx;
  struct Node { double split; int axis; uint32_t begin, end, left, right; };
  std::vector<Node> nodes;
  static constexpr uint32_t kLeaf = 0xffffffffu;
  static constexpr int kLeafSize = 8;

  void build(const double* p, size_t n) {
    pts = p;
    idx.resize(n);
    std::iota(idx.begin(), idx.end(), 0u);
    nodes.clear();
    nodes.reserve(2 * n / kLeafSize + 2);
    build_rec(0, static_cast<uint32_t>(n));
  }

  uint32_t build_rec(uint32_t begin, uint32_t end) {
    const uint32_t me = static_cast<uint32_t>(nodes.size());
    nodes.push_back({});
    Node& n0 = nodes[me];
    n0.begin = begin; n0.end = end;
    if (end - begin <= kLeafSize) {
      nodes[me].left = kLeaf;
      return me;
    }
    // Pick the widest axis.
    double lo[D], hi[D];
    for (int d = 0; d < D; ++d) {
      lo[d] = std::numeric_limits<double>::infinity();
      hi[d] = -std::numeric_limits<double>::infinity();
    }
    for (uint32_t i = begin; i < end; ++i) {
      const double* q = pts + idx[i] * D;
      for (int d = 0; d < D; ++d) {
        lo[d] = std::min(lo[d], q[d]);
        hi[d] = std::max(hi[d], q[d]);
      }
    }
    int axis = 0;
    for (int d = 1; d < D; ++d)
      if (hi[d] - lo[d] > hi[axis] - lo[axis]) axis = d;
    const uint32_t mid = (begin + end) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid,
                     idx.begin() + end, [&](uint32_t a, uint32_t b) {
                       return pts[a * D + axis] < pts[b * D + axis];
                     });
    nodes[me].axis = axis;
    nodes[me].split = pts[idx[mid] * D + axis];
    const uint32_t l = build_rec(begin, mid);
    const uint32_t r = build_rec(mid, end);
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }

  void search_rec(uint32_t node, const double* q, double& best_d,
                  uint32_t& best_i) const {
    const Node& n0 = nodes[node];
    if (n0.left == kLeaf) {
      for (uint32_t i = n0.begin; i < n0.end; ++i) {
        const double* p = pts + idx[i] * D;
        double d = 0;
        for (int k = 0; k < D; ++k) {
          const double diff = q[k] - p[k];
          d += diff * diff;
        }
        if (d < best_d || (d == best_d && idx[i] < best_i)) {
          best_d = d;
          best_i = idx[i];
        }
      }
      return;
    }
    const double diff = q[n0.axis] - n0.split;
    const uint32_t near = diff < 0 ? n0.left : n0.right;
    const uint32_t far = diff < 0 ? n0.right : n0.left;
    search_rec(near, q, best_d, best_i);
    if (diff * diff <= best_d) search_rec(far, q, best_d, best_i);
  }

  uint32_t search(const double* q) const {
    double best_d = std::numeric_limits<double>::infinity();
    uint32_t best_i = 0;
    search_rec(0, q, best_d, best_i);
    return best_i;
  }
};

}  // namespace

extern "C" {

// rt layout (row-major): [r00, r01, r10, r11, tx, ty].
static void pack(const Transform& t, double* rt) {
  rt[0] = t.r00; rt[1] = t.r01; rt[2] = t.r10; rt[3] = t.r11;
  rt[4] = t.tx;  rt[5] = t.ty;
}
static Transform unpack(const double* rt) {
  Transform t;
  t.r00 = rt[0]; t.r01 = rt[1]; t.r10 = rt[2]; t.r11 = rt[3];
  t.tx = rt[4];  t.ty = rt[5];
  return t;
}

// One inner-loop alignment with fixed correspondences (parity testing).
void estimate_transform_c(const double* src, const double* dst, int64_t n,
                          double* out_rt) {
  pack(estimate_transform(src, dst, static_cast<size_t>(n)), out_rt);
}

// Full 2D ICP: reference Icp2d::estimate (src/lib.rs:105-130).
void icp2d_estimate(const double* src, int64_t n_src, const double* dst,
                    int64_t n_dst, const double* init_rt, int64_t max_iter,
                    double* out_rt) {
  KdTree<2> tree;
  tree.build(dst, static_cast<size_t>(n_dst));
  Transform t = unpack(init_rt);
  std::vector<double> src_t(2 * n_src), matched(2 * n_src);
  for (int64_t it = 0; it < max_iter; ++it) {
    for (int64_t i = 0; i < n_src; ++i) {
      t.apply(src[2 * i], src[2 * i + 1], src_t[2 * i], src_t[2 * i + 1]);
    }
    for (int64_t i = 0; i < n_src; ++i) {
      const uint32_t j = tree.search(&src_t[2 * i]);
      matched[2 * i] = dst[2 * j];
      matched[2 * i + 1] = dst[2 * j + 1];
    }
    const Transform dt = estimate_transform(src_t.data(), matched.data(),
                                            static_cast<size_t>(n_src));
    t = dt.compose(t);
  }
  pack(t, out_rt);
}

// Full 3D planar ICP: reference Icp3d::estimate (src/lib.rs:148-173) —
// match in 3D, solve on xy.
void icp3d_estimate(const double* src, int64_t n_src, const double* dst,
                    int64_t n_dst, const double* init_rt, int64_t max_iter,
                    double* out_rt) {
  KdTree<3> tree;
  tree.build(dst, static_cast<size_t>(n_dst));
  Transform t = unpack(init_rt);
  std::vector<double> src_t(3 * n_src);
  std::vector<double> src_xy(2 * n_src), matched_xy(2 * n_src);
  for (int64_t it = 0; it < max_iter; ++it) {
    for (int64_t i = 0; i < n_src; ++i) {
      t.apply(src[3 * i], src[3 * i + 1], src_t[3 * i], src_t[3 * i + 1]);
      src_t[3 * i + 2] = src[3 * i + 2];  // z untouched (src/lib.rs:52-57)
    }
    for (int64_t i = 0; i < n_src; ++i) {
      const uint32_t j = tree.search(&src_t[3 * i]);
      matched_xy[2 * i] = dst[3 * j];
      matched_xy[2 * i + 1] = dst[3 * j + 1];
      src_xy[2 * i] = src_t[3 * i];
      src_xy[2 * i + 1] = src_t[3 * i + 1];
    }
    const Transform dt = estimate_transform(src_xy.data(), matched_xy.data(),
                                            static_cast<size_t>(n_src));
    t = dt.compose(t);
  }
  pack(t, out_rt);
}

}  // extern "C"
