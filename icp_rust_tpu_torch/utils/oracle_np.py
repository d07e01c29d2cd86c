"""Reference-semantics float64 oracle in NumPy and SciPy (this package's
own copy of the JAX package's ``utils/oracle_np.py``; no torch).

It re-implements the reference crate's algorithm in vectorized float64
NumPy (the summation order differs from the crate's sequential fold at
the last ulp, so trajectory parity is tolerance-based).  It serves as the
trajectory oracle of the reference examples/scan2d.rs flow and as the
CLI's fallback when the native C++ oracle (``native/oracle``) cannot be
built.

Every function cites the reference behavior it mirrors.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

HUBER_K = 1.345  # reference src/lib.rs:32
MAD_SCALE = 1.482602218505602  # reference src/stats.rs:42
INNER_MAX_ITER = 200  # reference src/lib.rs:61
DELTA_SQ_TOL = 1e-6  # reference src/lib.rs:60


class Transform:
    """Reference src/transform.rs: rot 2x2 + t, twist constructor."""

    __slots__ = ("rot", "t")

    def __init__(self, rot: np.ndarray, t: np.ndarray):
        self.rot = np.asarray(rot, dtype=np.float64)
        self.t = np.asarray(t, dtype=np.float64)

    @staticmethod
    def identity() -> "Transform":
        return Transform(np.eye(2), np.zeros(2))

    @staticmethod
    def from_twist(param) -> "Transform":
        # reference src/se2.rs:21-41 (exact theta == 0 branch).
        vx, vy, theta = map(float, param)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s], [s, c]])
        if theta == 0.0:
            t = np.array([vx, vy])
        else:
            t = np.array(
                [
                    (s * vx - (1.0 - c) * vy) / theta,
                    ((1.0 - c) * vx + s * vy) / theta,
                ]
            )
        return Transform(rot, t)

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self.rot.T + self.t

    def inverse(self) -> "Transform":
        rt = self.rot.T
        return Transform(rt, -(rt @ self.t))

    def compose(self, rhs: "Transform") -> "Transform":
        return Transform(self.rot @ rhs.rot, self.rot @ rhs.t + self.t)


def median(x: np.ndarray) -> float | None:
    # reference src/stats.rs:11-28 (quickselect; even length averages the
    # two central order statistics).
    n = len(x)
    if n == 0:
        return None
    s = np.partition(x, [max(n // 2 - 1, 0), n // 2])
    if n % 2 == 1:
        return float(s[n // 2])
    return float((s[n // 2 - 1] + s[n // 2]) / 2.0)


def calc_stddevs(residuals: np.ndarray) -> np.ndarray | None:
    # reference src/stats.rs:30-60.
    out = np.zeros(residuals.shape[1])
    for j in range(residuals.shape[1]):
        col = residuals[:, j]
        m = median(col)
        if m is None:
            return None
        mad = median(np.abs(col - m))
        if mad is None:
            return None
        out[j] = MAD_SCALE * mad
    return out


def drho(e: np.ndarray, k: float) -> np.ndarray:
    # reference src/huber.rs:17-26.
    k2 = k * k
    with np.errstate(divide="ignore"):
        return np.where(e <= k2, 1.0, k / np.sqrt(np.maximum(e, 1e-300)))


def rho(e: np.ndarray, k: float) -> np.ndarray:
    # reference src/huber.rs:6-15.
    k2 = k * k
    return np.where(e <= k2, e, 2.0 * k * np.sqrt(e) - k2)


def huber_error(t: Transform, src: np.ndarray, dst: np.ndarray) -> float:
    # reference src/lib.rs:45-50.
    r = t.apply(src) - dst
    return float(np.sum(rho(np.sum(r * r, axis=1), HUBER_K)))


def inverse3x3(m: np.ndarray) -> np.ndarray | None:
    # reference src/linalg.rs:3-29: adjugate/det with exact det==0 guard.
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    det = (
        m00 * (m22 * m11 - m21 * m12)
        - m10 * (m22 * m01 - m21 * m02)
        + m20 * (m12 * m01 - m11 * m02)
    )
    if det == 0.0:
        return None
    adj = np.array(
        [
            [m22 * m11 - m21 * m12, -(m22 * m01 - m21 * m02), m12 * m01 - m11 * m02],
            [-(m22 * m10 - m20 * m12), m22 * m00 - m20 * m02, -(m12 * m00 - m10 * m02)],
            [m21 * m10 - m20 * m11, -(m21 * m00 - m20 * m01), m11 * m00 - m10 * m01],
        ]
    )
    return adj / det


def weighted_gauss_newton_update(
    t: Transform, src: np.ndarray, dst: np.ndarray
) -> np.ndarray | None:
    # reference src/lib.rs:218-261, vectorized.
    n = len(src)
    if not (n > 0 and n >= 2):  # check_input_size, src/lib.rs:186-189
        return None
    r = t.apply(src) - dst  # (N, 2)
    stddevs = calc_stddevs(r)
    if stddevs is None:
        return None
    # J_i = [R | R @ (-y_i, x_i)^T]  (src/lib.rs:176-184)
    arm = np.stack([-src[:, 1], src[:, 0]], axis=1) @ t.rot.T  # (N, 2)
    j = np.concatenate(
        [np.broadcast_to(t.rot, (n, 2, 2)), arm[:, :, None]], axis=2
    )  # (N, 2, 3)
    w = drho(r * r, HUBER_K)  # (N, 2)
    g = np.zeros(2)
    dim_ok = stddevs != 0.0
    g[dim_ok] = 1.0 / stddevs[dim_ok]
    u = w * g  # (N, 2); zero columns where sigma == 0 (src/lib.rs:245-247)
    jtr = np.einsum("ni,nik,ni->k", u, j, r)
    jtj = np.einsum("ni,nik,nil->kl", u, j, j)
    inv = inverse3x3(jtj)
    if inv is None:
        return None
    return -(inv @ jtr)


def estimate_transform(src: np.ndarray, dst: np.ndarray) -> Transform:
    # reference src/lib.rs:59-84 (exact stop-condition ordering).
    prev_error = np.inf
    t = Transform.identity()
    for _ in range(INNER_MAX_ITER):
        delta = weighted_gauss_newton_update(t, src, dst)
        if delta is None:
            break
        if float(delta @ delta) < DELTA_SQ_TOL:
            break
        e = huber_error(t, src, dst)
        if e > prev_error:
            break
        prev_error = e
        t = Transform.from_twist(delta).compose(t)
    return t


class Icp2d:
    """reference src/lib.rs:91-131 (KdTree -> scipy cKDTree, exact 1-NN)."""

    def __init__(self, dst: np.ndarray):
        self.dst = np.asarray(dst, dtype=np.float64)
        self.tree = cKDTree(self.dst)

    def estimate(
        self, src: np.ndarray, initial: Transform, max_iter: int
    ) -> Transform:
        t = initial
        for _ in range(max_iter):
            src_t = t.apply(src)
            _, idx = self.tree.query(src_t, k=1)
            dt = estimate_transform(src_t, self.dst[idx])
            t = dt.compose(t)
        return t


class Icp3d:
    """reference src/lib.rs:133-174: 3D matching, SE(2)-on-xy solve."""

    def __init__(self, dst: np.ndarray):
        self.dst = np.asarray(dst, dtype=np.float64)
        self.tree = cKDTree(self.dst)

    def estimate(
        self, src: np.ndarray, initial: Transform, max_iter: int
    ) -> Transform:
        t = initial
        for _ in range(max_iter):
            xy = t.apply(src[:, :2])
            src_t = np.column_stack([xy, src[:, 2]])
            _, idx = self.tree.query(src_t, k=1)
            dt = estimate_transform(src_t[:, :2], self.dst[idx][:, :2])
            t = dt.compose(t)
        return t


def run_odometry2d(frames, max_iter: int = 20):
    """reference examples/scan2d.rs:56-115: frame 1 is the fixed src; each
    later frame becomes dst; warm-started estimate; trajectory = T^-1 . t."""
    src = np.asarray(frames[0], dtype=np.float64)
    t = Transform.identity()
    transforms, path = [], []
    for dst in frames[1:]:
        icp = Icp2d(np.asarray(dst, dtype=np.float64))
        t = icp.estimate(src, t, max_iter)
        inv = t.inverse()
        transforms.append(t)
        path.append(inv.t.copy())
    return transforms, np.asarray(path)


def run_odometry3d(frames, max_iter: int = 20):
    """reference examples/scan3d.rs:104-131: same flow with Icp3d."""
    src = np.asarray(frames[0], dtype=np.float64)
    t = Transform.identity()
    transforms, path = [], []
    for dst in frames[1:]:
        icp = Icp3d(np.asarray(dst, dtype=np.float64))
        t = icp.estimate(src, t, max_iter)
        transforms.append(t)
        path.append(t.inverse().t.copy())
    return transforms, np.asarray(path)
