"""Plain reference of the SE(3) pose graph's Gauss-Newton, in PyTorch with
no scatter, no vmap and no kernel, written for any floating dtype.

Poses T_0..T_{P-1} as (rot, t); an edge (i, j, z, info) has the residual

    r = Log(z^-1 T_i^-1 T_j)   in R^6, twist (v, w), t = V(w) v,

and the left update T <- Exp(delta) T.  The Jacobians are forward-mode
derivatives of this module's own residual at delta = 0, twelve batched
directional derivatives (``torch.func.jvp``); the normal equations are
formed densely from the dense Jacobian, H = J^T W J and b = J^T W r, with
W the edges' weighted information blocks.  Pose 0 is held by a 1e8 prior
on its six diagonal entries and 1e-10 I is added, one dense solve an
iteration, the step zeroed once its squared norm fell below ``delta_tol``:
the port's ``pose_graph.optimize(solve="dense")`` rule.  Weights: none
(least squares), or Cauchy 1 / (1 + e2 / k^2) on the information-metric
squared error e2.  Every op runs in the inputs' dtype (float64, or
float32 for the control).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from bench_port.reference.icp import _hat, _small, compose, exp_se3

GAUGE = 1e8
RIDGE = 1e-10


def vee(m: Tensor) -> Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def inverse(rot: Tensor, t: Tensor):
    rt = rot.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def angle(rot: Tensor) -> Tensor:
    """The rotation angle in [0, pi], from both the sine and the cosine."""
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    return torch.atan2(torch.linalg.vector_norm(
        vee(rot - rot.transpose(-1, -2)), dim=-1) / 2, (tr - 1) / 2)


def log_so3(rot: Tensor) -> Tensor:
    """Axis-angle of a rotation.  Below the small angle: 1/2 (1 + th^2/6)
    vee(R - R^T), th^2 from 3 - tr (smooth at the identity); near pi: the
    axis from the symmetric part's largest column."""
    skew = vee(rot - rot.transpose(-1, -2))        # 2 sin(th) axis
    th = angle(rot)
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    small = th < _small(rot.dtype)
    near_pi = th > math.pi - 1e-3
    sin = torch.where(small | near_pi, torch.ones_like(th), torch.sin(th))
    generic = (th / (2 * sin))[..., None] * skew
    taylor = (0.5 + (3 - tr) / 12)[..., None] * skew
    cos = torch.cos(th)[..., None, None]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    one_m = torch.where(near_pi, 1 - torch.cos(th), torch.ones_like(th))
    aat = ((rot + rot.transpose(-1, -2)) / 2 - cos * eye) \
        / one_m[..., None, None]
    col = torch.argmax(torch.diagonal(aat, dim1=-2, dim2=-1), -1)
    axis = torch.take_along_dim(aat, col[..., None, None], -1)[..., 0]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = torch.where((axis * skew).sum(-1, keepdim=True) < 0, -axis, axis)
    out = torch.where(small[..., None], taylor, generic)
    return torch.where(near_pi[..., None], th[..., None] * axis, out)


def log_se3(rot: Tensor, t: Tensor) -> Tensor:
    """Twist (v, w) with t = V(w) v: v = V^-1 t, V^-1 = I - K/2 + D K^2,
    D = (1 - th sin th / (2 (1 - cos th))) / th^2 (1/12 + th^2/720 small)."""
    w = log_so3(rot)
    th2 = (w * w).sum(-1)
    small = th2 < _small(rot.dtype) ** 2
    s2 = torch.where(small, torch.ones_like(th2), th2)
    s1 = torch.sqrt(s2)
    d = torch.where(small, 1.0 / 12 + th2 / 720,
                    (1 - s1 * torch.sin(s1) / (2 * (1 - torch.cos(s1)))) / s2)
    k = _hat(w)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    vinv = eye - k / 2 + d[..., None, None] * (k @ k)
    return torch.cat([(vinv @ t[..., None])[..., 0], w], -1)


def residuals(rot: Tensor, t: Tensor, graph: dict, di: Tensor, dj: Tensor):
    """(E, 6): Log(z^-1 (Exp(di) T_i)^-1 (Exp(dj) T_j)) for every edge."""
    i, j = graph["edge_i"], graph["edge_j"]
    ri, ti = compose(*exp_se3(di), rot[i], t[i])
    rj, tj = compose(*exp_se3(dj), rot[j], t[j])
    rel = compose(*inverse(ri, ti), rj, tj)
    return log_se3(*compose(*inverse(graph["meas_rot"], graph["meas_t"]),
                            *rel))


def linearize(rot: Tensor, t: Tensor, graph: dict):
    """Residuals (E, 6) and their Jacobians wrt di and dj, (E, 6, 6) each,
    at delta = 0: one batched directional derivative a twist component."""
    e = graph["edge_i"].shape[0]
    zero = torch.zeros((e, 6), dtype=rot.dtype, device=rot.device)

    def f(di, dj):
        return residuals(rot, t, graph, di, dj)

    cols = []
    for k in range(12):
        tan = torch.zeros((e, 12), dtype=rot.dtype, device=rot.device)
        tan[:, k] = 1
        r, d = torch.func.jvp(f, (zero, zero), (tan[:, :6], tan[:, 6:]))
        cols.append(d)
    jac = torch.stack(cols, -1)
    return r, jac[..., :6], jac[..., 6:]


def weights(r: Tensor, info: Tensor, cauchy_k) -> Tensor:
    if cauchy_k is None:
        return torch.ones_like(r[:, 0])
    e2 = (r[:, None, :] @ info @ r[:, :, None])[:, 0, 0]
    return 1 / (1 + e2 / (cauchy_k * cauchy_k))


def step(rot: Tensor, t: Tensor, graph: dict, cauchy_k) -> Tensor:
    """The Gauss-Newton step (P, 6) from poses (rot, t)."""
    r, ji, jj = linearize(rot, t, graph)
    e, p = r.shape[0], rot.shape[0]
    jac = torch.zeros((e, 6, p, 6), dtype=r.dtype, device=r.device)
    rows = torch.arange(e, device=r.device)
    jac[rows, :, graph["edge_i"], :] = ji
    jac[rows, :, graph["edge_j"], :] += jj
    jac = jac.reshape(e, 6, 6 * p)
    wi = weights(r, graph["info"], cauchy_k)[:, None, None] * graph["info"]
    h = jac.reshape(6 * e, 6 * p).T @ (wi @ jac).reshape(6 * e, 6 * p)
    b = jac.reshape(6 * e, 6 * p).T @ (wi @ r[..., None]).reshape(6 * e)
    del jac
    h.diagonal()[:6] += GAUGE
    h.diagonal().add_(RIDGE)
    return -torch.linalg.solve(h, b).reshape(p, 6)


def robust_k(cfg: dict):
    """The Cauchy scale of the configuration's objective, or None for
    least squares (the kernels this reference knows)."""
    k = cfg.get("huber_k")
    if k is not None and cfg.get("kernel") != "cauchy":
        raise ValueError("the reference knows least squares and Cauchy")
    return k


def solve(graph: dict, rot: Tensor, t: Tensor, cfg: dict,
          delta_tol: float = 1e-10):
    """Gauss-Newton from (rot, t) for ``cfg["iters"]`` iterations at most,
    stopping after the first step whose squared norm is below
    ``delta_tol``; returns (rot, t)."""
    k = robust_k(cfg)
    for _ in range(cfg["iters"]):
        delta = step(rot, t, graph, k)
        rot, t = compose(*exp_se3(delta), rot, t)
        if float((delta * delta).sum()) < delta_tol:
            break
    return rot, t
