"""Plain reference of the two ICP semantics the cells drive, in PyTorch
with no kernel, no cache and no spatial sort, batched over pairs and
written for any floating dtype.

- 2D point-to-point (tier4/icp_rust src/lib.rs:59-131; the crate's robust
  IRLS with per-dimension MAD sigma and Huber weights, its stop conditions
  in its order, exact 1-NN).
- SE(3) point-to-plane (the build's 6-DoF configuration): the destination's
  tangent planes by voxel PCA, exact 1-NN, the scalar residual
  n . (T(s) - q) with the same robust machinery and a gated 6x6 solve.

Both outer loops exit at the exact fixed point (an inner loop that returns
the identity), which is bit-exact with running every outer iteration.

``first_step_*`` is what judges an answer: the robust Gauss-Newton update
that the reference's next outer iteration would take from it, with the
reference's own correspondences and normals.  At an ICP answer that update
is below the inner loop's tolerance; its norm says how far the answer is
from one.

Precision: every elementwise op and reduction runs in the inputs' dtype.
torch has no bfloat16 or float16 linear algebra, so at those dtypes the
3x3 eigen-decompositions and the 6x6 solves run in float32 and their
results are rounded back.
"""

from __future__ import annotations

import torch
from torch import Tensor

LOW = (torch.bfloat16, torch.float16)


def _hi(x: Tensor) -> Tensor:
    return x.float() if x.dtype in LOW else x


# --- robust statistics (the crate's src/stats.rs, src/huber.rs) ----------

def masked_median(x: Tensor, mask: Tensor):
    """Median over the last axis of the masked lanes; an even count averages
    the two central order statistics.  Returns (median, any lane)."""
    n = mask.sum(-1)
    xs = torch.where(mask, x, torch.full_like(x, float("inf"))).sort(-1)[0]
    hi = torch.clamp(n // 2, max=x.shape[-1] - 1)
    lo = torch.where(n % 2 == 1, hi, torch.clamp(n // 2 - 1, min=0))
    a = torch.gather(xs, -1, lo[..., None])[..., 0]
    b = torch.gather(xs, -1, hi[..., None])[..., 0]
    med = torch.where(n % 2 == 1, a, (a + b) / 2)
    return torch.where(n > 0, med, torch.zeros_like(med)), n > 0


def mad_sigma(x: Tensor, mask: Tensor, mad_scale: float):
    med, ok = masked_median(x, mask)
    mad, _ = masked_median(torch.abs(x - med[..., None]), mask)
    return mad_scale * mad, ok


def rho(e: Tensor, k: float) -> Tensor:
    return torch.where(e <= k * k, e,
                       2.0 * k * torch.sqrt(torch.clamp(e, min=0)) - k * k)


def drho(e: Tensor, k: float) -> Tensor:
    tiny = torch.finfo(e.dtype).tiny
    return torch.where(e <= k * k, torch.ones_like(e),
                       k / torch.sqrt(torch.clamp(e, min=tiny)))


# --- exact nearest neighbour ----------------------------------------------

def nearest(query: Tensor, db: Tensor, db_mask: Tensor,
            block_elems: int = 1 << 26):
    """Exact 1-NN by brute force, per pair: query (B, Q, D), db (B, M, D),
    db_mask (B, M).  Distances are summed per coordinate in the inputs'
    dtype; ties take the lower db index.  Returns (squared distance (B, Q),
    index (B, Q)); +inf where a pair has no valid db point."""
    b, q, d = query.shape
    m = db.shape[1]
    bq = max(1, min(q, block_elems // max(m, 1)))
    dist = torch.empty((b, q), dtype=query.dtype, device=query.device)
    idx = torch.empty((b, q), dtype=torch.long, device=query.device)
    for i in range(b):
        dbt = db[i].t()
        for s in range(0, q, bq):
            qq = query[i, s:s + bq]
            acc = (qq[:, 0, None] - dbt[0][None, :]) ** 2
            for k in range(1, d):
                acc = acc + (qq[:, k, None] - dbt[k][None, :]) ** 2
            acc.masked_fill_(~db_mask[i][None, :], float("inf"))
            dist[i, s:s + bq], idx[i, s:s + bq] = acc.min(-1)
    return dist, idx


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """Rows of x (B, M, K) at idx (B, Q)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


# --- rigid transforms -------------------------------------------------------

def apply(rot: Tensor, t: Tensor, pts: Tensor) -> Tensor:
    return pts @ rot.transpose(-1, -2) + t[..., None, :]


def compose(ra: Tensor, ta: Tensor, rb: Tensor, tb: Tensor):
    """a o b."""
    return ra @ rb, (ra @ tb[..., None])[..., 0] + ta


def identity(batch: int, d: int, like: Tensor):
    rot = torch.eye(d, dtype=like.dtype, device=like.device).expand(
        batch, d, d).clone()
    return rot, torch.zeros((batch, d), dtype=like.dtype, device=like.device)


def _small(dtype) -> float:
    return float(torch.finfo(dtype).eps) ** 0.25


def exp_se2(delta: Tensor):
    """Twist (vx, vy, theta) -> (rot, t); translation through V."""
    vx, vy, th = delta[..., 0], delta[..., 1], delta[..., 2]
    small = torch.abs(th) < _small(th.dtype)
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th * th / 6, torch.sin(safe) / safe)
    b = torch.where(small, th / 2 - th * th * th / 24,
                    (1 - torch.cos(safe)) / safe)
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return rot, torch.stack([a * vx - b * vy, b * vx + a * vy], -1)


def _hat(w: Tensor) -> Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(delta: Tensor):
    """Twist (v, w) -> (rot, t): Rodrigues, translation through V."""
    v, w = delta[..., :3], delta[..., 3:]
    th2 = torch.sum(w * w, -1)
    th = torch.sqrt(th2)
    small = th < _small(w.dtype)
    s2 = torch.where(small, torch.ones_like(th2), th2)
    s1 = torch.sqrt(s2)
    a = torch.where(small, 1 - th2 / 6, torch.sin(s1) / s1)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(s1)) / s2)
    c = torch.where(small, 1.0 / 6 - th2 / 120, (s1 - torch.sin(s1)) / (s2 * s1))
    k = _hat(w)
    k2 = k @ k
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    rot = eye + a[..., None, None] * k + b[..., None, None] * k2
    vm = eye + b[..., None, None] * k + c[..., None, None] * k2
    return rot, (vm @ v[..., None])[..., 0]


def _is_identity(rot: Tensor, t: Tensor) -> Tensor:
    eye = torch.eye(rot.shape[-1], dtype=rot.dtype, device=rot.device)
    return (rot == eye).flatten(-2).all(-1) & (t == 0).all(-1)


# --- robust Gauss-Newton updates -------------------------------------------

def _inverse3x3(m: Tensor, det_rel_eps: float):
    """Adjugate inverse with the relative determinant gate; (inv, ok)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    if det_rel_eps > 0:
        scale = torch.amax(torch.abs(m), dim=(-1, -2))
        ok = torch.abs(det) > det_rel_eps * scale ** 3
    else:
        ok = det != 0
    safe = torch.where(ok, det, torch.ones_like(det))
    return adj / safe[..., None, None], ok


def gn_update_2d(rot, t, src, dst, mask, p: dict):
    """The crate's weighted_gauss_newton_update (src/lib.rs:218-261) at
    (rot, t): (delta (B, 3), ok (B,), Huber error at (rot, t) (B,))."""
    k = p["huber_k"]
    r = apply(rot, t, src) - dst
    sig, valid = mad_sigma(r.transpose(-1, -2), mask[:, None, :].expand(
        -1, 2, -1), p["mad_scale"])
    valid = valid[:, 0]
    g = torch.where(sig != 0, 1 / torch.where(sig != 0, sig,
                                               torch.ones_like(sig)),
                    torch.zeros_like(sig))
    maskf = mask.to(r.dtype)
    u = drho(r * r, k) * g[:, None, :] * maskf[..., None]
    arm = torch.stack([-src[..., 1], src[..., 0]], -1) @ rot.transpose(-1, -2)
    jac = torch.cat([rot[:, None].expand(-1, src.shape[1], 2, 2),
                     arm[..., None]], -1)
    jtr = torch.einsum("bni,bnik,bni->bk", u, jac, r)
    jtj = torch.einsum("bni,bnik,bnil->bkl", u, jac, jac)
    err = torch.sum(rho(torch.sum(r * r, -1), k) * maskf, -1)
    inv, ok = _inverse3x3(jtj, p["det_rel_eps"])
    ok = ok & (mask.sum(-1) >= 2) & valid
    delta = -(inv @ jtr[..., None])[..., 0]
    return torch.where(ok[:, None], delta, torch.zeros_like(delta)), ok, err


def _solve6(jtj: Tensor, jtr: Tensor, n_ok: Tensor):
    """LU solve with a finite and back-substitution residual gate."""
    a, b = _hi(jtj), _hi(jtr)
    eye = torch.eye(6, dtype=a.dtype, device=a.device)
    a = torch.where(n_ok[:, None, None], a, eye)
    x = torch.linalg.solve_ex(a, b[..., None])[0][..., 0]
    back = (a @ x[..., None])[..., 0]
    scale = torch.amax(torch.abs(b), -1, keepdim=True)
    ok = (n_ok & torch.isfinite(x).all(-1)
          & (torch.abs(back - b) <= 1e-3 * torch.clamp(scale, min=1e-30)
             + 1e-20).all(-1))
    return x.to(jtj.dtype), ok


def gn_update_p2l(rot, t, src, q, nrm, mask, p: dict):
    """One robust point-to-plane update at (rot, t): residual n . (T(s) - q),
    MAD sigma, Huber weights, J = [n, T(s) x n]; (delta (B, 6), ok, err)."""
    k = p["huber_k"]
    pts = apply(rot, t, src)
    r = torch.sum((pts - q) * nrm, -1)
    sig, valid = mad_sigma(r, mask, p["mad_scale"])
    g = torch.where(sig != 0, 1 / torch.where(sig != 0, sig,
                                               torch.ones_like(sig)),
                    torch.zeros_like(sig))
    maskf = mask.to(r.dtype)
    u = drho(r * r, k) * g[:, None] * maskf
    jac = torch.cat([nrm, torch.linalg.cross(pts, nrm, dim=-1)], -1)
    jtr = torch.einsum("bn,bnk,bn->bk", u, jac, r)
    jtj = torch.einsum("bn,bnk,bnl->bkl", u, jac, jac)
    err = torch.sum(rho(r * r, k) * maskf, -1)
    x, ok = _solve6(jtj, jtr, mask.sum(-1) >= 6)
    ok = ok & valid & (sig != 0)
    return torch.where(ok[:, None], -x, torch.zeros_like(x)), ok, err


def _inner(update, exp, src, mask, d: int, p: dict, *args):
    """The inner loop from identity with the crate's stop conditions in its
    order (src/lib.rs:59-84); a lane freezes when it stops."""
    bsz = src.shape[0]
    rot, t = identity(bsz, d, src)
    prev = torch.full((bsz,), torch.finfo(src.dtype).max, dtype=src.dtype,
                      device=src.device)
    done = torch.zeros(bsz, dtype=torch.bool, device=src.device)
    for _ in range(p["inner_max_iter"]):
        if bool(done.all()):
            break
        delta, ok, err = update(rot, t, src, *args, mask, p)
        stop = ~ok | (torch.sum(delta * delta, -1) < p["inner_delta_sq_tol"])
        stop = done | stop | (err > prev)
        r2, t2 = compose(*exp(delta), rot, t)
        rot = torch.where(stop[:, None, None], rot, r2)
        t = torch.where(stop[:, None], t, t2)
        prev = torch.where(stop, prev, err)
        done = stop
    return rot, t


# --- voxel normals -----------------------------------------------------------

def voxel_normals(points: Tensor, mask: Tensor, voxel: float,
                  min_points: int = 3, planarity_eps: float = 2e-3,
                  cells: int = 1024):
    """Per-point unit normals from per-voxel covariance PCA, each cloud on
    its own grid from its minimum corner: (normals (B, N, 3), valid (B,
    N)).  A point is valid where its voxel holds ``min_points`` or more,
    lies within ``cells`` voxels of the corner, and is planar (middle
    eigenvalue above ``planarity_eps`` times the largest).  Normals face
    the sensor origin."""
    bsz, n, _ = points.shape
    dt, dev = points.dtype, points.device
    lo = torch.where(mask[..., None], points,
                     torch.full_like(points, float("inf"))).amin(1, True)
    vs = torch.tensor(voxel, dtype=dt, device=dev)
    cell = torch.floor((points - lo) / vs)
    ok = mask & ((cell >= 0) & (cell < cells)).all(-1)
    cl = torch.clamp(cell, 0, cells - 1).long()
    key = ((torch.arange(bsz, device=dev)[:, None] * cells + cl[..., 0])
           * cells + cl[..., 1]) * cells + cl[..., 2]
    local = points - (lo + cell * voxel)
    uniq, inv = torch.unique(key[ok], return_inverse=True)
    loc = local[ok]
    rows = torch.cat([torch.ones_like(loc[:, :1]), loc,
                      loc[:, [0, 1, 2, 0, 0, 1]] * loc[:, [0, 1, 2, 1, 2, 2]]],
                     -1)
    acc = torch.zeros((len(uniq), 10), dtype=dt, device=dev).index_add_(
        0, inv, rows)
    cnt = acc[:, 0]
    c = torch.clamp(cnt, min=1)
    mean = acc[:, 1:4] / c[:, None]
    m2 = acc[:, 4:10] / c[:, None]
    xx, yy, zz, xy, xz, yz = (m2[:, j] - mean[:, a] * mean[:, b]
                              for j, (a, b) in enumerate(
                                  [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                   (1, 2)]))
    cov = torch.stack([torch.stack([xx, xy, xz], -1),
                       torch.stack([xy, yy, yz], -1),
                       torch.stack([xz, yz, zz], -1)], -2)
    # On the host: cuSOLVER's batched eigh refuses ~10^5 matrices at once.
    ev, vec = torch.linalg.eigh(_hi(cov).cpu())
    ev, vec = ev.to(dev), vec.to(dev)
    tiny = torch.finfo(ev.dtype).tiny
    vok = (cnt >= min_points) & (ev[:, 1] > planarity_eps
                                 * torch.clamp(ev[:, 2], min=tiny))
    normals = torch.zeros_like(points)
    valid = torch.zeros_like(mask)
    normals[ok] = vec[:, :, 0].to(dt)[inv]
    valid[ok] = vok[inv]
    sign = torch.sign(torch.sum(normals * -points, -1, keepdim=True))
    return normals * torch.where(sign == 0, torch.ones_like(sign), sign), \
        valid


# --- outer loops and the judges ---------------------------------------------

def _match_2d(rot, t, src, dst, dmask):
    src_t = apply(rot, t, src)
    dist, idx = nearest(src_t, dst, dmask)
    return src_t, _take(dst, idx), torch.isfinite(dist)


def _match_p2l(rot, t, src, dst, dmask, nrm, nvalid):
    src_t = apply(rot, t, src)
    dist, idx = nearest(src_t, dst, dmask)
    ok = torch.isfinite(dist) & torch.gather(nvalid, 1, idx)
    return src_t, _take(dst, idx), _take(nrm, idx), ok


def icp_2d(rot, t, src, smask, dst, dmask, p: dict):
    """The crate's Icp2d::estimate from (rot, t), with the exact
    fixed-point exit, per pair."""
    fixed = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    for _ in range(p["outer_iters"]):
        src_t, q, ok = _match_2d(rot, t, src, dst, dmask)
        dr, dtr = _inner(gn_update_2d, exp_se2, src_t, smask & ok, 2, p, q)
        fixed = fixed | _is_identity(dr, dtr)
        r2, t2 = compose(dr, dtr, rot, t)
        rot = torch.where(fixed[:, None, None], rot, r2)
        t = torch.where(fixed[:, None], t, t2)
        if bool(fixed.all()):
            break
    return rot, t


def icp_p2l(rot, t, src, smask, dst, dmask, p: dict, voxel: float):
    """Point-to-plane ICP from (rot, t) against dst's voxel normals, with
    the exact fixed-point exit, per pair."""
    nrm, nvalid = voxel_normals(dst, dmask, voxel)
    fixed = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    for _ in range(p["outer_iters"]):
        src_t, q, qn, ok = _match_p2l(rot, t, src, dst, dmask, nrm, nvalid)
        dr, dtr = _inner(gn_update_p2l, exp_se3, src_t, smask & ok, 3, p, q,
                         qn)
        fixed = fixed | _is_identity(dr, dtr)
        r2, t2 = compose(dr, dtr, rot, t)
        rot = torch.where(fixed[:, None, None], rot, r2)
        t = torch.where(fixed[:, None], t, t2)
        if bool(fixed.all()):
            break
    return rot, t


def _norm(delta: Tensor, ok: Tensor) -> Tensor:
    """|delta| (the inner loop's tolerance is on its square); inf where the
    update is refused (too few matches, a singular system)."""
    n = torch.sqrt(torch.sum(delta * delta, -1))
    return torch.where(ok, n, torch.full_like(n, float("inf")))


def first_step_2d(rot, t, src, smask, dst, dmask, p: dict) -> Tensor:
    """Per answer (rot, t): |the reference's next robust GN update|."""
    src_t, q, ok = _match_2d(rot, t, src, dst, dmask)
    r0, t0 = identity(src.shape[0], 2, src)
    delta, good, _ = gn_update_2d(r0, t0, src_t, q, smask & ok, p)
    return _norm(delta, good)


def first_step_p2l(rot, t, src, smask, dst, dmask, p: dict,
                   normals) -> Tensor:
    """Per answer (rot, t): |the reference's next robust point-to-plane
    update|; ``normals`` = voxel_normals(dst, dmask, voxel)."""
    src_t, q, qn, ok = _match_p2l(rot, t, src, dst, dmask, *normals)
    r0, t0 = identity(src.shape[0], 3, src)
    delta, good, _ = gn_update_p2l(r0, t0, src_t, q, qn, smask & ok, p)
    return _norm(delta, good)
