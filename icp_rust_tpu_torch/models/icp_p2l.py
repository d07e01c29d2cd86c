"""SE(3) point-to-plane ICP with estimated normals (BASELINE configs[1];
JAX package ``models/icp_p2l.py``).

The reference's 3D mode is planar SE(2) (src/lib.rs:133-174); this is the
build's full 6-DoF config.  The flow is the reference's scan matcher: up to
``outer_iters`` outer iterations, each transforming the source cloud,
finding exact 1-NN correspondences in the destination and running the
robust inner loop, here against the destination's tangent planes (normals
computed once per call, by voxel PCA by default).  The outer loop exits
bit-exactly at its fixed point, as the 2D drivers' does.

Per outer iteration on the kernel route: one survivor-list NN launch
(``nn_list``, D = 3 with the 4-lane payload [n, c = n . q]) and one
``p2l_loop`` launch.

The entry point runs on ``device`` ("cuda" by default); with no card it
raises unless the caller passes ``device="cpu"``.  It takes one scan pair
(``models/slam.run_slam3d`` calls it pair by pair); a batch raises.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.icp2d import (
    ICPStats,
    _is_identity,
    _outer_fixed_point,
    _scaled,
    _sort_enabled,
    _spatial_sort,
)
from icp_rust_tpu_torch.ops import align3d, huber
from icp_rust_tpu_torch.ops.nn import build_db_pack, nearest_neighbor_matched
from icp_rust_tpu_torch.ops.normals import (
    estimate_normals,
    estimate_normals_voxel,
)

# Plane-offset payload protocol: the NN carry holds [n (3), c = n . q]
# with invalidity folded into c as an unreachable sentinel (|c| <= |q| <=
# scene size after point_scale, so 1e18 is unreachable for data).
_C_INVALID = 3e19
_C_VALID_MAX = 1e18
NORMALS_METHODS = ("voxel", "knn")


def build_p2l_payload(dst: Tensor, normals: Tensor, n_valid: Tensor,
                      dst_mask: Tensor) -> Tensor:
    """[normal (3), plane offset c (1)] rows; invalid rows get the
    sentinel c."""
    c = torch.sum(dst * normals, dim=-1)
    c = torch.where(n_valid & dst_mask, c, torch.full_like(c, _C_INVALID))
    return torch.cat([normals, c[..., None]], dim=-1)


def decode_p2l_payload(pay: Tensor, dist_sq: Tensor | None = None):
    """(matched_n, matched plane foot point d = c n, matched_ok).

    n . (p - d) = n . p - c for a unit n: the same residual as against the
    true matched point.  With the NN ``dist_sq``, a query that saw no
    valid candidate (+inf distance, zero payload) is not decoded as a
    valid zero-normal match."""
    matched_n = pay[..., 0:3]
    c_m = pay[..., 3]
    matched_ok = torch.abs(c_m) < _C_VALID_MAX
    if dist_sq is not None:
        matched_ok = matched_ok & torch.isfinite(dist_sq)
    matched = matched_n * torch.where(matched_ok, c_m,
                                      torch.zeros_like(c_m))[..., None]
    return matched_n, matched, matched_ok


def _stats_p2l(aux, src_mask, config: ICPConfig, it: int) -> ICPStats:
    """Final-transform metrics from the last outer iteration's
    correspondences (exact at the returned transform on a fixed-point
    exit; no extra NN sweep)."""
    dist_sq, src_t, pay = aux
    s = config.point_scale
    matched_n, matched, matched_ok = decode_p2l_payload(pay, dist_sq)
    maskf = (src_mask & matched_ok).to(src_t.dtype)
    nf = torch.clamp(torch.sum(maskf, dim=-1), min=1.0)
    r = torch.sum((src_t - matched) * matched_n, dim=-1)
    k = config.huber_k / s
    mean_nn = torch.sum(torch.sqrt(torch.clamp(dist_sq, min=0.0)) * maskf,
                        dim=-1) / nf * s
    return ICPStats(
        outer_iters=torch.full(nf.shape, it, dtype=torch.int32,
                               device=nf.device),
        huber_error=torch.sum(huber.rho(r * r, k) * maskf, dim=-1),
        mean_nn_dist=mean_nn,
        inlier_fraction=torch.sum((torch.abs(r) <= k) * maskf, dim=-1) / nf,
    )


def icp_point_to_plane(src, dst, src_mask, dst_mask,
                       initial_transform: RigidTransform3,
                       config: ICPConfig = ICPConfig(), normals_k: int = 8,
                       dst_normals=None, normals_method: str = "voxel",
                       normals_voxel_size: float = 0.3,
                       return_stats: bool = False,
                       src_presorted: bool = False, device="cuda"):
    """src (N, 3), dst (M, 3), masks over the point axes.  Returns the SE(3)
    transform taking src to dst; with ``return_stats`` (transform,
    ICPStats).

    ``dst_normals`` reuses precomputed normals (all taken as valid where
    dst_mask is).  ``normals_method="voxel"`` (voxel PCA at
    ``normals_voxel_size``, the path every published number uses) or
    ``"knn"`` (per-point ``normals_k``-neighbour PCA, an O(N M) sweep).
    ``src_presorted``: src already permuted by ``models.icp2d.presort_src``
    (bitwise-identical hoist of the loop-invariant sort)."""
    if normals_method not in NORMALS_METHODS:
        raise ValueError(f"normals_method must be one of {NORMALS_METHODS}, "
                         f"got {normals_method!r}")
    dt = config.compute_dtype
    dev = resolve_device(device, dt)
    src = torch.as_tensor(src).to(device=dev, dtype=dt)
    dst = torch.as_tensor(dst).to(device=dev, dtype=dt)
    if src.ndim != 2 or dst.ndim != 2 or src.shape[-1] != 3 \
            or dst.shape[-1] != 3:
        raise NotImplementedError(
            f"icp_point_to_plane takes one scan pair, src (N, 3) and dst "
            f"(M, 3); got {tuple(src.shape)}, {tuple(dst.shape)}.  A "
            "batched point-to-plane call is not ported (no path of the "
            "port needs it; run_slam3d aligns one pair at a time)")
    src_mask = torch.as_tensor(src_mask).to(device=dev, dtype=torch.bool)
    dst_mask = torch.as_tensor(dst_mask).to(device=dev, dtype=torch.bool)
    s = config.point_scale
    src = _scaled(src, config)
    dst = _scaled(dst, config)
    t0 = initial_transform.astype(dt).to(dev)
    if s != 1.0:
        t0 = RigidTransform3(t0.rot, t0.t / s)

    sort = _sort_enabled(src, dst, config)
    if sort and not src_presorted:
        src, src_mask, _ = _spatial_sort(src, src_mask, method=sort)
    if dst_normals is None:
        if sort:
            dst, dst_mask, _ = _spatial_sort(dst, dst_mask, method=sort)
        if normals_method == "voxel":
            normals, n_valid = estimate_normals_voxel(
                dst, dst_mask, normals_voxel_size / s)
        else:
            normals, n_valid = estimate_normals(dst, dst_mask, k=normals_k,
                                                tile=config.nn_dst_tile)
    else:
        normals = torch.as_tensor(dst_normals).to(device=dev, dtype=dt)
        n_valid = dst_mask
        if sort:
            dst, dst_mask, (normals, n_valid) = _spatial_sort(
                dst, dst_mask, (normals, n_valid), method=sort)

    # The residual sees the matched point q only through c = n . q, so the
    # NN carries [n, c]: 4 payload lanes.  The db is packed once per call
    # (the KdTree-build analogue).
    payload = build_p2l_payload(dst, normals, n_valid, dst_mask)
    db_pack = build_db_pack(src, dst, dst_mask, payload=payload,
                            backend=config.nn_backend,
                            tile=config.nn_dst_tile)
    eps = torch.finfo(dt).eps

    def make_outer(warm):
        def outer(t, aux):
            prev_d2, prev_q = aux[0], aux[1]
            src_t = t.apply_points(src)
            # dist_prev + |dq| bounds the new NN distance (the db is fixed
            # across outer iterations); 32 eps keeps it an upper bound
            # after the sqrt/square round trip.  3D: every coordinate
            # moves.
            move = torch.linalg.norm(src_t - prev_q, dim=-1)
            qb = (torch.sqrt(prev_d2) + move) ** 2 * (1.0 + 32.0 * eps)
            res, pay = nearest_neighbor_matched(
                src_t, dst, dst_mask, payload=payload,
                backend=config.nn_backend, tile=config.nn_dst_tile,
                q_tile=config.nn_query_tile, q_bound=qb, db_pack=db_pack,
                warm=warm)
            matched_n, matched, matched_ok = decode_p2l_payload(
                pay, res.dist_sq)
            dt_ = align3d.estimate_transform_p2l(
                src_t, matched, matched_n, src_mask & matched_ok, config)
            return dt_.compose(t), _is_identity(dt_), (res.dist_sq, src_t,
                                                       pay)
        return outer

    aux0 = (torch.full(src.shape[:-1], float("inf"), dtype=dt, device=dev),
            src, torch.zeros((*src.shape[:-1], 4), dtype=dt, device=dev))
    t, it, aux, _ = _outer_fixed_point(make_outer(True), t0,
                                       config.outer_iters, aux0,
                                       first_step=make_outer(False))
    if s != 1.0:
        t = RigidTransform3(t.rot, t.t * s)
    if return_stats:
        return t, _stats_p2l(aux, src_mask, config, it)
    return t
