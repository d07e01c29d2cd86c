"""SE(3) point-to-plane ICP with estimated normals (BASELINE configs[1];
JAX package ``models/icp_p2l.py``).

The reference's 3D mode is planar SE(2) (src/lib.rs:133-174); this is the
build's full 6-DoF config.  The flow is the reference's scan matcher: up to
``outer_iters`` outer iterations, each transforming the source cloud,
finding exact 1-NN correspondences in the destination and running the
robust inner loop, here against the destination's tangent planes (normals
computed once per call, by voxel PCA by default).  The outer loop exits
bit-exactly at its fixed point, as the 2D drivers' does.

Per outer iteration on the kernel route, one pair: one survivor-list NN
launch (``nn_list``, D = 3 with the 4-lane payload [n, c = n . q]) and one
``p2l_loop`` launch.  A batch of pairs (the JAX driver's ``(..., N, 3)``):
one pair-grid NN launch for dbs of at most 4,096 points (``nn_pairs`` on
the cold iteration, ``nn_pairs_list`` on every warm one); above, one
``nn_matched`` launch on the cold iteration and, where the dbs span 3
tiles, one seed-pruned ``nn_pairs`` launch on every warm one; and the
plain batched inner loop (``align3d._loop_torch``), the JAX package's own
route for a batch.

The entry point runs on ``device`` ("cuda" by default); with no card it
raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.driver import ICPStats, fixed_point, \
    outer_step, prepare, sort_pair, unflatten, unscale_transform
from icp_rust_tpu_torch.ops import align3d, huber, nn
from icp_rust_tpu_torch.ops.normals import (
    estimate_normals,
    estimate_normals_voxel,
)
from icp_rust_tpu_torch.utils.profiling import annotate

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


def _check_pair_shapes(src, dst):
    if (src.ndim < 2 or dst.ndim != src.ndim or src.shape[-1] != 3
            or dst.shape[-1] != 3 or src.shape[:-2] != dst.shape[:-2]):
        raise ValueError(
            "icp_point_to_plane takes src (..., N, 3) and dst (..., M, 3) "
            f"with the same batch axes; got {tuple(src.shape)}, "
            f"{tuple(dst.shape)}")


def icp_point_to_plane(src, dst, src_mask, dst_mask,
                       initial_transform: RigidTransform3,
                       config: ICPConfig = ICPConfig(), normals_k: int = 8,
                       dst_normals=None, normals_method: str = "voxel",
                       normals_voxel_size: float = 0.3,
                       return_stats: bool = False,
                       src_presorted: bool = False, device="cuda"):
    """src (..., N, 3), dst (..., M, 3), masks over the point axes: one
    scan pair, or a batch of pairs with (...)-batched (or one shared) warm
    starts.  Returns the SE(3) transform taking src to dst; with
    ``return_stats`` (transform, ICPStats), one value per pair.

    ``dst_normals`` (..., M, 3) reuses precomputed normals (all taken as
    valid where dst_mask is).  ``normals_method="voxel"`` (voxel PCA at
    ``normals_voxel_size``, the path every published number uses, per
    pair) or ``"knn"`` (per-point ``normals_k``-neighbour PCA, an O(N M)
    sweep).  ``src_presorted``: src already permuted by
    ``models.driver.presort_src`` (bitwise-identical hoist of the
    loop-invariant sort).

    A batch runs in lockstep, as the JAX package's does: every outer
    iteration searches every pair at once (the pair-grid kernels for dbs
    of at most 4,096 points; above, kernel 4 cold and kernel 8's seed
    prune warm, ``ops/nn.route``) and solves them with the
    plain batched inner loop, a pair at its fixed point stays unchanged,
    and the loop exits when all are fixed; the stats give every pair the
    loop's count."""
    with annotate("icp.icp_point_to_plane"):
        if normals_method not in NORMALS_METHODS:
            raise ValueError("normals_method must be one of "
                             f"{NORMALS_METHODS}, got {normals_method!r}")
        src, dst, src_mask, dst_mask, t0, batch, dst_normals = prepare(
            src, dst, src_mask, dst_mask, initial_transform, config, device,
            check=_check_pair_shapes, dst_extra=dst_normals)
        s = config.point_scale

        # The residual sees the matched point q only through c = n . q, so
        # the NN carries [n, c]: 4 payload lanes.
        route = nn.route(src, dst, 4, config)
        given = () if dst_normals is None else (dst_normals, dst_mask)
        src, src_mask, dst, dst_mask, given = sort_pair(
            route.sort, src, src_mask, dst, dst_mask, src_presorted, given)
        if given:
            normals, n_valid = given
        else:
            with annotate("icp.normals"):
                if normals_method == "voxel":
                    normals, n_valid = estimate_normals_voxel(
                        dst, dst_mask, normals_voxel_size / s)
                else:
                    normals, n_valid = estimate_normals(
                        dst, dst_mask, k=normals_k, tile=config.nn_dst_tile)
        index = nn.NNIndex(route, dst, dst_mask,
                           build_p2l_payload(dst, normals, n_valid, dst_mask),
                           config)

        def place(t):
            src_t = t.apply_points(src)
            return src_t, src_t

        def solve(src_t, res, pay):
            matched_n, matched, matched_ok = decode_p2l_payload(pay,
                                                                res.dist_sq)
            return align3d.estimate_transform_p2l(
                src_t, matched, matched_n, src_mask & matched_ok,
                config), pay

        aux0 = (torch.full(src.shape[:-1], float("inf"), dtype=src.dtype,
                           device=src.device),
                src, torch.zeros((*src.shape[:-1], 4), dtype=src.dtype,
                                 device=src.device))
        t, it, aux, _ = fixed_point(outer_step(index, place, solve), t0,
                                    config.outer_iters, aux0)
        t = unscale_transform(t, s)
        if return_stats:
            return unflatten((t, _stats_p2l(aux, src_mask, config, it)),
                             batch)
        return unflatten(t, batch)
