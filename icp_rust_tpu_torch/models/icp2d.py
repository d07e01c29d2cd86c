"""Scan-to-scan ICP drivers (2D, and 3D with planar motion).

Behavioral parity with reference src/lib.rs:

- ``icp2d`` = Icp2d::estimate (src/lib.rs:91-131): up to ``outer_iters``
  iterations, each (1) transforming all src points by the current T,
  (2) finding the exact 1-NN of each in dst, (3) ``estimate_transform`` on
  (transformed src, matched dst), (4) left-composing T <- dT o T.
- ``icp3d_planar`` = Icp3d::estimate (src/lib.rs:133-174): correspondences
  in 3D, optimization on the xy projection, z untouched.

The outer loop exits early at the fixed point: when an iteration returns
dT == identity bitwise, every later iteration would repeat it exactly, so
the exit is bit-exact with running all ``outer_iters``.

Coordinates are divided by config.point_scale on entry and the result's
translation is rescaled on exit (exact with huber_k co-scaled).

Both drivers take one scan pair or a batch of B pairs: src (B, N, D)
against dst (B, M, D), or against one shared dst (M, D), with (B,)-batched
warm starts; more batch axes are flattened into the one pair axis and
restored on the result.  A batch runs in lockstep: each outer iteration
searches and solves every pair at once (the pair-grid NN kernels and the
batched IRLS kernel), a lane at its fixed point stays bitwise unchanged,
and the loop exits when all lanes are fixed.  With
``frame_backend="pairs"`` a batched ``icp2d`` runs instead as one
pair-frame kernel launch, each pair to its own fixed point.

Entry points run on ``device`` ("cuda" by default); with no card they
raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, huber
from icp_rust_tpu_torch.ops.nn import (
    build_db_pack,
    nearest_neighbor_matched,
    spatial_order,
    use_cuda_nn,
    use_pairs_nn,
)
from icp_rust_tpu_torch.utils.profiling import annotate

# Chunk of the pair-grid NN kernels: a batched db sorts from 3 chunks up.
_PAIRS_CHUNK = 128


def _scaled(x: Tensor, config: ICPConfig) -> Tensor:
    if config.point_scale == 1.0:
        return x
    return x / torch.tensor(config.point_scale, dtype=x.dtype,
                            device=x.device)


def _scale_transform(t, s: float):
    """A RigidTransform2 or RigidTransform3 in solver units."""
    return type(t)(rot=t.rot, t=t.t / s) if s != 1.0 else t


def _unscale_transform(t, s: float):
    return type(t)(rot=t.rot, t=t.t * s) if s != 1.0 else t


def _sort_enabled(src, dst, config: ICPConfig):
    """Spatial pre-sort policy (config.nn_sort): the sort method or None.
    "auto" sorts (Morton) when the pair-grid kernels serve a batched
    search and each db spans at least 3 of their 128-point chunks, or when
    the survivor-list kernel serves the search and the db spans at least 3
    tiles; sorting permutes reduction order only, and the f64 parity path
    stays unsorted."""
    if config.nn_sort in ("azimuth", "morton"):
        return config.nn_sort
    if config.nn_sort != "auto":
        return None
    if use_pairs_nn(src, dst, config.nn_backend, config.nn_method):
        return "morton" if dst.shape[-2] >= 3 * _PAIRS_CHUNK else None
    ok = (dst.shape[-2] >= 3 * config.nn_dst_tile
          and use_cuda_nn(src, dst, config.nn_backend, config.nn_method))
    return "morton" if ok else None


def _spatial_sort(points, mask, extras=(), method: str = "morton"):
    """Sort the point axis spatially (masked points last).  The permuted
    mask is rebuilt as ``arange < n_valid``: both sort methods key masked
    points above every valid one, so the stable argsort puts exactly the
    valid points first (bit-identical to gathering the mask)."""
    order = spatial_order(points, mask, method).to(torch.int64)
    pts = torch.take_along_dim(points, order[..., None], dim=-2)
    n_valid = torch.sum(mask, dim=-1, keepdim=True)
    msk = torch.arange(mask.shape[-1], device=mask.device) < n_valid
    return pts, msk, [_take_points(e, order, pts.ndim) for e in extras]


def _take_points(x, order, ndim: int):
    """Permute the point axis of a per-point array, (..., N, K) when it has
    the points' rank, else (..., N), lane by lane."""
    if x.ndim == ndim:
        return torch.take_along_dim(x, order[..., None], dim=-2)
    return torch.take_along_dim(x, order, dim=-1)


def presort_src(src, src_mask, dst, config: ICPConfig):
    """Hoist the drivers' loop-invariant src sort out of a sequence loop.
    Returns ``(src, src_mask, presorted)``; an ``icp2d``/``icp3d_planar``
    call with ``src_presorted=True`` is bitwise-identical to sorting
    inside the call."""
    sort = _sort_enabled(src, dst, config)
    if not sort:
        return src, src_mask, False
    view = _scaled(src.to(config.compute_dtype), config)
    order = spatial_order(view, src_mask, sort).to(torch.int64)
    return (_take_points(src, order, src.ndim),
            torch.take_along_dim(src_mask, order, dim=-1), True)


def _broadcast_db(src, dst, dst_mask):
    """Broadcast a shared db (M, D) to a batched src's pair axis: every
    path below (sort, NN, frame kernels) takes src and dst with the same
    batch rank."""
    if dst.ndim >= src.ndim:
        return dst, dst_mask
    batch = src.shape[:src.ndim - dst.ndim]
    return (dst.expand(*batch, *dst.shape),
            dst_mask.expand(*batch, *dst_mask.shape))


def _use_frame_kernel(src, dst, config: ICPConfig, return_stats: bool):
    """Gate for the whole-frame kernels (config.frame_backend): small
    float32 2D scans whose solver resolves to the kernels.  Returns None,
    "single" (one pair, one icp2d_frame launch) or "pairs" (a batch, one
    icp2d_frame_pairs launch); "auto" takes "single" only."""
    if config.frame_backend == "off" or return_stats:
        return None
    if not (src.ndim in (2, 3) and src.shape[-1] == 2
            and src.dtype == torch.float32 and dst.ndim == src.ndim
            and (src.ndim == 2 or dst.shape[0] == src.shape[0])
            and src.shape[-2] <= config.frame_kernel_max
            and dst.shape[-2] <= config.frame_kernel_max
            and align2d.use_cuda_align(src, config.align_backend)):
        return None
    kind = "single" if src.ndim == 2 else "pairs"
    if kind == "single" or config.frame_backend == "pairs":
        return kind
    return None


def _is_identity(dt: RigidTransform2) -> Tensor:
    """Per batch lane: is dt EXACTLY the identity (bitwise)?"""
    eye = torch.eye(dt.rot.shape[-1], dtype=dt.rot.dtype,
                    device=dt.rot.device)
    return (torch.all(dt.rot == eye, dim=-1).all(dim=-1)
            & torch.all(dt.t == 0.0, dim=-1))


def _outer_fixed_point(step, t0, max_iters: int, aux0, first_step=None):
    """Run the outer ICP loop with the EXACT fixed-point early exit.

    ``step(t, aux) -> (t_next, fixed, aux_next)``, ``fixed`` per lane; the
    aux carries the NN prune bound (last iteration's distances), which
    only affects pruning.  A lane that is fixed stays fixed: its next
    iteration repeats the last one exactly.  The loop exits when all lanes
    are, with one host read per iteration.  ``first_step`` peels iteration
    1 (the cold NN branch) out of the loop.  Returns (t, iterations, aux,
    lane iterations): per lane, the iterations up to and including its
    first fixed one."""
    t, it, aux = t0, 0, aux0
    lane_it = torch.zeros(t0.t.shape[:-1], dtype=torch.int32,
                          device=t0.t.device)
    fixed_t = torch.zeros_like(lane_it, dtype=torch.bool)
    fixed = False
    if first_step is not None and max_iters >= 1:
        lane_it = lane_it + 1
        with annotate("icp.outer_iter"):
            t, fixed_t, aux = first_step(t0, aux0)
            fixed, it = bool(torch.all(fixed_t)), 1
    while it < max_iters and not fixed:
        lane_it = lane_it + (~fixed_t).to(torch.int32)
        with annotate("icp.outer_iter"):
            t, fixed_t, aux = step(t, aux)
            fixed = bool(torch.all(fixed_t))
        it += 1
    return t, it, aux, lane_it


class ICPStats(NamedTuple):
    """Per-call observability from the last outer iteration's
    correspondences (exact at the returned transform on a fixed-point
    exit), one value per batch lane.  ``outer_iters`` is the loop's count,
    shared by every lane: the lockstep loop exits when all lanes are
    fixed.  ``mean_nn_dist`` is in physical units; ``huber_error`` in
    solver units."""

    outer_iters: Tensor
    huber_error: Tensor
    mean_nn_dist: Tensor
    inlier_fraction: Tensor


def _stats_2d(src_t, matched, mask, config, dist_sq, it):
    """Final-transform metrics from the last correspondence set."""
    s = config.point_scale
    maskf = mask.to(src_t.dtype)
    nf = torch.clamp(torch.sum(maskf, dim=-1), min=1.0)
    r = src_t[..., :2] - matched[..., :2]
    k = config.huber_k / s
    err = torch.sum(huber.rho(torch.sum(r * r, dim=-1), k) * maskf, dim=-1)
    inl = torch.all(torch.abs(r) <= k, dim=-1)
    mean_nn = torch.sum(torch.sqrt(torch.clamp(dist_sq, min=0.0)) * maskf,
                        dim=-1) / nf * s
    return ICPStats(
        outer_iters=torch.full(err.shape, it, dtype=torch.int32,
                               device=err.device),
        huber_error=err,
        mean_nn_dist=mean_nn,
        inlier_fraction=torch.sum(inl * maskf, dim=-1) / nf,
    )


def _check_pair_shapes(src, dst):
    if src.ndim < 2 or dst.ndim not in (2, src.ndim):
        raise ValueError(
            "src must be (..., N, D), dst (M, D) or (..., M, D) with src's "
            f"rank; got {tuple(src.shape)}, {tuple(dst.shape)}")


def _prepare(src, dst, src_mask, dst_mask, initial_transform,
             config: ICPConfig, device, check=_check_pair_shapes,
             dst_extra=None):
    """Move the inputs to the device and into solver units; broadcast a
    shared db and an unbatched warm start (RigidTransform2 or
    RigidTransform3) to a batch's pair axis.  Two or more batch axes are
    flattened into the one pair axis the loop takes.  ``check(src, dst)``
    raises on shapes the caller does not take; ``dst_extra`` (..., M, K),
    a per-db-point tensor in the compute dtype (p2l's normals), is moved
    and flattened with dst.  Returns (src, dst, src_mask, dst_mask, t0,
    batch, dst_extra): ``batch`` is src's batch shape, for
    ``_unflatten``."""
    with annotate("icp.prepare"):
        dt = config.compute_dtype
        dev = resolve_device(device, dt)
        src = torch.as_tensor(src).to(device=dev, dtype=dt)
        dst = torch.as_tensor(dst).to(device=dev, dtype=dt)
        check(src, dst)
        src_mask = torch.as_tensor(src_mask).to(device=dev, dtype=torch.bool)
        dst_mask = torch.as_tensor(dst_mask).to(device=dev, dtype=torch.bool)
        if dst_extra is not None:
            dst_extra = torch.as_tensor(dst_extra).to(device=dev, dtype=dt)
        dst, dst_mask = _broadcast_db(src, dst, dst_mask)
        t0 = _scale_transform(
            initial_transform.astype(dt).to(dev), config.point_scale)
        kind, d = type(t0), t0.t.shape[-1]
        batch = src.shape[:-2]
        if t0.t.shape[:-1] != batch:
            t0 = kind(t0.rot.expand(*batch, d, d), t0.t.expand(*batch, d))
        if len(batch) > 1:
            src, dst = src.flatten(0, -3), dst.flatten(0, -3)
            src_mask = src_mask.flatten(0, -2)
            dst_mask = dst_mask.flatten(0, -2)
            if dst_extra is not None:
                dst_extra = dst_extra.flatten(0, -3)
            t0 = kind(t0.rot.reshape(-1, d, d), t0.t.reshape(-1, d))
        return (_scaled(src, config), _scaled(dst, config), src_mask, dst_mask,
                t0, batch, dst_extra)


def _unflatten(out, batch):
    """Give a result of the flattened loop (a transform, RigidTransform2 or
    RigidTransform3, or (transform, ICPStats)) the caller's batch axes
    back."""
    if len(batch) <= 1:
        return out
    t, stats = out if isinstance(out, tuple) else (out, None)
    d = t.t.shape[-1]
    t = type(t)(t.rot.reshape(*batch, d, d), t.t.reshape(*batch, d))
    if stats is None:
        return t
    return t, ICPStats(*[f.reshape(batch) for f in stats])


def _icp_loop(src, dst, src_mask, dst_mask, t0, config: ICPConfig,
              src_presorted: bool, planar: bool):
    """The unfused outer loop in solver units, shared by both drivers.
    ``planar``: 3D matching with the SE(2) solve on xy (z untouched).
    Returns (t, iterations, (dist_sq, src_t_xy, matched_xy, src_mask),
    lane iterations): the last iteration's correspondences and the mask in
    the loop's point order, which the spatial sort may have permuted."""
    sort = _sort_enabled(src, dst, config)
    if sort:
        if not src_presorted:
            src, src_mask, _ = _spatial_sort(src, src_mask, method=sort)
        dst, dst_mask, _ = _spatial_sort(dst, dst_mask, method=sort)
    # The SE(2) solve consumes only the matched point's xy.
    payload = dst[..., :2] if planar else None
    db_pack = build_db_pack(src, dst, dst_mask, payload=payload,
                            backend=config.nn_backend,
                            tile=config.nn_dst_tile,
                            method=config.nn_method)
    eps = torch.finfo(src.dtype).eps

    def make_outer(warm):
        def outer(t, aux):
            prev_d2, prev_xy = aux[0], aux[1]
            xy = t.apply_points(src[..., :2])
            src_t = torch.cat([xy, src[..., 2:]], dim=-1) if planar else xy
            # Valid NN upper bound: the db is fixed, so dist_new(q) <=
            # dist_prev(q) + |dq|; 32 eps keeps it an upper bound after
            # the sqrt/square round trip.
            move = torch.linalg.norm(xy - prev_xy, dim=-1)
            qb = (torch.sqrt(prev_d2) + move) ** 2 * (1.0 + 32.0 * eps)
            res, matched = nearest_neighbor_matched(
                src_t, dst, dst_mask, payload=payload,
                backend=config.nn_backend, tile=config.nn_dst_tile,
                q_tile=config.nn_query_tile, q_bound=qb, db_pack=db_pack,
                warm=warm, method=config.nn_method)
            matched_xy = matched[..., :2]
            dt = align2d.estimate_transform(xy, matched_xy, src_mask,
                                            config)
            return (dt.compose(t), _is_identity(dt),
                    (res.dist_sq, xy, matched_xy))
        return outer

    aux0 = (torch.full(src.shape[:-1], float("inf"), dtype=src.dtype,
                       device=src.device),
            src[..., :2], torch.zeros_like(src[..., :2]))
    t, it, aux, lane_it = _outer_fixed_point(make_outer(True), t0,
                                             config.outer_iters, aux0,
                                             first_step=make_outer(False))
    return t, it, aux + (src_mask,), lane_it


def _finish(t, it, aux, config: ICPConfig, return_stats: bool):
    """Rescale the result to physical units; with ``return_stats`` add the
    ICPStats of the last iteration's correspondences."""
    t = _unscale_transform(t, config.point_scale)
    if not return_stats:
        return t
    dist_sq, src_xy, matched_xy, mask = aux
    return t, _stats_2d(src_xy, matched_xy, mask, config, dist_sq, it)


def _icp2d_solver(src, dst, src_mask, dst_mask, t0, config: ICPConfig):
    """The unfused 2D loop in solver units -> (t, iterations, lane
    iterations); the plain version of the whole-frame kernels."""
    t, it, _, lane_it = _icp_loop(src, dst, src_mask, dst_mask, t0, config,
                                  src_presorted=False, planar=False)
    return t, it, lane_it


def icp2d(src, dst, src_mask, dst_mask,
          initial_transform: RigidTransform2,
          config: ICPConfig = ICPConfig(), return_stats: bool = False,
          src_presorted: bool = False, device="cuda"):
    """2D scan-to-scan ICP. src/dst: (N|M, 2), or (B, N|M, 2) for B pairs
    (a shared dst may stay (M, 2)); masks over the point axes.

    Parity: reference Icp2d::estimate (src/lib.rs:105-130).  With
    ``return_stats`` returns (transform, ICPStats).  Scans of at most
    frame_kernel_max points run as one ``icp2d_frame`` launch when the
    solver resolves to the kernels, and a batch as one
    ``icp2d_frame_pairs`` launch with ``frame_backend="pairs"``."""
    with annotate("icp.icp2d"):
        src, dst, src_mask, dst_mask, t0, batch, _ = _prepare(
            src, dst, src_mask, dst_mask, initial_transform, config, device)
        kind = _use_frame_kernel(src, dst, config, return_stats)
        if kind:
            rot, t, _ = align2d_cuda.icp2d_frame(src, dst, src_mask, dst_mask,
                                                 t0, config)
            return _unflatten(_unscale_transform(RigidTransform2(rot, t),
                                                 config.point_scale), batch)
        return _unflatten(_finish(*_icp_loop(src, dst, src_mask, dst_mask, t0,
                                             config, src_presorted,
                                             planar=False)[:3],
                                  config, return_stats), batch)


def icp3d_planar(src, dst, src_mask, dst_mask,
                 initial_transform: RigidTransform2,
                 config: ICPConfig = ICPConfig(), return_stats: bool = False,
                 src_presorted: bool = False, device="cuda"):
    """3D matching, SE(2)-on-xy optimization (vehicle on the xy-plane).

    src/dst: (N|M, 3), or (B, N|M, 3).  Parity: reference Icp3d::estimate
    (src/lib.rs:148-173).  ``src_presorted``: src already permuted by
    :func:`presort_src` (bitwise-identical hoist)."""
    src, dst, src_mask, dst_mask, t0, batch, _ = _prepare(
        src, dst, src_mask, dst_mask, initial_transform, config, device)
    return _unflatten(_finish(*_icp_loop(src, dst, src_mask, dst_mask, t0,
                                         config, src_presorted,
                                         planar=True)[:3],
                              config, return_stats), batch)
