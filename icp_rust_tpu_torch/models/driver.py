"""The outer ICP loop of the drivers (``models/icp2d``,
``models/icp_p2l``, ``parallel/sharded``): ``prepare`` (inputs in solver
units, coordinates over config.point_scale, batch axes flattened),
``sort_pair`` (the NN route's pre-sort), ``fixed_point`` (the loop, to its
EXACT fixed point: an iteration whose dT is the identity bitwise repeats
forever, so the exit is bit-exact with running all ``outer_iters``) and
``outer_step`` (one iteration: the seeded NN search, then the solve).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.ops import nn
from icp_rust_tpu_torch.utils.profiling import annotate


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


def scaled(x: Tensor, config: ICPConfig) -> Tensor:
    """Coordinates in solver units."""
    if config.point_scale == 1.0:
        return x
    return x / torch.tensor(config.point_scale, dtype=x.dtype,
                            device=x.device)


def scale_transform(t, s: float):
    """A RigidTransform2 or RigidTransform3 in solver units."""
    return type(t)(rot=t.rot, t=t.t / s) if s != 1.0 else t


def unscale_transform(t, s: float):
    """A transform in solver units back in physical units."""
    return type(t)(rot=t.rot, t=t.t * s) if s != 1.0 else t


def spatial_sort(points, mask, extras=(), method: str = "morton"):
    """Sort the point axis spatially (masked points last).  The permuted
    mask is rebuilt as ``arange < n_valid``: both sort methods key masked
    points above every valid one, so the stable argsort puts exactly the
    valid points first (bit-identical to gathering the mask).  Returns
    (points, mask, [each of ``extras``, per-point arrays, permuted])."""
    order = nn.spatial_order(points, mask, method).to(torch.int64)
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


def sort_pair(sort, src, src_mask, dst, dst_mask, src_presorted: bool,
              dst_extras=()):
    """The route's pre-sort (``sort``, None for none) of src, unless
    ``src_presorted``, and of dst with its per-point ``dst_extras``.
    Returns (src, src_mask, dst, dst_mask, [extras])."""
    if not sort:
        return src, src_mask, dst, dst_mask, list(dst_extras)
    if not src_presorted:
        src, src_mask, _ = spatial_sort(src, src_mask, method=sort)
    dst, dst_mask, dst_extras = spatial_sort(dst, dst_mask, dst_extras,
                                             method=sort)
    return src, src_mask, dst, dst_mask, dst_extras


def presort_src(src, src_mask, dst, config: ICPConfig):
    """Hoist the drivers' loop-invariant src sort out of a sequence loop.
    Returns ``(src, src_mask, presorted)``; a driver call with
    ``src_presorted=True`` is bitwise-identical to sorting inside the
    call."""
    sort = nn.route(src, dst, dst.shape[-1], config).sort
    if not sort:
        return src, src_mask, False
    view = scaled(src.to(config.compute_dtype), config)
    _, _, (src, src_mask) = spatial_sort(view, src_mask, (src, src_mask),
                                         sort)
    return src, src_mask, True


def _broadcast_db(src, dst, dst_mask):
    """Broadcast a shared db (M, D) to a batched src's pair axis: every
    path below (sort, NN, frame kernels) takes src and dst with the same
    batch rank."""
    if dst.ndim >= src.ndim:
        return dst, dst_mask
    batch = src.shape[:src.ndim - dst.ndim]
    return (dst.expand(*batch, *dst.shape),
            dst_mask.expand(*batch, *dst_mask.shape))


def _check_pair_shapes(src, dst):
    if src.ndim < 2 or dst.ndim not in (2, src.ndim):
        raise ValueError(
            "src must be (..., N, D), dst (M, D) or (..., M, D) with src's "
            f"rank; got {tuple(src.shape)}, {tuple(dst.shape)}")


def prepare(src, dst, src_mask, dst_mask, initial_transform,
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
    ``unflatten``."""
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
        t0 = scale_transform(
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
        return (scaled(src, config), scaled(dst, config), src_mask, dst_mask,
                t0, batch, dst_extra)


def unflatten(out, batch):
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


def is_identity(dt) -> Tensor:
    """Per batch lane: is dt (RigidTransform2 or RigidTransform3) EXACTLY
    the identity (bitwise)?"""
    eye = torch.eye(dt.rot.shape[-1], dtype=dt.rot.dtype,
                    device=dt.rot.device)
    return (torch.all(dt.rot == eye, dim=-1).all(dim=-1)
            & torch.all(dt.t == 0.0, dim=-1))


def fixed_point(step, t0, max_iters: int, aux0):
    """Run the outer ICP loop with the EXACT fixed-point early exit.

    ``step(t, aux, warm) -> (t_next, fixed, aux_next)``, ``fixed`` per
    lane; ``warm`` is False on the first iteration (the NN's cold branch)
    and True after.  The aux carries the NN prune bound (last iteration's
    distances), which only affects pruning.  A lane that is fixed stays
    fixed: its next iteration repeats the last one exactly.  The loop
    exits when all lanes are, with one host read per iteration.  Returns
    (t, iterations, aux, lane iterations): per lane, the iterations up to
    and including its first fixed one."""
    t, it, aux = t0, 0, aux0
    lane_it = torch.zeros(t0.t.shape[:-1], dtype=torch.int32,
                          device=t0.t.device)
    fixed_t = torch.zeros_like(lane_it, dtype=torch.bool)
    fixed = False
    while it < max_iters and not fixed:
        lane_it = lane_it + (~fixed_t).to(torch.int32)
        with annotate("icp.outer_iter"):
            t, fixed_t, aux = step(t, aux, it > 0)
            fixed = bool(torch.all(fixed_t))
        it += 1
    return t, it, aux, lane_it


def outer_step(index: nn.NNIndex, place, solve):
    """The step of the outer ICP loop, for ``fixed_point``.  ``place(t) ->
    (moved, query)``: the points whose motion bounds the NN distance (the
    solve's coordinates) and the NN query; ``solve(moved, res, rows) ->
    (dt, kept)`` from the NNResult and the winners' payload rows.  The
    step's aux is (last NN distances², last ``moved``, last ``kept``); it
    returns (dt o t, is_identity(dt), (res.dist_sq, moved, kept))."""
    def step(t, aux, warm: bool):
        prev_d2, prev = aux[0], aux[1]
        moved, query = place(t)
        # Valid NN upper bound: the db is fixed, so dist_new(q) <=
        # dist_prev(q) + |dq|; 32 eps keeps it an upper bound after the
        # sqrt/square round trip.
        move = torch.linalg.norm(moved - prev, dim=-1)
        eps = torch.finfo(moved.dtype).eps
        q_bound = (torch.sqrt(prev_d2) + move) ** 2 * (1.0 + 32.0 * eps)
        with annotate("icp.nn"):
            res, rows = index.search(query, q_bound, warm)
        dt, kept = solve(moved, res, rows)
        return dt.compose(t), is_identity(dt), (res.dist_sq, moved, kept)
    return step
