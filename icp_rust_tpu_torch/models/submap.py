"""Scan-to-submap odometry (BASELINE.json configs[3]; JAX package
``models/submap.py``).

No reference counterpart: the reference matches scan-to-first-scan
forever (examples/scan2d.rs:65-88), which drifts once overlap with frame 1
shrinks.  Here each incoming scan is aligned against a rolling local map
held in the odometry frame; the aligned scan's points are then merged into
the map.

Two map representations:

- **Fused (default)**: a persistent voxel hash map (``ops/voxel_hash``).
  Each frame re-sorts the map view into Morton order so the NN kernels'
  box pruning stays effective despite the hash-random slot order, matches
  against the first ``view_rows`` rows of that view, and inserts the
  aligned scan salted with the frame index.  The JAX package runs the
  whole sequence as one ``lax.scan`` program; here it is a host loop over
  frames around the same step body (``_step``), which also serves the
  checkpointable segments: a segment only sets where the carry is saved.
- **Re-voxelize** (``fused=False``): the per-frame loop that re-voxelizes
  map + scan with the sort-based ``ops.voxel`` pass, kept as the semantics
  reference (its centroids are unit-weight per merge generation rather
  than running means).

Kernels: the ICP is ``icp2d`` (2D frames) or ``icp3d_planar`` against the
map view, with the drivers' own spatial sort off (``nn_sort="none"``): the
view is Morton-ordered here and the queries once per sequence.  At
``bench_submap.py``'s width (a 65,536-row view, 32 db tiles) the NN is the
seeded survivor-list kernel (its db pack rebuilt every frame, since the
map changes) and the solver the irls_loop kernel; on a view of fewer than
3 tiles the NN is the nn_matched sweep.

Entry points run on ``device`` ("cuda" by default); with no card they
raise unless the caller passes ``device="cpu"``.  Every step is
deterministic (no float atomics), so a run repeats bitwise on the card
and a resumed run reproduces the rest of its sequence bitwise.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.driver import ICPStats, spatial_sort
from icp_rust_tpu_torch.models.icp2d import se2_driver
from icp_rust_tpu_torch.ops import voxel_hash as vh
from icp_rust_tpu_torch.ops.nn import morton_order
from icp_rust_tpu_torch.ops.voxel import voxel_downsample


def _apply_planar(t: RigidTransform2, scan: Tensor, dtype) -> Tensor:
    if scan.shape[-1] == 2:
        return t.apply_points(scan.to(dtype))
    xy = t.apply_points(scan[..., :2].to(dtype))
    return torch.cat([xy, scan[..., 2:].to(dtype)], dim=-1)


def submap_step(map_pts: Tensor, map_mask: Tensor, scan: Tensor,
                scan_mask: Tensor, t_prev: RigidTransform2,
                config: ICPConfig, voxel_size: float, capacity: int):
    """Align one scan to the map, then merge it in (re-voxelize path), on
    the tensors' device.  Returns (t_new, map_pts', map_mask', n_cells).
    The transform maps scan (sensor frame) -> odometry/map frame, the
    inverse of the reference drivers' convention, so that map insertion is
    a plain apply."""
    t = se2_driver(scan.shape[-1])(scan, map_pts, scan_mask, map_mask,
                                   t_prev, config, device=scan.device)
    scan_in_map = _apply_planar(t, scan, map_pts.dtype)
    merged = torch.cat([map_pts, scan_in_map], dim=0)
    merged_mask = torch.cat([map_mask, scan_mask], dim=0)
    vox = voxel_downsample(merged, merged_mask, voxel_size, capacity)
    return t, vox.points, vox.mask, vox.n_cells


def run_submap_odometry(frames, masks, config: ICPConfig = ICPConfig(),
                        voxel_size: float = 0.05, capacity: int = 16384,
                        fused: bool = True, probes: int = 8,
                        with_metrics: bool = False, resort_every: int = 1,
                        metrics=None, checkpoint=None, resume: bool = False,
                        warm_start: str = "prev",
                        view_rows: int | None = None, device="cuda"):
    """frames: (F, N, D) padded; masks: (F, N).  Frame 0 seeds the map.
    Returns (transforms, path): one RigidTransform2 (scan -> map) with a
    leading (F-1,) frame axis, and the (F-1, 2) float64 numpy trajectory
    of sensor positions in the map frame.

    ``fused=True`` (default) requires a power-of-two ``capacity``;
    ``with_metrics`` (fused only) appends the per-frame ICPStats (outer
    iterations, Huber error, mean NN distance, inlier fraction, each with a
    leading frame axis).  ``warm_start``: "prev" (default, stable) or "cv"
    (constant-velocity extrapolation; unstable against the self-built map
    on long sequences, see :func:`_step`).  ``view_rows``: match against
    only the first view_rows rows of the Morton-sorted map view, exact
    while occupancy stays below it (empty slots sort last); overflow is
    counted and warned, never silent.

    Observability and resume (fused only): ``metrics`` takes a
    ``utils.metrics.MetricsLogger`` (one row per frame, each frame's
    seconds its segment's share); ``checkpoint`` a
    ``utils.checkpoint.SequenceCheckpointer``, saved after every segment of
    ``checkpoint.every`` frames with the full carry (transform,
    constant-velocity motion, voxel hash map, map view order);
    ``resume=True`` reloads the carry and reproduces the rest of the
    trajectory bitwise.

    Map extent: the hash map keys a fixed 1024-cells-per-axis box
    (1024 * voxel_size per axis) centred on frame 0's centroid; points of
    a trajectory leaving it count toward the dropped-points warning."""
    dev = resolve_device(device, config.compute_dtype)
    if fused:
        return _run_fused(frames, masks, config, voxel_size, capacity,
                          probes, with_metrics, resort_every, metrics,
                          checkpoint, resume, warm_start, view_rows, dev)
    if metrics is not None or checkpoint is not None or resume:
        raise ValueError("metrics/checkpoint/resume require the fused "
                         "runner")
    if with_metrics:
        raise ValueError("with_metrics requires the fused runner")
    dtype = config.compute_dtype
    pts = torch.as_tensor(frames).to(device=dev, dtype=dtype)
    msk = torch.as_tensor(masks).to(device=dev, dtype=torch.bool)
    vox = voxel_downsample(pts[0], msk[0], voxel_size, capacity)
    map_pts, map_mask = vox.points, vox.mask
    t = RigidTransform2.identity(dtype=dtype, device=dev)
    rots, ts, cells = [], [], [vox.n_cells]
    for i in range(1, pts.shape[0]):
        t, map_pts, map_mask, n_cells = submap_step(
            map_pts, map_mask, pts[i], msk[i], t, config, voxel_size,
            capacity)
        rots.append(t.rot)
        ts.append(t.t)  # sensor position in map frame
        cells.append(n_cells)
    max_cells = int(torch.max(torch.stack(cells)))
    if max_cells > capacity:
        warnings.warn(
            f"submap voxel capacity overflow: {max_cells} occupied cells "
            f"> capacity {capacity}; the map was truncated (spatially "
            f"biased) — grow `capacity` or the voxel size",
            RuntimeWarning,
            stacklevel=2,
        )
    return _result(rots, ts, dtype, dev, pts.shape[-1])


def _result(rots, ts, dtype, dev, dim: int):
    """(transforms with a leading frame axis, float64 numpy path)."""
    if not ts:
        return (RigidTransform2(torch.zeros((0, 2, 2), dtype=dtype,
                                            device=dev),
                                torch.zeros((0, 2), dtype=dtype,
                                            device=dev)),
                np.zeros((0, dim)))
    t = RigidTransform2(torch.stack(rots), torch.stack(ts))
    return t, t.t.to(torch.float64).cpu().numpy()


def _step(carry, i: int, scan: Tensor, smask: Tensor, config: ICPConfig,
          voxel_size: float, probes: int, with_stats: bool,
          resort_every: int, warm_start: str, view_rows):
    """One frame of the fused runner (the JAX package's scan body).
    carry = (t, rel, map, order); ``i`` is the 0-based index of the frame
    among the processed ones (frame i + 1).  Returns (carry', (t_new,
    dropped, hidden, stats or None)).

    ``warm_start``: "prev" warm-starts from the previous pose, the
    reference drivers' convention; "cv" extrapolates constant velocity
    (T_prev o rel), which is unstable against the self-built map: the pose
    error feeds the map through insertion and the velocity term doubles
    the loop gain (the JAX package measured divergence by frame 17 of its
    96-frame bench; "prev" holds)."""
    t, rel, m, order = carry
    dtype = config.compute_dtype
    t_warm = t.compose(rel) if warm_start == "cv" else t
    map_pts, map_mask = vh.centroids(m)
    # The map view in Morton order: hash-random slot order defeats the NN
    # kernels' box pruning; empty slots sort last (masked -> max code).
    # The order is refreshed every ``resort_every`` frames and carried in
    # between (a stale order is still a permutation of all slots).
    if i % resort_every == 0:
        order = morton_order(map_pts, map_mask)
    # With a fresh order every occupied cell precedes every empty slot, so
    # the permuted mask is the prefix arange < n_occ.  ``view_rows`` keeps
    # only the first view_rows rows, exact while occupancy fits; cells
    # beyond the view are counted in ``hidden``.
    fresh = resort_every == 1
    n_occ = torch.sum(map_mask.to(torch.int32))
    rows = map_mask.shape[0]
    if view_rows is not None and view_rows < rows:
        rows = view_rows
    view = order[:rows].to(torch.int64)
    map_pts = map_pts[view]
    if fresh:
        map_mask = torch.arange(rows, device=n_occ.device) < n_occ
    else:
        map_mask = map_mask[view]
    hidden = n_occ - torch.sum(map_mask.to(torch.int32))
    out = se2_driver(scan.shape[-1])(scan, map_pts, smask, map_mask, t_warm,
                                     config, return_stats=with_stats,
                                     device=scan.device)
    t_new, stats = out if with_stats else (out, None)
    rel_new = t.inverse().compose(t_new)
    scan_in_map = _apply_planar(t_new, scan, dtype)
    # salt=i rotates the insert's overflow keep-set per frame (a fixed
    # keep-set carves a permanent spatial hole in the rolling map).
    m, d = vh.insert(m, scan_in_map, smask, voxel_size, probes, salt=i)
    return (t_new, rel_new, m, order), (t_new, d, hidden, stats)


def _warn_drops(n_dropped: int):
    if not n_dropped:
        return
    warnings.warn(
        f"submap hash map dropped {n_dropped} points across the "
        f"sequence (probe exhaustion, or out of the fixed "
        f"1024*voxel_size cell box) — grow `capacity` (power of two) "
        f"or the voxel size",
        RuntimeWarning,
        stacklevel=4,
    )


def _warn_hidden(n_hidden: int):
    if not n_hidden:
        return
    warnings.warn(
        f"submap view_rows hid {n_hidden} occupied-cell observations "
        f"from matching across the sequence (occupancy exceeded "
        f"view_rows, or a stale resort order) — grow `view_rows` or "
        f"resort every frame",
        RuntimeWarning,
        stacklevel=4,
    )


def _run_fused(frames, masks, config: ICPConfig, voxel_size: float,
               capacity: int, probes: int, with_metrics: bool,
               resort_every: int, metrics, checkpoint, resume: bool,
               warm_start: str, view_rows, dev):
    """The fused runner, in segments of ``checkpoint.every`` frames (16
    with metrics and no checkpoint; the whole sequence otherwise).  After
    each segment the carry is checkpointed, the drop and hidden counts are
    read, and the metrics rows written."""
    dtype = config.compute_dtype
    pts = torch.as_tensor(frames).to(device=dev, dtype=dtype)
    msk = torch.as_tensor(masks).to(device=dev, dtype=torch.bool)
    f_total, dim = pts.shape[0], pts.shape[-1]
    # nn_sort="none" turns off the driver's per-call spatial sort only:
    # the map view is Morton-ordered in the step and the queries once.
    cfg = config.with_(nn_sort="none")
    with_stats = bool(with_metrics) or metrics is not None
    if checkpoint is not None:
        every = int(checkpoint.every)
    else:
        every = 16 if metrics is not None else max(f_total - 1, 1)

    start = 1
    state = checkpoint.restore() if (resume and checkpoint is not None) \
        else None
    if state is not None:
        start = int(state["frame_cursor"]) + 1

        def load(name, dt=dtype):
            return torch.as_tensor(np.asarray(state[name])).to(
                device=dev, dtype=dt)

        t = RigidTransform2(load("t_rot"), load("t_t"))
        rel = RigidTransform2(load("rel_rot"), load("rel_t"))
        m = vh.VoxelHashMap(load("map_key", torch.int32), load("map_psum"),
                            load("map_cnt"), load("map_origin"))
        order = load("order", torch.int32)
        rots = list(load("rots"))
        ts = list(load("ts"))
        n_dropped = int(state["n_dropped"])
        n_hidden = int(state.get("n_hidden", 0))
    else:
        origin = vh.origin_for(pts[0], msk[0], voxel_size)
        m = vh.make_map(capacity, dim, origin, dtype)
        m, d0 = vh.insert(m, pts[0], msk[0], voxel_size, probes)
        t = RigidTransform2.identity(dtype=dtype, device=dev)
        rel = RigidTransform2.identity(dtype=dtype, device=dev)
        order = torch.arange(capacity, dtype=torch.int32, device=dev)
        rots, ts = [], []
        n_dropped = int(d0)
        n_hidden = 0

    stats_rows = []
    i = start
    while i < f_total:
        j = min(i + every, f_total)
        seg_t0 = time.perf_counter()
        # Queries in Morton order (sensor frame; rigid motion preserves the
        # clustering) to match the per-frame map sort; sorting a segment
        # equals sorting the whole batch and slicing.
        q_pts, q_msk, _ = spatial_sort(pts[i:j], msk[i:j])
        carry = (t, rel, m, order)
        drops, hidden, seg_stats = [], [], []
        for k in range(j - i):
            carry, (t_k, d, h, st) = _step(
                carry, i - 1 + k, q_pts[k], q_msk[k], cfg, voxel_size,
                probes, with_stats, resort_every, warm_start, view_rows)
            rots.append(t_k.rot)
            ts.append(t_k.t)
            drops.append(d)
            hidden.append(h)
            seg_stats.append(st)
        t, rel, m, order = carry
        n_dropped += int(torch.sum(torch.stack(drops)))
        n_hidden += int(torch.sum(torch.stack(hidden)))
        if with_stats:
            stats = ICPStats(*[torch.stack(list(f)) for f in zip(*seg_stats)])
            stats_rows.append(stats)
        if metrics is not None:
            seg_dt = (time.perf_counter() - seg_t0) / (j - i)
            for k in range(j - i):
                metrics.end_frame(
                    i + k, seconds=seg_dt,
                    huber_error=float(stats.huber_error[k]),
                    mean_nn_dist=float(stats.mean_nn_dist[k]),
                    inlier_fraction=float(stats.inlier_fraction[k]),
                    extra={"outer_iters": int(stats.outer_iters[k])},
                )
        if checkpoint is not None:
            checkpoint.save(j - 1, {
                "t_rot": t.rot, "t_t": t.t,
                "rel_rot": rel.rot, "rel_t": rel.t,
                "map_key": m.key, "map_psum": m.psum, "map_cnt": m.cnt,
                "map_origin": m.origin, "order": order,
                "rots": torch.stack(rots), "ts": torch.stack(ts),
                "n_dropped": n_dropped, "n_hidden": n_hidden,
            })
        i = j

    _warn_drops(n_dropped)
    _warn_hidden(n_hidden)
    transforms, path = _result(rots, ts, dtype, dev, dim)
    if with_metrics:
        stats = ICPStats(*[torch.cat(list(f)) for f in zip(*stats_rows)]) \
            if stats_rows else None
        return transforms, path, stats
    return transforms, path
