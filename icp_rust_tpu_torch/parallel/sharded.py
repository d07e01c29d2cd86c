"""Sharded ICP over a ``torch.distributed`` device mesh: the point axis
("sp", sequence parallel) and the pair axis ("dp", data parallel).
Counterpart of icp_rust_tpu/parallel/sharded.py.

Every rank passes the *global* arrays, as ``shard_map``'s callers do, and
takes its contiguous block along each sharded axis: rows [r N / sp,
(r + 1) N / sp) of both clouds on "sp", pairs [r B / dp, (r + 1) B / dp)
on "dp".  N must divide by sp and B by dp.  The result is what the JAX
package returns: a transform replicated over the point axis, and over the
pair axis the full (B,) batch, all-gathered.

- ``sharded_estimate_transform``, ``sharded_icp2d``, ``dp_sp_icp2d``,
  ``dp_sp_icp3d_planar``, ``dp_sp_icp_p2l``: queries stay on their rank;
  the destination shards rotate round the point axis's ring, carrying the
  winners' payload (``parallel/ring_nn``), and the robust solve
  all-reduces its sums over it (``ops/align2d``, ``ops/align3d`` with a
  group).  The outer loop is the JAX package's: coordinates divided by
  ``point_scale``, no spatial pre-sort, no whole-frame kernel, the ring
  with ``tile=config.nn_dst_tile``, and the bit-exact fixed-point exit.
  Every transform the loop reads on the host (its exit test, the inner
  loop's) is replicated over the point axis, so the ranks' collectives
  stay in step.
- ``batched_icp2d``: B scan pairs in one call.  Without a mesh it is one
  lockstep ``icp2d`` on one card: per outer iteration one pair-grid NN
  launch for all pairs (``nn_pairs`` on the cold iteration,
  ``nn_pairs_list`` on every warm one) and one ``irls_loop_batched``
  launch, or with ``frame_backend="pairs"`` one ``icp2d_frame_pairs``
  launch.  With a mesh each "dp" rank runs that call on its own pairs and
  the results are all-gathered.
"""

from __future__ import annotations

import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.driver import fixed_point, is_identity, \
    scale_transform, unscale_transform
from icp_rust_tpu_torch.models.icp2d import icp2d
from icp_rust_tpu_torch.ops import align2d, align3d
from icp_rust_tpu_torch.parallel.collectives import all_gather_tiled
from icp_rust_tpu_torch.parallel.mesh import axis, block, check_mesh, \
    mesh_device
from icp_rust_tpu_torch.parallel.ring_nn import ring_nearest_neighbor_matched


def _local(x, dev, dtype, blocks):
    """This rank's block of a global array: ``blocks`` is a list of (Axis,
    dim) to cut along."""
    x = torch.as_tensor(x).to(device=dev, dtype=dtype)
    for ax, dim in blocks:
        x = block(x, ax, dim)
    return x


def _gather_pairs(t, pair):
    """Each pair rank's transforms, all-gathered into the full batch."""
    return type(t)(all_gather_tiled(t.rot, pair.group, 0),
                   all_gather_tiled(t.t, pair.group, 0))


def _ring_icp_se2(src, dst, src_mask, dst_mask, t0: RigidTransform2,
                  config: ICPConfig, sp, planar: bool) -> RigidTransform2:
    """The point-sharded SE(2) outer loop on this rank's blocks (physical
    units in and out).  ``planar``: 3D matching, the solve on xy, the ring
    carrying only the matched xy."""
    s = config.point_scale
    src_s, dst_s = src / s, dst / s
    t = scale_transform(t0, s)
    payload = dst_s[..., :2] if planar else None

    def outer(t):
        xy = t.apply_points(src_s[..., :2])
        src_t = torch.cat([xy, src_s[..., 2:]], dim=-1) if planar else xy
        _, matched = ring_nearest_neighbor_matched(
            src_t, dst_s, dst_mask, sp.group, tile=config.nn_dst_tile,
            payload=payload)
        dt = align2d.estimate_transform(xy, matched[..., :2], src_mask,
                                        config, group=sp.group)
        return dt.compose(t), is_identity(dt)

    t = fixed_point(lambda t, _aux, _warm: (*outer(t), None), t,
                    config.outer_iters, None)[0]
    return unscale_transform(t, s)


def sharded_estimate_transform(src, dst, mask, config: ICPConfig, mesh,
                               point_axis: str = "sp") -> RigidTransform2:
    """Fixed-correspondence alignment with the point axis sharded over
    ``point_axis``: src/dst (N, 2) global, in solver units.  Returns the
    replicated transform."""
    sp = axis(check_mesh(mesh), point_axis)
    dt = config.compute_dtype
    dev = mesh_device(mesh, dt)
    cut = [(sp, -2)]
    return align2d.estimate_transform(
        _local(src, dev, dt, cut), _local(dst, dev, dt, cut),
        _local(mask, dev, torch.bool, [(sp, -1)]), config, group=sp.group)


def _se2_driver(src, dst, src_mask, dst_mask, t0, config: ICPConfig, mesh,
                pair_axis, point_axis: str, planar: bool):
    sp = axis(check_mesh(mesh), point_axis)
    pair = None if pair_axis is None else axis(mesh, pair_axis)
    dt = config.compute_dtype
    dev = mesh_device(mesh, dt)
    lead = [] if pair is None else [(pair, 0)]
    pts, msk = lead + [(sp, -2)], lead + [(sp, -1)]
    t0 = t0.astype(dt).to(dev)
    t0 = RigidTransform2(_local(t0.rot, dev, dt, lead),
                         _local(t0.t, dev, dt, lead))
    t = _ring_icp_se2(_local(src, dev, dt, pts), _local(dst, dev, dt, pts),
                      _local(src_mask, dev, torch.bool, msk),
                      _local(dst_mask, dev, torch.bool, msk), t0, config, sp,
                      planar)
    return t if pair is None else _gather_pairs(t, pair)


def sharded_icp2d(src, dst, src_mask, dst_mask,
                  initial_transform: RigidTransform2, config: ICPConfig,
                  mesh, point_axis: str = "sp") -> RigidTransform2:
    """2D ICP with both clouds (N, 2) and (M, 2) point-sharded over
    ``point_axis``; returns the replicated transform (physical units)."""
    return _se2_driver(src, dst, src_mask, dst_mask, initial_transform,
                       config, mesh, None, point_axis, planar=False)


def dp_sp_icp2d(src, dst, src_mask, dst_mask,
                initial_transform: RigidTransform2, config: ICPConfig, mesh,
                pair_axis: str = "dp",
                point_axis: str = "sp") -> RigidTransform2:
    """2D ICP over a 2D mesh: src/dst (B, N, 2), pairs over ``pair_axis``
    and each pair's clouds over ``point_axis``; (B,)-batched warm starts.
    Returns the (B,) transforms on every rank."""
    return _se2_driver(src, dst, src_mask, dst_mask, initial_transform,
                       config, mesh, pair_axis, point_axis, planar=False)


def dp_sp_icp3d_planar(src, dst, src_mask, dst_mask,
                       initial_transform: RigidTransform2,
                       config: ICPConfig, mesh, pair_axis: str = "dp",
                       point_axis: str = "sp") -> RigidTransform2:
    """The headline workload (reference src/lib.rs:133-174: 3D matching,
    SE(2) solve on xy) over a 2D mesh: src/dst (B, N, 3).  The ring
    carries only the matched point's xy."""
    return _se2_driver(src, dst, src_mask, dst_mask, initial_transform,
                       config, mesh, pair_axis, point_axis, planar=True)


def dp_sp_icp_p2l(src, dst, src_mask, dst_mask,
                  initial_transform: RigidTransform3, config: ICPConfig,
                  mesh, pair_axis: str = "dp", point_axis: str = "sp",
                  normals_voxel_size: float = 0.3) -> RigidTransform3:
    """SE(3) point-to-plane ICP over a 2D mesh (``models/icp_p2l``
    sharded): src/dst (B, N, 3).

    Voxel normals are computed per destination shard, each shard's grid
    anchored at its own minimum, as the JAX package does: a voxel that
    straddles a shard boundary sees only its side's points, so those
    normals differ from the single-device driver's.  The ring carries
    ``build_p2l_payload``'s 4 lanes [normal, plane offset]."""
    from icp_rust_tpu_torch.models.icp_p2l import build_p2l_payload, \
        decode_p2l_payload
    from icp_rust_tpu_torch.ops.normals import estimate_normals_voxel

    sp = axis(check_mesh(mesh), point_axis)
    pair = axis(mesh, pair_axis)
    dt = config.compute_dtype
    dev = mesh_device(mesh, dt)
    s = config.point_scale
    pts, msk = [(pair, 0), (sp, -2)], [(pair, 0), (sp, -1)]
    src_s = _local(src, dev, dt, pts) / s
    dst_s = _local(dst, dev, dt, pts) / s
    src_mask = _local(src_mask, dev, torch.bool, msk)
    dst_mask = _local(dst_mask, dev, torch.bool, msk)
    t0 = initial_transform.astype(dt).to(dev)
    t = RigidTransform3(_local(t0.rot, dev, dt, [(pair, 0)]),
                        _local(t0.t, dev, dt, [(pair, 0)]) / s)
    normals, n_valid = estimate_normals_voxel(dst_s, dst_mask,
                                              normals_voxel_size / s)
    payload = build_p2l_payload(dst_s, normals, n_valid, dst_mask)

    def outer(t):
        src_t = t.apply_points(src_s)
        match, pay = ring_nearest_neighbor_matched(
            src_t, dst_s, dst_mask, sp.group, tile=config.nn_dst_tile,
            payload=payload)
        matched_n, matched, matched_ok = decode_p2l_payload(pay,
                                                            match.dist_sq)
        dt_ = align3d.estimate_transform_p2l(
            src_t, matched, matched_n, src_mask & matched_ok, config,
            group=sp.group)
        return dt_.compose(t), is_identity(dt_)

    t = fixed_point(lambda t, _aux, _warm: (*outer(t), None), t,
                    config.outer_iters, None)[0]
    return _gather_pairs(unscale_transform(t, s), pair)


def batched_icp2d(src, dst, src_mask, dst_mask,
                  initial_transform: RigidTransform2, config: ICPConfig,
                  mesh=None, pair_axis: str = "dp",
                  device="cuda") -> RigidTransform2:
    """Multi-pair 2D ICP: src (B, N, 2), dst (B, M, 2) or a shared (M, 2),
    masks to match, warm starts (B,)-batched or one shared.  Returns the
    (B,)-batched transforms.  Runs on ``device`` ("cuda" unless the caller
    asks for the CPU); with a ``mesh`` (a ``DeviceMesh``) on the mesh's
    device, each rank of ``pair_axis`` aligning its block of B / dp pairs
    and every rank returning all B."""
    if mesh is None:
        return icp2d(src, dst, src_mask, dst_mask, initial_transform,
                     config, device=device)
    pair = axis(check_mesh(mesh), pair_axis)
    dt = config.compute_dtype
    dev = mesh_device(mesh, dt)
    dst, dst_mask = torch.as_tensor(dst), torch.as_tensor(dst_mask)
    t0 = initial_transform.astype(dt).to(dev)

    def cut(x, dtype, batched: bool = True):
        return _local(x, dev, dtype, [(pair, 0)] if batched else [])

    # A shared db and a shared warm start stay whole on every rank.
    shared_db = dst.ndim == 2
    shared_t0 = t0.t.ndim == 1
    out = icp2d(cut(src, dt), cut(dst, dt, not shared_db),
                cut(src_mask, torch.bool),
                cut(dst_mask, torch.bool, not shared_db),
                RigidTransform2(cut(t0.rot, dt, not shared_t0),
                                cut(t0.t, dt, not shared_t0)),
                config, device=dev)
    return _gather_pairs(out, pair)
