"""Full-sequence SLAM: odometry + loop closures + pose graph, 2D and 3D
(BASELINE.json configs[2] and [4]; JAX package ``models/slam.py``).

``run_slam2d``:
1. every consecutive scan pair aligns in one batched ``icp2d`` call
   (identity warm start), giving the odometry chain;
2. loop-closure candidates are pose pairs closer than ``loop_radius``
   with index gap >= ``min_gap`` (host numpy, thinned to the closest per
   bucket and capped); all are verified by one more batched ``icp2d``
   warm-started from odometry and accepted when the post-alignment mean
   NN distance is within ``accept_factor`` x the median consecutive-pair
   distance;
3. the SE(2) pose graph (``models/pose_graph``, Cauchy-robust, dense
   solve, float64) fuses both.

``run_slam3d`` is the SE(3) analogue: consecutive point-to-plane ICP
(``models/icp_p2l``, voxel-PCA normals), each pair warm-started with the
previous relative motion, 3D proximity candidates verified one pair at a
time, and the 6-DoF pose graph.

The mean NN distances go through ``ops/nn.nearest_neighbor``: on the
kernel route kernel 6 for one frame of 3 db tiles or more, kernel 5 for
smaller frames and for batched pairs of more than 4096 points; batched
pairs of at most 4096 points take the plain sweep, as on the TPU.

``checkpoint`` (a ``utils.checkpoint.SequenceCheckpointer``) saves the
state as a flat npz at phase boundaries (and, in 3D, every K frames of the
odometry chain); ``resume=True`` skips what the checkpoint completed and
reproduces the uninterrupted result bitwise on the same device.

Entry points run on ``device`` ("cuda" by default; with no card they
raise unless the caller passes ``device="cpu"``).  The graph runs in
float64 on that device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.models.icp2d import icp2d
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
from icp_rust_tpu_torch.ops.nn import nearest_neighbor
from icp_rust_tpu_torch.utils import io as scan_io

GRAPH_DTYPE = torch.float64


class SlamResult(NamedTuple):
    poses: RigidTransform2       # optimized absolute poses (P,)
    odometry_path: np.ndarray    # (P, 2) dead-reckoned positions
    optimized_path: np.ndarray   # (P, 2) after graph optimization
    n_loop_closures: int
    error_before: float
    error_after: float


class Slam3Result(NamedTuple):
    poses: RigidTransform3       # optimized absolute poses (P,)
    odometry_path: np.ndarray    # (P, 3) dead-reckoned positions
    optimized_path: np.ndarray   # (P, 3) after graph optimization
    n_loop_closures: int
    error_before: float
    error_after: float


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pack_edges(extra_edges, dof: int) -> dict:
    """Loop-closure edges -> flat npz-able arrays (i, j, rot, t).  The
    information matrix is the constant 10 I by construction, so it is not
    stored."""
    dim = 2 if dof == 3 else 3
    if not extra_edges:
        return {
            "edge_i": np.zeros(0, np.int64),
            "edge_j": np.zeros(0, np.int64),
            "edge_rot": np.zeros((0, dim, dim)),
            "edge_t": np.zeros((0, dim)),
        }
    return {
        "edge_i": np.asarray([e[0] for e in extra_edges], np.int64),
        "edge_j": np.asarray([e[1] for e in extra_edges], np.int64),
        "edge_rot": np.stack([_numpy(e[2].rot) for e in extra_edges]),
        "edge_t": np.stack([_numpy(e[2].t) for e in extra_edges]),
    }


def _unpack_edges(state, tcls, dof: int, device) -> list:
    edges = []
    ii = state["edge_i"]
    for k in range(ii.shape[0]):
        z = tcls(
            torch.as_tensor(state["edge_rot"][k], dtype=GRAPH_DTYPE,
                            device=device),
            torch.as_tensor(state["edge_t"][k], dtype=GRAPH_DTYPE,
                            device=device),
        )
        edges.append((int(ii[k]), int(state["edge_j"][k]), z,
                      10.0 * np.eye(dof)))
    return edges


def _mean_nn_dist(src, dst, src_mask, dst_mask, t, config: ICPConfig):
    """Mean NN distance of the valid src points mapped by ``t`` into dst
    (per pair for a batch)."""
    src_t = t.apply_points(src.to(config.compute_dtype))
    res = nearest_neighbor(src_t, dst.to(config.compute_dtype), dst_mask,
                           backend=config.nn_backend,
                           tile=config.nn_dst_tile)
    d = torch.sqrt(torch.clamp(res.dist_sq, min=0.0))
    w = src_mask.to(d.dtype)
    return torch.sum(d * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                  min=1.0)


def _candidates(odo_path: np.ndarray, loop_radius: float, min_gap: int,
                max_loop_candidates: int) -> list:
    """Pose pairs (i < j) within ``loop_radius`` with index gap >=
    ``min_gap``, closest first, one per (i // (gap/2), j // (gap/2))
    bucket, at most ``max_loop_candidates``."""
    f = odo_path.shape[0]
    d2 = ((odo_path[:, None, :] - odo_path[None, :, :]) ** 2).sum(-1)
    ii, jj = np.nonzero(
        (d2 < loop_radius ** 2)
        & (np.abs(np.arange(f)[:, None] - np.arange(f)[None, :]) >= min_gap)
    )
    keep = ii < jj
    cand = sorted(zip(ii[keep].tolist(), jj[keep].tolist()),
                  key=lambda p: d2[p[0], p[1]])
    seen_bucket = set()
    picked = []
    bucket = max(min_gap // 2, 1)
    for i, j in cand:
        b = (i // bucket, j // bucket)
        if b in seen_bucket:
            continue
        seen_bucket.add(b)
        picked.append((i, j))
        if len(picked) >= max_loop_candidates:
            break
    return picked


def _integrate(rel_inv, tcls, dim: int, config: ICPConfig, device):
    """Dead-reckoned absolute poses from the inverted relative chain:
    pose_{k+1} = pose_k o rel_k^-1."""
    rots = [torch.eye(dim, dtype=config.compute_dtype, device=device)]
    ts = [torch.zeros(dim, dtype=config.compute_dtype, device=device)]
    for k in range(rel_inv.t.shape[0]):
        nxt = tcls(rots[-1], ts[-1]).compose(tcls(rel_inv.rot[k],
                                                  rel_inv.t[k]))
        rots.append(nxt.rot)
        ts.append(nxt.t)
    return tcls(torch.stack(rots), torch.stack(ts))


def _solve_graph(rel_inv, extra_edges, graph_iters: int):
    """The pose graph of the chain plus the loop edges, before and after
    the dense Cauchy-robust Gauss-Newton solve."""
    chain = rel_inv.astype(GRAPH_DTYPE)
    graph = pg.odometry_chain_graph(chain, extra_edges=extra_edges)
    e0 = float(pg.graph_error(graph))
    out = pg.optimize(graph, iters=graph_iters, solve="dense", huber_k=1.345,
                      kernel="cauchy")
    return out, e0, float(pg.graph_error(out))


def _batched_icp(src, dst, src_mask, dst_mask, config: ICPConfig, device):
    """All pairs in one batched icp2d call from the identity."""
    t0 = RigidTransform2.identity((src.shape[0],), config.compute_dtype,
                                  device)
    return icp2d(src, dst, src_mask, dst_mask, t0, config, device=device)


def run_slam2d(frames, config: ICPConfig = ICPConfig(),
               loop_radius: float = 300.0, min_gap: int = 20,
               max_loop_candidates: int = 64, accept_factor: float = 2.0,
               graph_iters: int = 20, checkpoint=None, resume: bool = False,
               device="cuda") -> SlamResult:
    """2D SLAM over frames, a sequence of (N_i, 2) scans (ragged ok).

    ``checkpoint``/``resume``: the record is written after verification
    (phase 1: relative chain + edges) and after the graph solve (phase 2:
    + optimized poses); resume skips completed phases."""
    dev = resolve_device(device, config.compute_dtype)
    pts_np, mask_np = scan_io.pad_points(frames)
    pts = torch.as_tensor(pts_np).to(device=dev, dtype=config.compute_dtype)
    mask = torch.as_tensor(mask_np).to(dev)
    f = pts.shape[0]

    saved = None
    if resume and checkpoint is not None:
        st = checkpoint.restore()
        if (st is not None and "rel_rot" in st
                and int(st.get("slam_phase", 0)) >= 1
                and int(st["rel_rot"].shape[0]) == f - 1):
            saved = st

    # 1. Odometry: all consecutive pairs in one batched solve.
    if saved is not None:
        rel = RigidTransform2(
            torch.as_tensor(saved["rel_rot"]).to(dev, config.compute_dtype),
            torch.as_tensor(saved["rel_t"]).to(dev, config.compute_dtype))
    else:
        rel = _batched_icp(pts[:-1], pts[1:], mask[:-1], mask[1:], config,
                           dev)
    # rel[k] maps frame k points into frame k+1.
    rel_inv = rel.inverse()
    odo_poses = _integrate(rel_inv, RigidTransform2, 2, config, dev)
    odo_path = _numpy(odo_poses.t).astype(np.float64)

    def _state2(phase, extra_edges):
        return {"slam_phase": phase, "rel_rot": rel.rot, "rel_t": rel.t,
                **_pack_edges(extra_edges, 3)}

    if saved is not None:
        extra_edges = _unpack_edges(saved, RigidTransform2, 3, dev)
        picked = None
    else:
        # Baseline alignment quality: consecutive post-ICP NN distance.
        base_nn = _mean_nn_dist(pts[:-1], pts[1:], mask[:-1], mask[1:], rel,
                                config)
        accept_thresh = accept_factor * float(np.median(_numpy(base_nn)))
        # 2. Loop-closure candidates from odometry proximity.
        picked = _candidates(odo_path, loop_radius, min_gap,
                             max_loop_candidates)
        extra_edges = []
    if picked:
        ci = torch.as_tensor([p[0] for p in picked], device=dev)
        cj = torch.as_tensor([p[1] for p in picked], device=dev)
        # Verify all candidates in one batched ICP warm-started from
        # odometry (host numpy, as the JAX package forms it).
        o_rot, o_t = _numpy(odo_poses.rot), _numpy(odo_poses.t)
        init = RigidTransform2(
            torch.as_tensor(np.stack([o_rot[j].T @ o_rot[i]
                                      for i, j in picked])).to(
                dev, config.compute_dtype),
            torch.as_tensor(np.stack([o_rot[j].T @ (o_t[i] - o_t[j])
                                      for i, j in picked])).to(
                dev, config.compute_dtype))
        t_ij = icp2d(pts[ci], pts[cj], mask[ci], mask[cj], init, config,
                     device=dev)
        nn_after = _numpy(_mean_nn_dist(pts[ci], pts[cj], mask[ci],
                                        mask[cj], t_ij, config))
        for k, (i, j) in enumerate(picked):
            if nn_after[k] <= accept_thresh:
                # t_ij maps frame-i points into frame j: z_ij (T_i^-1 T_j
                # convention) = t_ij^-1.
                z = RigidTransform2(t_ij.rot[k], t_ij.t[k]).inverse()
                extra_edges.append((i, j, z.astype(GRAPH_DTYPE),
                                    10.0 * np.eye(3)))
    if saved is None and checkpoint is not None:
        checkpoint.save(f - 1, _state2(1, extra_edges))

    # 3. Pose graph: chain measurements z_k = rel_k^-1 (T_k^-1 T_{k+1}).
    out, e0, e1 = _solve_graph(rel_inv, extra_edges, graph_iters)
    if checkpoint is not None:
        checkpoint.save(f - 1, {**_state2(2, extra_edges),
                                "pose_rot": out.poses.rot,
                                "pose_t": out.poses.t})
    return SlamResult(
        poses=out.poses,
        odometry_path=odo_path,
        optimized_path=_numpy(out.poses.t).astype(np.float64),
        n_loop_closures=len(extra_edges),
        error_before=e0,
        error_after=e1,
    )


def run_slam3d(frames, config: ICPConfig = ICPConfig(),
               loop_radius: float = 1.0, min_gap: int = 8,
               max_loop_candidates: int = 16, accept_factor: float = 2.0,
               graph_iters: int = 15, normals_voxel_size: float = 0.3,
               checkpoint=None, resume: bool = False,
               device="cuda") -> Slam3Result:
    """SE(3) SLAM: p2l odometry chain + proximity loop closures + graph.

    frames: sequence of (N_i, 3) scans (ragged ok).  ``checkpoint`` saves
    the chain every K frames (relative transforms + warm-start cursor),
    once after loop-closure verification (edges) and once after the graph
    solve (optimized poses + edges + cursor).  ``resume=True`` seeks past
    whatever phase the checkpoint reached; a phase-1/2 record whose chain
    does not cover the whole sequence (a crash mid-odometry on a shorter
    run) is detected by its length and the edges are recomputed."""
    dev = resolve_device(device, config.compute_dtype)
    dt = config.compute_dtype
    pts_np, mask_np = scan_io.pad_points(frames)
    pts = torch.as_tensor(pts_np).to(device=dev, dtype=dt)
    mask = torch.as_tensor(mask_np).to(dev)
    f = pts.shape[0]
    step = functools.partial(icp_point_to_plane, config=config,
                             normals_voxel_size=normals_voxel_size,
                             device=dev)

    # 1. Odometry chain: rel[k] maps frame-k points into frame k+1.
    rels = []
    t = RigidTransform3.identity(dtype=dt, device=dev)
    start_k = 0
    saved_edges = None
    if resume and checkpoint is not None:
        st = checkpoint.restore()
        if st is not None and "rel_rot" in st:
            n_rel = int(st["rel_rot"].shape[0])
            for k in range(n_rel):
                rels.append(RigidTransform3(
                    torch.as_tensor(st["rel_rot"][k]).to(dev, dt),
                    torch.as_tensor(st["rel_t"][k]).to(dev, dt)))
            t = RigidTransform3(torch.as_tensor(st["t_rot"]).to(dev, dt),
                                torch.as_tensor(st["t_t"]).to(dev, dt))
            start_k = n_rel
            if int(st.get("slam_phase", 0)) >= 1 and n_rel == f - 1:
                saved_edges = _unpack_edges(st, RigidTransform3, 6, dev)

    def _chain_state(phase):
        return {"slam_phase": phase,
                "rel_rot": torch.stack([r.rot for r in rels]),
                "rel_t": torch.stack([r.t for r in rels]),
                "t_rot": t.rot, "t_t": t.t}

    for k in range(start_k, f - 1):
        # Warm start: the previous relative motion.
        t = step(pts[k], pts[k + 1], mask[k], mask[k + 1], t)
        rels.append(t)
        if checkpoint is not None:
            checkpoint.maybe_save(k, _chain_state(0))
    rel = RigidTransform3(torch.stack([r.rot for r in rels]),
                          torch.stack([r.t for r in rels]))
    rel_inv = rel.inverse()
    odo_poses = _integrate(rel_inv, RigidTransform3, 3, config, dev)
    odo_path = _numpy(odo_poses.t).astype(np.float64)

    if saved_edges is not None:
        extra_edges = saved_edges
    else:
        # Baseline alignment quality for the accept threshold.
        base_nn = _numpy(torch.stack([
            _mean_nn_dist(pts[k], pts[k + 1], mask[k], mask[k + 1],
                          RigidTransform3(rel.rot[k], rel.t[k]), config)
            for k in range(f - 1)]))
        accept_thresh = accept_factor * float(np.median(base_nn))
        # 2. Loop-closure candidates from odometry proximity (3D).
        extra_edges = []
        for i, j in _candidates(odo_path, loop_radius, min_gap,
                                max_loop_candidates):
            # Warm start from odometry: t_ij takes frame-i points into
            # frame j.
            pj = RigidTransform3(odo_poses.rot[j], odo_poses.t[j])
            pi = RigidTransform3(odo_poses.rot[i], odo_poses.t[i])
            t_ij = step(pts[i], pts[j], mask[i], mask[j],
                        pj.inverse().compose(pi))
            nn_after = float(_mean_nn_dist(pts[i], pts[j], mask[i], mask[j],
                                           t_ij, config))
            if nn_after <= accept_thresh:
                # z_ij in the graph's T_i^-1 T_j convention = t_ij^-1.
                extra_edges.append((i, j, t_ij.inverse().astype(GRAPH_DTYPE),
                                    10.0 * np.eye(6)))
        if checkpoint is not None:
            checkpoint.save(f - 1, {**_chain_state(1),
                                    **_pack_edges(extra_edges, 6)})

    # 3. SE(3) pose graph.
    out, e0, e1 = _solve_graph(rel_inv, extra_edges, graph_iters)
    if checkpoint is not None:
        checkpoint.save(f - 1, {**_chain_state(2),
                                **_pack_edges(extra_edges, 6),
                                "pose_rot": out.poses.rot,
                                "pose_t": out.poses.t})
    return Slam3Result(
        poses=out.poses,
        odometry_path=odo_path,
        optimized_path=_numpy(out.poses.t).astype(np.float64),
        n_loop_closures=len(extra_edges),
        error_before=e0,
        error_after=e1,
    )
