"""The rank side of tests/test_torch_parallel.py: the programs that every
rank of a spawned gloo world runs on the inputs the test made (numpy
arrays), returning the port's sharded results.  It imports no JAX, so a
rank starts with torch and the port alone."""

import numpy as np
import torch
import torch.distributed

from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.models.graph_schur import optimize_schur
from icp_rust_tpu_torch.parallel import dist_graph, dryrun, mesh, ring_nn, \
    sharded

F32_CONFIG = ICPConfig(compute_dtype=torch.float32)
CONFIGS = {"f64": REFERENCE_CONFIG, "f32": F32_CONFIG}


def _graph(arrays):
    return convert.pose_graph_from_numpy(*arrays)


def _np(t):
    return t.rot.numpy(), t.t.numpy()


def run_icp_cases(inputs: dict) -> dict:
    """The ICP cases on this rank: ring NN on a 4-rank point axis (this
    rank's block of the queries) and the sharded drivers."""
    sp4 = mesh.make_mesh(("sp",), (4,), device_type="cpu")
    dp4 = mesh.make_mesh(("dp",), (4,), device_type="cpu")
    grid = mesh.make_mesh(("dp", "sp"), (2, 2), device_type="cpu")
    sp = mesh.axis(sp4, "sp")
    out = {}

    q, db, dbm = (torch.as_tensor(inputs["ring"][k])
                  for k in ("q", "db", "dbm"))
    q_l, db_l, dbm_l = (mesh.block(x, sp, 0) for x in (q, db, dbm))
    res = ring_nn.ring_nearest_neighbor(q_l, db_l, dbm_l, sp.group)
    res_m, matched = ring_nn.ring_nearest_neighbor_matched(
        q_l, db_l, dbm_l, sp.group)
    out["ring"] = (res.index.numpy(), res.dist_sq.numpy())
    out["ring_matched"] = (res_m.index.numpy(), res_m.dist_sq.numpy(),
                           matched.numpy())

    src, dst, mask = inputs["estimate"]
    out["estimate"] = _np(sharded.sharded_estimate_transform(
        src, dst, mask, REFERENCE_CONFIG, sp4))
    src, dst, mask = inputs["icp2d"]
    out["icp2d"] = _np(sharded.sharded_icp2d(
        src, dst, mask, mask, RigidTransform2.identity(dtype=torch.float64),
        REFERENCE_CONFIG, sp4))
    src, dst, mask = inputs["batched"]
    out["batched"] = _np(sharded.batched_icp2d(
        src, dst, mask, mask,
        RigidTransform2.identity((src.shape[0],), torch.float64),
        REFERENCE_CONFIG, mesh=dp4))

    for name, fn in (("dp_sp_icp2d", sharded.dp_sp_icp2d),
                     ("dp_sp_icp3d_planar", sharded.dp_sp_icp3d_planar)):
        src, dst, mask = inputs[name]
        for dt, cfg in CONFIGS.items():
            out[f"{name}-{dt}"] = _np(fn(
                src, dst, mask, mask,
                RigidTransform2.identity((src.shape[0],),
                                         cfg.compute_dtype),
                cfg, grid))
    src, dst, mask = inputs["p2l"]
    out["p2l"] = _np(sharded.dp_sp_icp_p2l(
        src, dst, mask, mask,
        RigidTransform3.identity((src.shape[0],), torch.float64),
        ICPConfig(compute_dtype=torch.float64), grid,
        normals_voxel_size=0.5))
    return out


def run_cases(inputs: dict) -> dict:
    """Every case on this rank: the ICP cases, the graph cases and the
    dry run's programs (``dryrun_multichip``'s per-rank body)."""
    return {**run_icp_cases(inputs), **run_graph_cases(inputs),
            "dryrun": dryrun.dryrun_programs("cpu")}


def run_graph_cases(inputs: dict) -> dict:
    """The edge-sharded (CG) and segment-sharded (Schur) graph solves on
    this rank, with the local Schur solve beside the sharded one, and on
    rank 0 the local CG solve beside the edge-sharded one."""
    dp4 = mesh.make_mesh(("dp",), (4,), device_type="cpu")
    out = {}
    for name, kw in (("dist2d", dict(iters=15, cg_iters=100)),
                     ("dist3d", dict(iters=15, cg_iters=150))):
        graph = _graph(inputs[name])
        g = dist_graph.optimize_distributed(graph, dp4, **kw)
        out[name] = (g.poses.rot.numpy(), g.poses.t.numpy())
        if torch.distributed.get_rank() == 0:
            local = pg.optimize(graph, solve="cg", **kw)
            out[f"{name}-local"] = (local.poses.rot.numpy(),
                                    local.poses.t.numpy())
    for name in ("schur2d", "schur3d"):
        graph = _graph(inputs[name])
        g = optimize_schur(graph, iters=12, mesh=dp4)
        local = optimize_schur(graph, iters=12)
        out[name] = (g.poses.rot.numpy(), g.poses.t.numpy(),
                     local.poses.rot.numpy(), local.poses.t.numpy())
    return out


def frame_pair(n_pad: int = 28800):
    """Frames 0 and 1 of the synthetic sequence at full width, padded:
    (points (2, N, 3) float32, masks (2, N))."""
    from icp_rust_tpu_torch.utils import io

    frames, _ = io.synthesize_frames3d(2, seed=0)
    pts, mask = io.pad_points(frames, pad_to=n_pad)
    return pts.astype(np.float32), mask


def ring_on_card(pts, mask, tile: int = 2048) -> bool:
    """On this rank of a 4-rank world on the card: the ring, plain and
    matched, of frame 1's block of queries against frame 0 sharded,
    bitwise the port's search over the whole of frame 0."""
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    row = mesh.make_mesh(("dp", "sp"), (1, 4), device_type="cuda")
    sp = mesh.axis(row, "sp")
    dev = torch.device("cuda", torch.cuda.current_device())
    q = mesh.block(torch.as_tensor(pts[1], device=dev), sp, 0)
    db = torch.as_tensor(pts[0], device=dev)
    dbm = torch.as_tensor(mask[0], device=dev)
    db_l, dbm_l = mesh.block(db, sp, 0), mesh.block(dbm, sp, 0)
    plain = ring_nn.ring_nearest_neighbor(q, db_l, dbm_l, sp.group,
                                          tile=tile)
    res, pay = ring_nn.ring_nearest_neighbor_matched(q, db_l, dbm_l,
                                                     sp.group, tile=tile)
    idx, dist, want = nn_sweep_cuda.search(q, db, dbm, db, db_tile=tile)
    return all(torch.equal(a, b) for a, b in (
        (plain.index, idx), (plain.dist_sq, dist), (res.index, idx),
        (res.dist_sq, dist), (pay, want)))


def dp_sp_pair_on_card(pts, mask, tile: int = 2048):
    """``dp_sp_icp3d_planar`` of the pair (src frame 0, dst frame 1) on a
    (1, 4) mesh of this world on the card."""
    row = mesh.make_mesh(("dp", "sp"), (1, 4), device_type="cuda")
    cfg = ICPConfig(det_rel_eps=1e-9, nn_dst_tile=tile)
    t = sharded.dp_sp_icp3d_planar(pts[None, 0], pts[None, 1],
                                   mask[None, 0], mask[None, 1],
                                   RigidTransform2.identity((1,)), cfg, row)
    return t.rot[0].cpu().numpy(), t.t[0].cpu().numpy()
