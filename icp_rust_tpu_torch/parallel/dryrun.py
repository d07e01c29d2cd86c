"""A world of ranks on one host, and the multi-rank dry run (the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

``spawn(fn, world, backend, device_type, timeout_s)`` starts ``world``
processes with ``torch.multiprocessing``'s spawn method (never fork: a
parent may have initialised CUDA), joins them into one process group
through a ``file://`` rendezvous in a fresh temporary directory (parallel
test workers never share a port), runs ``fn(*args)`` on every rank and
returns, per rank, what it returned and its ``cuda_build.LAUNCHES`` (each
process counts only its own launches).  The process group gets the
timeout and the parent joins with a deadline, so a rank that fails, dies
or deadlocks fails the call instead of hanging it.  ``fn`` must be a
module-level function (it is pickled by name) and returns host values
(tensors come back on the CPU).

``dryrun_multichip(n_ranks, device_type)`` runs the JAX dry run's five
programs on a (dp, sp) mesh of n_ranks gloo ranks with its value checks:
2D and 3D-planar dp x sp ICP within 1e-5 of the unsharded driver and 2e-2
of the true motion; point-to-plane dp x sp within 5e-3 of the truth
(applied points) and 2e-2 of the unsharded driver; the edge-sharded pose
graph (SE(2) and SE(3)) within 1e-4 of the local CG solve, and the
segment-sharded Schur solve within 1e-4 of the local one.

    python -c "from icp_rust_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch

from icp_rust_tpu_torch.parallel.mesh import require_device


def _to_host(x):
    """Tensors (inside transforms, tuples, lists and dicts) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _to_host(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to_host(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, backend, device_type, init_method, timeout_s,
               threads, call_path, results):
    import torch.distributed as dist

    from icp_rust_tpu_torch.ops import cuda_build
    from icp_rust_tpu_torch.parallel.mesh import initialize_distributed

    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)  # written by spawn() in this call
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize_distributed(
            backend=backend, init_method=init_method, world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        cuda_build.reset_launches()
        # Pickled here, not by the queue: the queue would share a CPU
        # tensor's storage by a file descriptor that dies with this rank.
        out = pickle.dumps(_to_host(fn(*args)))
        if device_type == "cuda":
            torch.cuda.synchronize()
        results.put((rank, True, out, dict(cuda_build.LAUNCHES)))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@dataclasses.dataclass
class RankResult:
    value: object    # what fn returned on this rank
    launches: dict   # this rank's cuda_build.LAUNCHES after fn


def spawn(fn, world: int, backend: str = "gloo", device_type: str = "cuda",
          timeout_s: float = 300.0, args=(), threads: int | None = None):
    """Run ``fn(*args)`` on ``world`` spawned ranks; returns a list of
    ``RankResult`` by rank.  Raises RuntimeError with the failing rank's
    traceback when a rank fails or dies, and TimeoutError when the world
    has not finished within ``timeout_s`` (its processes are killed).
    ``threads``: torch's intra-op threads a rank.  ``device_type`` "cuda"
    (the default) puts rank r on card r mod the card count and needs a
    card; pass "cpu" to run on the CPU."""
    require_device(device_type)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # The call goes through a file, not the start pipe: a rank that
        # dies while starting then cannot block start() on a full pipe.
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(
            target=_rank_main,
            args=(rank, world, backend, device_type, init, timeout_s,
                  threads, call_path, results), daemon=True)
            for rank in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < world:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks not done within "
                                       f"{timeout_s} s (done: {sorted(got)})")
                try:
                    rank, ok, value, launches = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = RankResult(pickle.loads(value), launches)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            results.close()
    return [got[r] for r in range(world)]


def _check(name, got, ref, atol, errors):
    got, ref = np.asarray(got), np.asarray(ref)
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float(np.abs(got - ref).max())
    if not err <= atol:
        raise AssertionError(f"{name}: sharded-vs-reference mismatch "
                             f"{err:.3e} > {atol:g}")
    errors[name] = err


def dryrun_programs(device_type: str = "cuda") -> dict:
    """The dry run's five programs on this rank, on a (dp, sp) mesh of the
    initialized world (dp 2 when the world is even, else 1), each checked
    against its unsharded counterpart on this rank and, where there is
    one, the true motion.  Returns {check: max abs error}.  The card's
    sweeps take db tiles of 128 points and more, so the ring's tile is 128
    there (16, the JAX dry run's, on the CPU)."""
    import torch.distributed as dist

    require_device(device_type)

    from icp_rust_tpu_torch.config import ICPConfig
    from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
    from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
    from icp_rust_tpu_torch.models import pose_graph as pg
    from icp_rust_tpu_torch.models.graph_schur import optimize_schur
    from icp_rust_tpu_torch.models.icp2d import icp2d, icp3d_planar
    from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
    from icp_rust_tpu_torch.parallel.dist_graph import optimize_distributed
    from icp_rust_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from icp_rust_tpu_torch.parallel.sharded import dp_sp_icp2d, \
        dp_sp_icp3d_planar, dp_sp_icp_p2l

    n_ranks = dist.get_world_size()
    dp = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    sp = n_ranks // dp
    mesh = make_mesh(("dp", "sp"), (dp, sp), device_type=device_type)
    dev = device_type
    f32 = torch.float32
    tile = 16 if device_type == "cpu" else 128
    cfg = ICPConfig(compute_dtype=f32, det_rel_eps=1e-9, outer_iters=2,
                    inner_max_iter=10, nn_dst_tile=tile)
    b, n = 2 * dp, 16 * sp
    rng = np.random.default_rng(0)
    errors: dict = {}

    def t32(x):
        return torch.as_tensor(np.asarray(x), dtype=f32)

    # True planar motion with per-point noise (a noise-free shift makes
    # every residual equal, MAD 0, and the robust update freezes).
    ang = 0.03
    rot_true = np.array([[np.cos(ang), -np.sin(ang)],
                         [np.sin(ang), np.cos(ang)]], np.float32)
    shift = np.array([0.05, -0.02], np.float32)
    noise = 0.005

    # 1. 2D ICP, pairs dp x points sp.
    src = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    dst = (np.einsum("ij,bnj->bni", rot_true, src) + shift
           + rng.normal(0, noise, (b, n, 2))).astype(np.float32)
    mask = torch.ones((b, n), dtype=torch.bool)
    t0 = RigidTransform2.identity((b,), f32)
    t = dp_sp_icp2d(src, dst, mask, mask, t0, cfg, mesh)
    ref = icp2d(src, dst, mask, mask, t0, cfg, device=dev)
    _check("2D dp x sp vs unsharded (rot)", t.rot.cpu(), ref.rot.cpu(),
           1e-5, errors)
    _check("2D dp x sp vs unsharded (t)", t.t.cpu(), ref.t.cpu(), 1e-5,
           errors)
    _check("2D dp x sp vs ground truth (t)", t.t.cpu(),
           np.broadcast_to(shift, (b, 2)), 2e-2, errors)
    _check("2D dp x sp vs ground truth (rot)", t.rot.cpu(),
           np.broadcast_to(rot_true, (b, 2, 2)), 2e-2, errors)

    # 2. The headline workload: 3D matching, SE(2) on xy, dp x sp.
    src3 = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    dst3 = src3.copy()
    dst3[..., :2] = (np.einsum("ij,bnj->bni", rot_true, src3[..., :2])
                     + shift + rng.normal(0, noise, (b, n, 2)))
    t3 = dp_sp_icp3d_planar(src3, dst3, mask, mask, t0, cfg, mesh)
    ref3 = icp3d_planar(src3, dst3, mask, mask, t0, cfg, device=dev)
    _check("3D-planar dp x sp vs unsharded (rot)", t3.rot.cpu(),
           ref3.rot.cpu(), 1e-5, errors)
    _check("3D-planar dp x sp vs unsharded (t)", t3.t.cpu(), ref3.t.cpu(),
           1e-5, errors)
    _check("3D-planar dp x sp vs ground truth (t)", t3.t.cpu(),
           np.broadcast_to(shift, (b, 2)), 2e-2, errors)
    _check("3D-planar dp x sp vs ground truth (rot)", t3.rot.cpu(),
           np.broadcast_to(rot_true, (b, 2, 2)), 2e-2, errors)

    # 3. SE(3) point-to-plane, dp x sp: points on a box's faces constrain
    # all 6 DoF and dst = T_true(src) exactly.  Per-shard voxel grids make
    # the unsharded comparison a tolerance.
    t_true = RigidTransform3.from_twist(
        t32([0.04, -0.03, 0.02, 0.02, -0.015, 0.025]))
    n_p2l = 128 * sp
    cfg_p2l = cfg.with_(outer_iters=4)
    per = -(-n_p2l // 6)
    box = []
    for ax in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-1, 1, (per, 3))
            p[:, ax] = sign
            box.append(p)
    box = np.concatenate(box)[:n_p2l]
    src_p = t32(np.stack([box[rng.permutation(n_p2l)] for _ in range(b)]))
    dst_p = t_true.apply_points(src_p)
    mask_p = torch.ones((b, n_p2l), dtype=torch.bool)
    tp = dp_sp_icp_p2l(src_p, dst_p, mask_p, mask_p,
                       RigidTransform3.identity((b,), f32), cfg_p2l, mesh,
                       normals_voxel_size=0.5)
    _check("p2l dp x sp vs ground truth (applied points)",
           tp.to("cpu").apply_points(src_p), t_true.apply_points(src_p), 5e-3,
           errors)
    refs = [icp_point_to_plane(src_p[k], dst_p[k], mask_p[k], mask_p[k],
                               RigidTransform3.identity(dtype=f32), cfg_p2l,
                               normals_voxel_size=0.5, device=dev).to("cpu")
            for k in range(b)]
    _check("p2l dp x sp vs unsharded (t)", tp.t.cpu(),
           torch.stack([r.t for r in refs]), 2e-2, errors)
    _check("p2l dp x sp vs unsharded (rot)", tp.rot.cpu(),
           torch.stack([r.rot for r in refs]), 2e-2, errors)

    # 4. Edge-sharded pose graphs (SE(2) and SE(3)) against the local CG,
    # and the segment-sharded Schur solve against the local one.
    for tcls, dof in ((RigidTransform2, 3), (RigidTransform3, 6)):
        n_poses = 6
        tw = np.zeros((n_poses - 1, dof))
        tw[:, 0] = 0.1
        tw[:, -1] = 0.2
        graph = pg.graph_to(pg.odometry_chain_graph(tcls.from_twist(
            torch.as_tensor(tw))), mesh_device(mesh))
        out = optimize_distributed(graph, mesh, iters=2, cg_iters=10,
                                   edge_axis="dp")
        out_ref = pg.optimize(graph, iters=2, solve="cg", cg_iters=10)
        _check(f"dist graph dof={dof} vs local CG (t)", out.poses.t.cpu(),
               out_ref.poses.t.cpu(), 1e-4, errors)
        _check(f"dist graph dof={dof} vs local CG (rot)",
               out.poses.rot.cpu(), out_ref.poses.rot.cpu(), 1e-4, errors)
        out_s = optimize_schur(graph, iters=2, mesh=mesh, seg_axis="dp")
        out_s_ref = optimize_schur(graph, iters=2)
        _check(f"dist schur dof={dof} vs local Schur (t)",
               out_s.poses.t.cpu(), out_s_ref.poses.t.cpu(), 1e-4, errors)
        _check(f"dist schur dof={dof} vs local Schur (rot)",
               out_s.poses.rot.cpu(), out_s_ref.poses.rot.cpu(), 1e-4,
               errors)
    return errors


def dryrun_multichip(n_ranks: int = 4, device_type: str = "cuda",
                     timeout_s: float = 600.0):
    """The dry run on ``n_ranks`` spawned gloo ranks sharing this host's
    device: "cuda" (the default) puts them all on the card (NCCL refuses
    two ranks on one card) and needs one; "cpu" runs one torch thread a
    rank.  Returns the ``RankResult``s, each value the rank's {check: max
    abs error}; raises if a rank fails a check."""
    return spawn(dryrun_programs, n_ranks, "gloo", device_type, timeout_s,
                 args=(device_type,),
                 threads=1 if device_type == "cpu" else None)
