#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the fourteen Hopper kernels from ``icp_rust_tpu_torch/csrc`` (one
``nvcc`` per source, started together; prints the ptxas register and
spill lines), then runs these phases; any failure exits non-zero:

1. nn_list (survivor-list exact 1-NN) vs its plain version at the main
   path's shapes (frames 0 and 1 of the synthetic sequence, 28,800
   points, xy payload, Morton-sorted): the cold bound, the warm bound of
   one real outer step, a forced full sweep, a masked db and exact ties.
   Indices, distances and payload must be bitwise equal, and equal to a
   brute-force sweep.
2. irls_loop vs its plain version on frame 1's first-iteration
   correspondences (N = 28,800): rot and t within IRLS_TOL.
3. icp2d_frame vs its plain version on a 640-point synthetic 2D pair
   padded to 768: rot and t within FRAME_TOL.
4. The main path: ``run_odometry_fused`` over 96 synthetic 28,800-point
   frames, run twice (the second run is the timed one); ATE against
   ground truth < 0.05 m, and the plain path on the card over the first 8
   frames within 1 mm of the kernel path.
5. A 2D sequence of 640-point scans padded to 768 through ``icp2d``,
   whose whole-frame kernel serves every frame; ATE < 0.05 m and within
   1 mm of the plain path.

The batched multi-pair path runs on 209 consecutive pairs of 210 synthetic
2D scans the size of the reference's scans/2d (the xy of synthetic
frames, each subsampled to a seeded count in 411-670 points, padded to
768):

6. nn_pairs and nn_pairs_list (pair-grid exact 1-NN) vs their plain
   versions at the batched path's shapes (xy payload, Morton-sorted): cold
   +inf bounds, the warm bounds of one real outer step, a masked db, exact
   ties, and 4 pairs at the 4096-point db limit.  Indices, distances and
   payload must be bitwise equal, and equal to a brute-force sweep.
7. irls_loop_batched vs its plain version on the 209 pairs' first-iteration
   correspondences, plus an all-masked pair and a one-point pair: rot and
   t within IRLS_TOL per pair; prints the iteration counts.
8. icp2d_frame_pairs vs its plain version on the 209 unsorted pairs: rot
   and t within FRAME_TOL per pair, equal outer iteration counts.
9. The batched path: ``parallel.sharded.batched_icp2d`` with
   ``frame_backend="auto"`` run twice (the second run is timed): pairs/s,
   per-pair error against the ground-truth relative transforms (gate: max
   translation error < 0.05 m), launch counts (1 nn_pairs, K - 1
   nn_pairs_list, K irls_loop_batched for K outer iterations); the plain
   path on the card within 1 mm per pair with no launch; then
   ``frame_backend="pairs"``: one icp2d_frame_pairs launch, within 1 mm
   per pair of the lockstep path.

The SE(3) point-to-plane path runs on the main path's frames (the
workload of benchmarks/bench_p2l.py), with voxel normals at 0.3 m:

10. nn_list at the p2l payload (D = 3, F = 4: [n, c = n . q]) on frames 0
    and 1, Morton-sorted: the cold bound, the warm bound of one real p2l
    outer step, and a masked db whose invalid normals carry the sentinel
    c.  Bitwise equal to the plain version and to brute force.
11. p2l_loop vs its plain version on frame 1's first-iteration
    correspondences (N = 28,800): rot and t within IRLS_TOL, equal
    iteration counts; one plane, five points, sigma = 0 and an all-masked
    input each stop at iteration 1 with the identity, in both.
12. p2l_stats vs its plain version at the identity and at one warm
    transform, through ``align3d.weighted_gn_update_p2l_cuda``: the 27
    sums and the error within P2L_STATS_TOL relative, the count exact,
    sigma within P2L_SIGMA_TOL relative.
13. The p2l path: ``run_odometry_p2l_fused`` over the 96 frames, run
    twice (bitwise equal; the second run is timed): frames/s, ATE-xy < 0.05
    m and max |z| < 0.05 m against ground truth, outer iterations, and
    nn_list and p2l_loop launches each equal to the total outer
    iterations; the plain path on the card (torch NN and the LU loop of
    ``align_backend="torch"``) over the first 8 frames within 1 mm, with
    no launch.

The full-sequence SLAM paths:

14. nn_sweep, nn_matched and nn_pruned (kernels 5, 4 and 6: exact 1-NN
    sweeps without survivor lists) vs their plain versions and a
    brute-force sweep, bitwise (dist, idx, payload): nn_pruned at
    run_slam3d's full width (frames 0 and 1 as it pads them, 28,160
    points, unsorted and Morton-sorted), with exact ties, a masked db,
    the p2l payload unseeded and a fully masked db; nn_sweep and
    nn_matched (p2l payload) on 3072-point frames, fully masked dbs, and
    8 pairs of full xy scans with a batch axis (xy payload).
15. ``run_slam3d`` over the 96 frames with its defaults (loop radius 1 m,
    gap 8, at most 16 candidates, voxel normals at 0.3 m), twice (the
    second run timed): frames/s, candidates, closures (gate >= 1), graph
    error (gate: after <= before), ATE-xy of the optimized path (gate <
    0.05 m), launches (nn_pruned once per consecutive pair and verified
    candidate); the kernel and the plain path on the first 12 frames
    within 1 mm, the plain one with no launch.
16. ``run_slam3d`` on the room-and-ramp loop of the JAX package's
    tests/test_slam3d.py (28 poses of 3072 points): nn_matched and
    nn_sweep launch, nn_pruned and nn_list do not; >= 1 closure; the end
    error of the optimized path <= max(0.8 x odometry's, 0.02 m).
17. ``run_slam2d`` on the batched path's 210 scans (pair-grid and batched
    IRLS kernels; the mean NN distance on the plain sweep): gate error
    after <= before; then on the xy of 12 full frames: nn_matched and
    nn_sweep launch with a batch axis.

The last two kernels and the scan-to-submap path:

18. gn_stats and gn_stats_batched (kernels 12 and 13: one GN update's
    packed statistics) vs their plain versions through
    ``align2d.weighted_gn_update_cuda``, their only caller: kernel 12 on
    frame 1's first-iteration correspondences (N = 28,800) at the
    identity and at a warm transform, kernel 13 on the batched path's 209
    pairs (each at a seeded small transform) plus an all-masked pair and
    one with an odd count.  The ten sums and the error within
    GN_STATS_TOL of their Cauchy-Schwarz bounds, the count exact, sigma
    within GN_SIGMA_TOL relative, and the update's delta within
    GN_DELTA_TOL of ``weighted_gauss_newton_update``'s with equal ``ok``.
19. ``run_submap_odometry`` at ``benchmarks/bench_submap.py``'s width (the
    96 frames padded to 28,800; voxel 0.05 m, capacity 2^17, a 65,536-row
    map view), twice (bitwise equal; the second run timed): frames/s, ATE
    < 0.05 m, no hidden cells, the dropped points printed, nn_list and
    irls_loop launches each equal to the total outer iterations; the plain
    path on the card over the first 8 frames within 1 mm, with no launch.
20. ``run_submap_odometry`` on the JAX package's tests/test_submap.py
    wall world (8 frames of 400 points, voxel 0.03 m, capacity 4096),
    fused and re-voxelize: max error < SUBMAP_2D_GATE_M; nn_matched and
    irls_loop launch.

The launch counts of each path are zeroed just before it and read just
after.  Prints one ``{"kernels": [...]}`` line, one entry per kernel (the
fourteen): the contract's keys for its first timed shape and path, its
launches on every path driven (``launches_by_path``) and the other shapes
it was timed at (``other_shapes``); then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Bounds:
the larger of (bytes read once + written once) / 3.35 TB/s and counted
operations / 67 TFLOP/s (H100 SXM float32 without tensor cores).

    python3 chip_smoke.py --profile

adds torch.profiler traces of the main path's first 16 frames, of the
batched path, of the p2l path's first 16 frames (with the voxel normals'
share), of run_slam3d over the 96 frames (with a host-clock split into
its ICP calls, its mean-NN-distance calls and its graph solve) and of the
submap path over the 96 frames (with a host-clock split into its ICP
calls, hash inserts and Morton resorts): device time by kernel and the
device's idle share, and the profiler's tables.

The phases take ``device`` and sizes, so a CPU test rehearses them at a
tiny size with the kernels' plain versions.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import icp2d as m_icp
from icp_rust_tpu_torch.models import icp_p2l as m_p2l
from icp_rust_tpu_torch.models import slam as m_slam
from icp_rust_tpu_torch.models import submap as m_submap
from icp_rust_tpu_torch.models.odometry import ate_rmse, \
    run_odometry_fused, run_odometry_p2l_fused
from icp_rust_tpu_torch.models.slam import run_slam2d, run_slam3d
from icp_rust_tpu_torch.models.submap import run_submap_odometry
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, align3d, \
    align3d_cuda, cuda_build, nn_cuda, nn_pairs_cuda, nn_sweep_cuda
from icp_rust_tpu_torch.ops.nn import nearest_neighbor_matched, nn_torch
from icp_rust_tpu_torch.ops.normals import estimate_normals_voxel
from icp_rust_tpu_torch.parallel.sharded import batched_icp2d
from icp_rust_tpu_torch.utils import io

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PAD_TO = 28800
ATE_GATE_M = 0.05
PLAIN_GATE_M = 1e-3
# Solver kernels vs their plain versions, rot and t (metre-scale data):
# the kernels take their sums over the points in another order (a block
# tree against torch's reductions), a difference of f32 roundoff that the
# loops carry on.  A stop decision of the IRLS loop that flipped on it
# would move the result by up to 1e-3 (sqrt of the step tolerance) and
# fail the check, as it should.
IRLS_TOL = 1e-5
FRAME_TOL = 1e-5
# Operations per valid point and IRLS iteration, counted from
# csrc/irls.cuh: residuals 10; median and MAD, each 4 radix passes of ~7
# (key, prefix test, digit, histogram add) on 2 dims plus a count/max
# pass of 3 on 2 dims, the MAD's passes 2 more for |r - med|: 62 + 78;
# normal-equation sums and Huber error 44.
IRLS_OPS_PER_POINT = 194
# Per (query, db point) pair: nn_list 3 sub + 3 mul + 3 add + 1 compare;
# icp2d_frame's 2D sweep 2 + 2 + 1 + 1.
NN_OPS_PER_PAIR_3D = 10
NN_OPS_PER_PAIR_2D = 6
# Operations per valid point and p2l IRLS iteration, counted from
# csrc/p2l.cuh: residual 26 (p = R s + t 18, n . (p - d) 8); median 4
# radix passes of ~7 plus a count/max pass of 3, the MAD's 5 passes 2 more
# each for |r - med|: 31 + 41; the sums pass 117 (p again 18, J 9, weight
# 5, 21 JtJ sums of 3, 6 Jtr sums of 3, error 4).
P2L_OPS_PER_POINT = 215
# The p2l workload (benchmarks/bench_p2l.py): voxel normals at 0.3 m; the
# z gate of its planar-motion data (bench_p2l.py:53-61).
P2L_VOXEL_M = 0.3
P2L_Z_GATE_M = 0.05
# p2l_stats vs its plain version: the 27 sums and the error relative to
# the Cauchy-Schwarz bound of each sum's absolute terms (f32 roundoff of
# 28,800-term sums in two orders); the count exact; sigma, an exact order
# statistic of residuals computed by the same float32 ops, relative.
P2L_STATS_TOL = 1e-5
P2L_SIGMA_TOL = 1e-6
# The batched workload: 210 scans, the size of the reference's scans/2d
# sequence (411-670 points per scan, padded to 768).
BATCH_SCANS = 210
BATCH_PAD = 768
BATCH_COUNTS = (411, 670)
# gn_stats(_batched) vs their plain versions, as p2l_stats: the ten sums
# and the error against the Cauchy-Schwarz bound of each sum's absolute
# terms, sigma relative; the update's delta (solver units, metres here)
# against weighted_gauss_newton_update's, whose sums run in another order.
GN_STATS_TOL = 1e-5
GN_SIGMA_TOL = 1e-6
GN_DELTA_TOL = 1e-5
# The submap workload (benchmarks/bench_submap.py:47): ~54k occupied cells
# at 96 frames, a 2^17-slot table (load ~0.41) and a 2^16-row view.
SUBMAP_KW = dict(voxel_size=0.05, capacity=1 << 17, view_rows=1 << 16)
# The wall world of the JAX package's tests/test_submap.py and its gate.
SUBMAP_2D_KW = dict(voxel_size=0.03, capacity=4096)
SUBMAP_2D_GATE_M = 0.02


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` in ms: CUDA events on the card (after warm-up),
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_F32_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _config(**kw):
    base = dict(compute_dtype=torch.float32, point_scale=1.0,
                det_rel_eps=1e-9, nn_dst_tile=2048, nn_query_tile=256)
    base.update(kw)
    return ICPConfig(**base)


def frames3d(n_frames: int, stride: int = 1, seed: int = 0):
    """Synthetic 28,800-point frames (every ``stride``-th point) padded to
    PAD_TO (or a multiple of 128 when subsampled), and the ground-truth
    trajectory in frame 0's coordinates."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=seed)
    frames = [f[::stride] for f in frames]
    pts, mask = io.pad_points(frames, pad_to=PAD_TO if stride == 1 else None)
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[1:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    return pts, mask, gt


def _first_pair(device, stride):
    """Frames 0 (src) and 1 (dst), Morton-sorted as icp3d_planar sorts
    them."""
    pts, mask, _ = frames3d(2, stride)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    src, smask, _ = m_icp._spatial_sort(p[0], k[0])
    dst, dmask, _ = m_icp._spatial_sort(p[1], k[1])
    return src, smask, dst, dmask


def _nn_list_case(name, query, db, dmask_c, payload, qb_fn, device,
                  tile: int, q_tile: int):
    """One nn_list check: the kernel vs its plain version (bitwise dist,
    idx, payload) and vs a brute-force sweep (idx, dist, and the winner's
    payload where a valid point exists)."""
    n = query.shape[0]
    qp = -(-n // q_tile) * q_tile
    d_dim = query.shape[1]
    pack = nn_cuda.pack_db(db, dmask_c, payload, db_tile=tile)
    n_chunks = pack.dbf_cm.shape[1] // 128
    cap = min(nn_cuda._LIST_CAP, n_chunks)
    query_p = torch.zeros((qp, d_dim), dtype=torch.float32, device=device)
    query_p[:n] = query
    qb = qb_fn(query_p, pack)
    lists, cnt = nn_cuda._survivor_lists(query_p, pack.cbox, qb, d_dim,
                                         q_tile, cap)
    args = (query_p, pack.dbf_cm, lists, cnt, d_dim, q_tile, cap)
    got = nn_cuda.nn_list(*args)
    want = nn_cuda.nn_list_plain(*args)
    _sync(device)
    for a, b, what in zip(got, want, ("dist", "idx", "payload")):
        if not torch.equal(a, b):
            raise RuntimeError(f"nn_list {name}: {what} differs from the "
                               "plain version")
    brute = nn_torch(query, db, dmask_c, tile=tile)
    hit = torch.isfinite(brute.dist_sq)
    want_pay = payload[brute.index.long()]
    if not (torch.equal(got[1][:n], brute.index)
            and torch.equal(nn_cuda._trim_sentinel(got[0][:n]),
                            brute.dist_sq)
            and torch.equal(got[2][:n][hit], want_pay[hit])):
        raise RuntimeError(f"nn_list {name}: differs from brute force")
    walked = torch.where(cnt > cap, n_chunks, cnt)
    fin = torch.isfinite(got[0])
    err = float(torch.max(torch.abs(got[0][fin] - want[0][fin]))) \
        if bool(fin.any()) else 0.0
    case_ms = time_ms(lambda: nn_cuda.nn_list(*args), device, reps=5)
    print(f"# nn_list {name}: bitwise equal to plain and brute force; "
          f"chunks walked per tile mean {float(walked.float().mean()):.2f}"
          f" max {int(walked.max())} of {n_chunks} "
          f"(full sweeps {int((cnt > cap).sum())}); {case_ms:.4f} ms")
    return dict(args=args, walked=walked, err=err, dist=got[0][:n],
                pay=got[2][:n])


def _nn_list_record(case, q_tile: int, device):
    """Kernel 1's timing, plain timing and bound at one case's shapes."""
    args = case["args"]
    query_p, dbf_cm = args[0], args[1]
    d_dim = args[4]
    ms = time_ms(lambda: nn_cuda.nn_list(*args), device, reps=50)
    plain_ms = time_ms(lambda: nn_cuda.nn_list_plain(*args), device, reps=3)
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    pairs = float(case["walked"].sum()) * 128 * q_tile
    n_bytes = (qp * d_dim * 4 + dbf_cm.numel() * 4 + args[2].numel() * 4
               + args[3].numel() * 4 + qp * (4 + 4 + 4 * f_dim))
    b, by = bound_ms(n_bytes, pairs * NN_OPS_PER_PAIR_3D)
    return dict(name="nn_list", route="cuda",
                source="icp_rust_tpu_torch/csrc/nn_list.cu",
                replaces="icp_rust_tpu/ops/nn_pallas.py:873", ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)


def phase_nn_list(device="cuda", stride: int = 1, tile: int = 2048,
                  q_tile: int = 256):
    """Kernel 1 vs its plain version and a brute-force sweep (xy
    payload, the main path's)."""
    cfg = _config(nn_dst_tile=tile, nn_query_tile=q_tile)
    src, smask, dst, dmask = _first_pair(device, stride)
    n = src.shape[0]
    qp = -(-n // q_tile) * q_tile
    eps = torch.finfo(torch.float32).eps

    def run_case(name, query, db, dmask_c, qb_fn):
        return _nn_list_case(name, query, db, dmask_c, db[:, :2], qb_fn,
                             device, tile, q_tile)

    def cold(query_p, pack):
        return nn_cuda._center_bound(query_p, pack.cbox, 3)

    errs = []
    c = run_case("cold", src, dst, dmask, cold)
    errs.append(c["err"])
    # One real outer step: the solve on the cold correspondences, then
    # the warm bound of the next iteration.
    dt = align2d.estimate_transform(src[:, :2], c["pay"], smask, cfg)
    xy = dt.apply_points(src[:, :2])
    src1 = torch.cat([xy, src[:, 2:]], dim=-1)
    move = torch.linalg.norm(xy - src[:, :2], dim=-1)
    qb_w = (torch.sqrt(c["dist"]) + move) ** 2 * (1.0 + 32.0 * eps)

    def warm_bound(query_p, pack):
        qb = torch.full((qp,), float("-inf"), device=device)
        qb[:n] = qb_w
        return qb

    warm = run_case("warm", src1, dst, dmask, warm_bound)
    errs.append(warm["err"])
    errs.append(run_case(
        "full-sweep", src1, dst, dmask,
        lambda q, p: torch.full((qp,), 1e30, device=device))["err"])
    gen = torch.Generator(device="cpu").manual_seed(5)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    errs.append(run_case("masked-db", src, dst, dmask & ~drop, cold)["err"])
    # Exact ties: every db point twice, queries on db points.
    half = int(dmask.sum()) // 2
    dup = torch.cat([dst[:half], dst[:half]])
    dup_mask = torch.ones(dup.shape[0], dtype=torch.bool, device=device)
    tie = run_case("ties", dst[:n], dup, dup_mask, cold)
    errs.append(tie["err"])

    # Timing at the main path's warm shape.
    rec = _nn_list_record(warm, q_tile, device)
    rec.update(path="main", max_abs_err=max(errs))
    return rec


def phase_irls(device="cuda", stride: int = 1):
    """Kernel 2 vs its plain version on frame 1's first correspondences."""
    cfg = _config()
    src, smask, dst, dmask = _first_pair(device, stride)
    res, matched = nearest_neighbor_matched(
        src, dst, dmask, payload=dst[:, :2], backend="torch",
        tile=cfg.nn_dst_tile)
    s_xy = src[:, :2].contiguous()
    args = (s_xy, matched, smask, cfg.huber_k, cfg.det_rel_eps,
            cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    rot, t, it = align2d_cuda.irls_loop(*args)
    rot_p, t_p, it_p = align2d_cuda.irls_loop_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    print(f"# irls_loop: iterations kernel {int(it)} plain {int(it_p)}; "
          f"max |diff| rot/t {err:.3e} (tol {IRLS_TOL})")
    if not err <= IRLS_TOL:
        raise RuntimeError(f"irls_loop differs from its plain version: {err}")
    ms = time_ms(lambda: align2d_cuda.irls_loop(*args), device, reps=20)
    plain_ms = time_ms(lambda: align2d_cuda.irls_loop_plain(*args), device,
                       reps=2)
    n = s_xy.shape[0]
    ops = float(int(it)) * float(smask.sum()) * IRLS_OPS_PER_POINT
    b, by = bound_ms(5 * n * 4 + 8 * 4, ops)
    return dict(name="irls_loop", route="cuda", path="main",
                source="icp_rust_tpu_torch/csrc/irls_loop.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:714",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


def pair2d(device, n: int = 640, pad: int = 768, seed: int = 1):
    """A synthetic 2D scan pair: xy of ``n`` seeded points of frames 0 and
    1 of the synthetic sequence, each padded to ``pad``."""
    frames, _ = io.synthesize_frames3d(2, seed=0)
    rng = np.random.default_rng(seed)
    out = []
    for f in frames:
        xy = f[rng.choice(len(f), n, replace=False), :2]
        p, m = io.pad_points([xy], pad_to=pad)
        out += [torch.as_tensor(p[0], dtype=torch.float32, device=device),
                torch.as_tensor(m[0], device=device)]
    return out


def phase_frame(device="cuda", n: int = 640, pad: int = 768):
    """Kernel 3 vs its plain version on a synthetic 2D pair."""
    cfg = _config()
    sp, sm, dp, dm = pair2d(device, n, pad)
    t0 = RigidTransform2.identity(dtype=torch.float32, device=device)
    rot, t, it = align2d_cuda.icp2d_frame(sp, dp, sm, dm, t0, cfg)
    rot_p, t_p, it_p = align2d_cuda.icp2d_frame_plain(sp, dp, sm, dm, t0,
                                                      cfg)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    print(f"# icp2d_frame: outer iterations kernel {int(it)} plain "
          f"{int(it_p)}; max |diff| rot/t {err:.3e} (tol {FRAME_TOL})")
    if not err <= FRAME_TOL:
        raise RuntimeError(f"icp2d_frame differs from its plain version: "
                           f"{err}")
    if torch.device(device).type == "cuda":
        raw = align2d_cuda.icp2d_frame_raw(sp, dp, sm, dm, t0, cfg)
        outer, inner = int(raw[6]), int(raw[7])
        ms = time_ms(lambda: align2d_cuda.icp2d_frame(sp, dp, sm, dm, t0,
                                                      cfg), device, reps=20)
    else:
        outer, inner = int(it), 0
        ms = time_ms(lambda: align2d_cuda.icp2d_frame(sp, dp, sm, dm, t0,
                                                      cfg), device, reps=1)
    plain_ms = time_ms(lambda: align2d_cuda.icp2d_frame_plain(
        sp, dp, sm, dm, t0, cfg), device, reps=2)
    n_src, n_dst = float(sm.sum()), float(dm.sum())
    ops = (outer * n_src * (n_dst * NN_OPS_PER_PAIR_2D + 6)
           + inner * n_src * IRLS_OPS_PER_POINT)
    # src (N, 2) and mask, dst (M, 2), warm start 6 floats, output 8.
    b, by = bound_ms(pad * 4 * 3 + pad * 4 * 2 + 14 * 4, ops)
    return dict(name="icp2d_frame", route="cuda", path="2d",
                source="icp_rust_tpu_torch/csrc/icp2d_frame.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:888",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


def _run_path(pts, mask, cfg, device, with_metrics: bool):
    """One timed run of the port's entry point with the launch counts
    zeroed just before it; returns (path, stats or None, seconds,
    launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    out = run_odometry_fused(pts, mask, cfg, with_metrics=with_metrics,
                             device=device)
    _sync(device)
    sec = time.perf_counter() - t0
    stats = out[2] if with_metrics else None
    return out[1], stats, sec, dict(cuda_build.LAUNCHES)


def phase_main(device="cuda", n_frames: int = 96, stride: int = 1,
               plain_frames: int = 8, tile: int = 2048):
    """The main path: 3D odometry over the synthetic sequence, once to warm
    up and once timed."""
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    _, _, first_sec, _ = _run_path(pts, mask, cfg, device, True)
    path, stats, sec, launches = _run_path(pts, mask, cfg, device, True)
    ate = ate_rmse(path, gt)
    outer = stats.outer_iters.cpu().numpy()
    fps = (n_frames - 1) / sec
    print(f"# main path: {n_frames} frames of {pts.shape[1]} points, "
          f"{sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), ATE vs ground truth {ate:.6f} m; outer "
          f"iterations per frame mean {outer.mean():.3f} min {outer.min()} "
          f"max {outer.max()}; launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"main path ATE {ate} >= {ATE_GATE_M}")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    p_path, _, p_sec, p_launch = _run_path(pts[:plain_frames],
                                           mask[:plain_frames], plain_cfg,
                                           device, True)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# plain path on the first {plain_frames} frames: {p_sec:.3f} s; "
          f"trajectory vs kernel path {d:.3e} m (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate, fps=fps, seconds=sec,
                outer_mean=float(outer.mean()))


def phase_2d(device="cuda", n_frames: int = 8, n_points: int = 640,
             pad: int = 768):
    """A 2D sequence (xy of the synthetic frames) through icp2d, whose
    whole-frame kernel serves every frame."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=2)
    rng = np.random.default_rng(3)
    xy = [f[rng.choice(len(f), n_points, replace=False), :2] for f in frames]
    pts, mask = io.pad_points(xy, pad_to=pad)
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[1:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    cfg = _config()
    # No per-frame stats: the whole-frame kernel returns the transform only
    # (the JAX package's icp2d gates it the same way).
    path, _, sec, launches = _run_path(pts, mask, cfg, device, False)
    ate = ate_rmse(path, gt)
    p_path, _, _, _ = _run_path(pts, mask, cfg.with_(
        frame_backend="off", nn_backend="torch", align_backend="torch"),
        device, False)
    d = ate_rmse(p_path, path)
    print(f"# 2D path: {n_frames} frames of {n_points} points, {sec:.3f} s, "
          f"ATE vs ground truth {ate:.6f} m, vs plain path {d:.3e} m; "
          f"launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"2D path ATE {ate} >= {ATE_GATE_M}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"2D kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate)


def profile_main(device="cuda", n_frames: int = 16):
    """torch.profiler over the main path's first ``n_frames`` frames (after
    a warm-up run): device time by kernel and the device's idle share
    against an unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    _run_path(pts, mask, cfg, device, False)
    _, _, wall, _ = _run_path(pts, mask, cfg, device, False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_path(pts, mask, cfg, device, False)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    frames = n_frames - 1
    print(f"# profile: {frames} frames, unprofiled wall {wall * 1e3:.3f} ms "
          f"({wall * 1e3 / frames:.3f} ms/frame); device busy "
          f"{busy_ms:.3f} ms ({busy_ms / frames:.3f} ms/frame), idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=30))


@functools.lru_cache(maxsize=4)
def scans2d(n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD, seed: int = 6):
    """Synthetic 2D scans the size of the reference's scans/2d: the xy of
    ``n_scans`` synthetic frames, each subsampled to a seeded count in
    BATCH_COUNTS and padded to ``pad``, and the ground-truth transform of
    each consecutive pair (scan k onto scan k + 1) as (angle, t)."""
    frames, traj = io.synthesize_frames3d(n_scans, seed=seed)
    rng = np.random.default_rng(seed + 1)
    xy = []
    for f in frames:
        k = int(rng.integers(BATCH_COUNTS[0], BATCH_COUNTS[1] + 1))
        xy.append(f[rng.choice(len(f), min(k, pad), replace=False), :2])
    pts, mask = io.pad_points(xy, pad_to=pad)
    th = traj[:, 2]
    c, s = np.cos(th[1:]), np.sin(th[1:])
    d = traj[:-1, :2] - traj[1:, :2]
    gt_t = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                    axis=-1)
    return pts, mask, th[:-1] - th[1:], gt_t


def _batch(device, n_scans: int, pad: int, sort: bool = False):
    """Pairs (scan k, scan k + 1) on ``device``: src, src_mask, dst,
    dst_mask, each Morton-sorted per pair when ``sort``."""
    pts, mask, _, _ = scans2d(n_scans, pad)
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    src, smask, dst, dmask = p[:-1], k[:-1], p[1:], k[1:]
    if sort:
        src, smask, _ = m_icp._spatial_sort(src, smask)
        dst, dmask, _ = m_icp._spatial_sort(dst, dmask)
    return src, smask, dst, dmask


def _equal_or_raise(got, want, what):
    for a, b, name in zip(got, want, ("dist", "idx", "payload")):
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: {name} differs from the plain "
                               "version")


def phase_nn_pairs(device="cuda", n_scans: int = BATCH_SCANS,
                   pad: int = BATCH_PAD, big_pairs: int = 4,
                   big_db: int = 4096, q_sub: int = nn_pairs_cuda.Q_SUB):
    """Kernels 8 and 9 vs their plain versions and a brute-force sweep."""
    src, smask, dst, dmask = _batch(device, n_scans, pad, sort=True)
    eps = torch.finfo(torch.float32).eps
    grp = min(nn_pairs_cuda.LIST_GRP, q_sub)
    timed = {}
    errs = {"static": 0.0, "list": 0.0}

    def run_case(name, query, db, dm, bounds):
        """bounds: {"static" | "list": (B, Nq) bound or None (+inf)}."""
        n_q = query.shape[1]
        brute = nn_torch(query, db, dm, tile=db.shape[1])
        want_pay = torch.take_along_dim(db, brute.index[..., None].long(),
                                        dim=1)
        for kind, qb in bounds.items():
            query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(
                query, db, dm, db, qb, q_sub)
            if kind == "static":
                qbox = nn_pairs_cuda._query_boxes(query_p, q_sub)
                gb = nn_pairs_cuda._group_bounds(qb_p, q_sub)
                args = (query_p, dbf, qbox, cbox, gb, 2, q_sub)
                fn = nn_pairs_cuda.nn_pairs
                plain = nn_pairs_cuda.nn_pairs_plain
                walked = int((nn_pairs_cuda._box_lower_bound(qbox, cbox, 2)
                              <= gb[..., None]).sum())
            else:
                lists, cnt = nn_pairs_cuda._survivor_lists(
                    query_p, cbox, qb_p, 2, q_sub, grp)
                args = (query_p, dbf, lists, cnt, 2, q_sub)
                fn = nn_pairs_cuda.nn_pairs_list
                plain = nn_pairs_cuda.nn_pairs_list_plain
                walked = int(cnt.sum())
            got = fn(*args)
            want = plain(*args)
            _sync(device)
            what = f"nn_pairs {kind} {name}"
            _equal_or_raise(got, want, what)
            fin = torch.isfinite(got[0])
            errs[kind] = max(errs[kind], float(torch.max(torch.abs(
                got[0][fin] - want[0][fin]))) if bool(fin.any()) else 0.0)
            dist = nn_cuda._trim_sentinel(got[0][:, :n_q])
            hit = torch.isfinite(brute.dist_sq)
            if not (torch.equal(got[1][:, :n_q], brute.index)
                    and torch.equal(dist, brute.dist_sq)
                    and torch.equal(got[2][:, :n_q][hit], want_pay[hit])):
                raise RuntimeError(f"{what}: differs from brute force")
            n_slots = query_p.shape[0] * (query_p.shape[1] // q_sub) \
                * (dbf.shape[2] // 128)
            case_ms = time_ms(lambda: fn(*args), device, reps=10)
            print(f"# {what}: bitwise equal to plain and brute force; "
                  f"{query.shape[0]} pairs x {n_q} queries x {db.shape[1]} "
                  f"db points; chunks walked {walked} of {n_slots}; "
                  f"{case_ms:.4f} ms")
            timed[(kind, name)] = dict(fn=fn, plain=plain, args=args,
                                       walked=walked, ms=case_ms)
        return brute, want_pay

    inf_b = {"static": None}
    brute, matched = run_case("cold", src, dst, dmask, inf_b)
    # One real outer step: the batched solve on the cold correspondences,
    # then the warm bounds of the next iteration.
    cfg = _config()
    rot, t, _ = align2d_cuda.irls_loop_batched_plain(
        src, matched, smask, cfg.huber_k, cfg.det_rel_eps,
        cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    xy = RigidTransform2(rot, t).apply_points(src)
    move = torch.linalg.norm(xy - src, dim=-1)
    qb_w = (torch.sqrt(brute.dist_sq) + move) ** 2 * (1.0 + 32.0 * eps)
    run_case("warm", xy, dst, dmask, {"static": qb_w, "list": qb_w})

    def tight(query, db, dm):
        return nn_torch(query, db, dm, tile=db.shape[1]).dist_sq \
            * (1.0 + 32.0 * eps)

    gen = torch.Generator(device="cpu").manual_seed(9)
    drop = (torch.rand(dmask.shape, generator=gen) < 0.5).to(device)
    dm2 = dmask & ~drop
    run_case("masked-db", src, dst, dm2,
             {"static": None, "list": tight(src, dst, dm2)})
    # Exact ties: the first half of every db twice, queries on db points.
    half = pad // 2
    dup = torch.cat([dst[:, :half], dst[:, :half]], dim=1)
    dup_m = torch.cat([dmask[:, :half], dmask[:, :half]], dim=1)
    run_case("ties", dup, dup, dup_m,
             {"static": None, "list": tight(dup, dup, dup_m)})
    # The db-size limit of the pair-grid route: 4096-point dbs.
    frames, _ = io.synthesize_frames3d(big_pairs + 1, seed=8)
    rng = np.random.default_rng(8)
    xy_b = [f[rng.choice(len(f), big_db, replace=False), :2] for f in frames]
    pts_b = torch.as_tensor(np.stack(xy_b), dtype=torch.float32,
                            device=device)
    ones = torch.ones(pts_b.shape[:2], dtype=torch.bool, device=device)
    q_b, qm_b, _ = m_icp._spatial_sort(pts_b[:-1, :pad], ones[:-1, :pad])
    db_b, dm_b, _ = m_icp._spatial_sort(pts_b[1:], ones[1:])
    run_case(f"db-{big_db}", q_b, db_b, dm_b,
             {"static": None, "list": tight(q_b, db_b, dm_b)})

    records = []
    for kind, name, rec_name, src_file, line in (
            ("static", "cold", "nn_pairs", "nn_pairs.cu", 1234),
            ("list", "warm", "nn_pairs_list", "nn_pairs_list.cu", 1432)):
        c = timed[(kind, name)]
        args = c["args"]
        ms = time_ms(lambda: c["fn"](*args), device, reps=50)
        plain_ms = time_ms(lambda: c["plain"](*args), device, reps=3)
        query_p, dbf = args[0], args[1]
        tables = sum(x.numel() * 4 for x in args[2:-2])
        n_bytes = (query_p.numel() * 4 + dbf.numel() * 4 + tables
                   + query_p.shape[0] * query_p.shape[1]
                   * (4 + 4 + 4 * (dbf.shape[1] - 2)))
        pairs = float(c["walked"]) * 128 * q_sub
        b, by = bound_ms(n_bytes, pairs * NN_OPS_PER_PAIR_2D)
        records.append(dict(
            name=rec_name, route="cuda", path="batched",
            source=f"icp_rust_tpu_torch/csrc/{src_file}",
            replaces=f"icp_rust_tpu/ops/nn_pallas.py:{line}",
            max_abs_err=errs[kind], ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None))
    return records


def phase_irls_batched(device="cuda", n_scans: int = BATCH_SCANS,
                       pad: int = BATCH_PAD):
    """Kernel 7 vs its plain version on the pairs' first-iteration
    correspondences, plus an all-masked and a one-point pair."""
    cfg = _config()
    src, smask, dst, dmask = _batch(device, n_scans, pad, sort=True)
    _, matched = nearest_neighbor_matched(src, dst, dmask, backend="torch",
                                          tile=pad)
    extra = torch.zeros_like(smask[:2])
    extra[1, 0] = True
    s = torch.cat([src, src[:2]])
    mt = torch.cat([matched, matched[:2]])
    mk = torch.cat([smask, extra])
    args = (s, mt, mk, cfg.huber_k, cfg.det_rel_eps, cfg.inner_delta_sq_tol,
            cfg.inner_max_iter, cfg.point_scale)
    rot, t, its = align2d_cuda.irls_loop_batched(*args)
    rot_p, t_p, its_p = align2d_cuda.irls_loop_batched_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    its_k = its.to(torch.int64).cpu()
    its_pl = its_p.to(torch.int64).cpu()
    print(f"# irls_loop_batched: {s.shape[0]} pairs of {s.shape[1]} points; "
          f"iterations per pair kernel min {int(its_k.min())} median "
          f"{float(its_k.double().median()):.1f} max {int(its_k.max())}, "
          f"sum {int(its_k.sum())}; pairs whose count differs from the "
          f"plain version's {int((its_k != its_pl).sum())}; degenerate "
          f"pairs {its_k[-2:].tolist()}; max |diff| rot/t {err:.3e} "
          f"(tol {IRLS_TOL})")
    if not err <= IRLS_TOL:
        raise RuntimeError(f"irls_loop_batched differs from its plain "
                           f"version: {err}")
    eye = torch.eye(2, device=rot.device)
    if not (torch.equal(rot[-2:], torch.stack([eye, eye]))
            and bool(torch.all(t[-2:] == 0))
            and its_k[-2:].tolist() == [1, 1]):
        raise RuntimeError("irls_loop_batched: a degenerate pair moved")
    ms = time_ms(lambda: align2d_cuda.irls_loop_batched(*args), device,
                 reps=20)
    plain_ms = time_ms(lambda: align2d_cuda.irls_loop_batched_plain(*args),
                       device, reps=2)
    ops = float((its_k.double() * mk.sum(dim=1).double().cpu()).sum()) \
        * IRLS_OPS_PER_POINT
    b, by = bound_ms(5 * s.shape[0] * s.shape[1] * 4 + s.shape[0] * 8 * 4,
                     ops)
    return dict(name="irls_loop_batched", route="cuda", path="batched",
                source="icp_rust_tpu_torch/csrc/irls_loop_batched.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:1127",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


def phase_frame_pairs(device="cuda", n_scans: int = BATCH_SCANS,
                      pad: int = BATCH_PAD):
    """Kernel 10 vs its plain version on the unsorted pairs."""
    cfg = _config()
    src, smask, dst, dmask = _batch(device, n_scans, pad)
    b = src.shape[0]
    t0 = RigidTransform2.identity((b,), dtype=torch.float32, device=device)
    args = (src, dst, smask, dmask, t0, cfg)
    rot, t, its = align2d_cuda.icp2d_frame_pairs(*args)
    rot_p, t_p, its_p = align2d_cuda.icp2d_frame_pairs_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    its_k = its.to(torch.int64).cpu()
    its_pl = its_p.to(torch.int64).cpu()
    print(f"# icp2d_frame_pairs: {b} pairs; outer iterations per pair "
          f"kernel min {int(its_k.min())} max {int(its_k.max())} sum "
          f"{int(its_k.sum())}, plain sum {int(its_pl.sum())}; max |diff| "
          f"rot/t {err:.3e} (tol {FRAME_TOL})")
    if not err <= FRAME_TOL:
        raise RuntimeError(f"icp2d_frame_pairs differs from its plain "
                           f"version: {err}")
    if not torch.equal(its_k, its_pl):
        raise RuntimeError("icp2d_frame_pairs: outer iteration counts "
                           "differ from the plain version's")
    if torch.device(device).type == "cuda":
        inner = align2d_cuda.icp2d_frame_raw(*args)[:, 7].double().cpu()
        ms = time_ms(lambda: align2d_cuda.icp2d_frame_pairs(*args), device,
                     reps=10)
    else:
        inner = torch.zeros(b, dtype=torch.float64)
        ms = time_ms(lambda: align2d_cuda.icp2d_frame_pairs(*args), device,
                     reps=1)
    plain_ms = time_ms(lambda: align2d_cuda.icp2d_frame_pairs_plain(*args),
                       device, reps=1)
    n_src = smask.sum(dim=1).double().cpu()
    n_dst = dmask.sum(dim=1).double().cpu()
    ops = float((its_k.double() * n_src * (n_dst * NN_OPS_PER_PAIR_2D + 6)
                 + inner * n_src * IRLS_OPS_PER_POINT).sum())
    b_ms, by = bound_ms(b * (pad * 4 * 3 + pad * 4 * 2 + 14 * 4), ops)
    return dict(name="icp2d_frame_pairs", route="cuda", path="batched",
                source="icp_rust_tpu_torch/csrc/icp2d_frame_pairs.cu",
                replaces="icp_rust_tpu/ops/align2d_pallas.py:979",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)


def _run_batched(batch, cfg, device):
    """One timed ``batched_icp2d`` call with the launch counts zeroed just
    before it; returns (transforms, seconds, launches)."""
    src, smask, dst, dmask = batch
    t0 = RigidTransform2.identity((src.shape[0],), dtype=torch.float32,
                                  device=device)
    _sync(device)
    cuda_build.reset_launches()
    start = time.perf_counter()
    out = batched_icp2d(src, dst, smask, dmask, t0, cfg, device=device)
    _sync(device)
    return out, time.perf_counter() - start, dict(cuda_build.LAUNCHES)


def _pair_diff(a: RigidTransform2, b: RigidTransform2) -> torch.Tensor:
    """Per pair: the larger of |t_a - t_b| and |R_a - R_b| (max entry)."""
    dt = torch.linalg.norm(a.t - b.t, dim=-1)
    dr = torch.amax(torch.abs(a.rot - b.rot), dim=(-2, -1))
    return torch.maximum(dt, dr)


def phase_batched(device="cuda", n_scans: int = BATCH_SCANS,
                  pad: int = BATCH_PAD):
    """The batched path: all consecutive pairs in one batched_icp2d call,
    once to warm up and once timed; then the plain path and the
    pair-frame route."""
    pts, mask, gt_th, gt_t = scans2d(n_scans, pad)
    batch = _batch(device, n_scans, pad)
    n_pairs = n_scans - 1
    cfg = _config()
    _, first_sec, _ = _run_batched(batch, cfg, device)
    out, sec, launches = _run_batched(batch, cfg, device)
    pps = n_pairs / sec
    ang = torch.atan2(out.rot[:, 1, 0], out.rot[:, 0, 0]).double().cpu()
    e_rot = np.abs(ang.numpy() - gt_th)
    e_t = np.linalg.norm(out.t.double().cpu().numpy() - gt_t, axis=-1)
    k = launches["irls_loop_batched"]
    print(f"# batched path: {n_pairs} pairs of {pad} points "
          f"({int(mask.sum(1).min())}-{int(mask.sum(1).max())} valid), "
          f"{sec:.4f} s, {pps:.2f} pairs/s (host clock; first run "
          f"{first_sec:.4f} s); error vs ground truth per pair: t max "
          f"{e_t.max():.6f} m median {np.median(e_t):.6f} m, rot max "
          f"{e_rot.max():.3e} rad median {np.median(e_rot):.3e} rad; "
          f"outer iterations {k}; launches {launches}")
    on_card = torch.device(device).type == "cuda"
    want = {name: 0 for name in launches}
    want.update(nn_pairs=1, nn_pairs_list=k - 1, irls_loop_batched=k)
    if on_card and (k < 1 or launches != want):
        raise RuntimeError(f"batched path launches {launches}, expected "
                           f"{want}")
    if not e_t.max() < ATE_GATE_M:
        raise RuntimeError(f"batched path translation error {e_t.max()} "
                           f">= {ATE_GATE_M}")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    p_out, p_sec, p_launch = _run_batched(batch, plain_cfg, device)
    d_plain = float(torch.max(_pair_diff(out, p_out)))
    print(f"# batched plain path: {p_sec:.3f} s; max per-pair difference "
          f"from the kernel path {d_plain:.3e} (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"batched plain path launched kernels: {p_launch}")
    if not d_plain < PLAIN_GATE_M:
        raise RuntimeError(f"batched kernel vs plain path {d_plain}")
    pairs_cfg = cfg.with_(frame_backend="pairs")
    _run_batched(batch, pairs_cfg, device)
    f_out, f_sec, f_launch = _run_batched(batch, pairs_cfg, device)
    d_frame = float(torch.max(_pair_diff(out, f_out)))
    print(f"# batched pair-frame route: {f_sec:.4f} s, "
          f"{n_pairs / f_sec:.2f} pairs/s; max per-pair difference from "
          f"the lockstep path {d_frame:.3e} (gate {PLAIN_GATE_M}); "
          f"launches {f_launch}")
    want_f = {name: 0 for name in f_launch}
    want_f["icp2d_frame_pairs"] = 1
    if on_card and f_launch != want_f:
        raise RuntimeError(f"pair-frame route launches {f_launch}")
    if not d_frame < PLAIN_GATE_M:
        raise RuntimeError(f"pair-frame vs lockstep path {d_frame}")
    return dict(launches=launches, frame_launches=f_launch, pairs_per_s=pps,
                seconds=sec, max_t_err=float(e_t.max()))


def profile_batched(device="cuda", n_scans: int = BATCH_SCANS,
                    pad: int = BATCH_PAD):
    """torch.profiler over one batched_icp2d call (after a warm-up run):
    device time by kernel and the device's idle share against an
    unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = _batch(device, n_scans, pad)
    cfg = _config()
    _run_batched(batch, cfg, device)
    _, wall, _ = _run_batched(batch, cfg, device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_batched(batch, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile batched: {n_scans - 1} pairs, unprofiled wall "
          f"{wall * 1e3:.3f} ms; device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile batched kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _p2l_pair(device, stride: int, voxel: float = P2L_VOXEL_M):
    """Frames 0 (src) and 1 (dst), Morton-sorted as icp_point_to_plane
    sorts them, with dst's voxel normals and the [n, c] payload."""
    src, smask, dst, dmask = _first_pair(device, stride)
    normals, n_valid = estimate_normals_voxel(dst, dmask, voxel)
    payload = m_p2l.build_p2l_payload(dst, normals, n_valid, dmask)
    return src, smask, dst, dmask, payload


def phase_nn_list_p2l(device="cuda", stride: int = 1, tile: int = 2048,
                      q_tile: int = 256):
    """Kernel 1 at the p2l payload (D = 3, F = 4): the cold bound, the warm
    bound of one real p2l outer step, and a masked db whose normals are
    partly invalid (sentinel c)."""
    cfg = _config(nn_dst_tile=tile, nn_query_tile=q_tile)
    src, smask, dst, dmask, payload = _p2l_pair(device, stride)
    n = src.shape[0]
    qp = -(-n // q_tile) * q_tile
    eps = torch.finfo(torch.float32).eps

    def cold(query_p, pack):
        return nn_cuda._center_bound(query_p, pack.cbox, 3)

    c = _nn_list_case("p2l cold", src, dst, dmask, payload, cold, device,
                      tile, q_tile)
    # One real p2l outer step: the solve on the cold correspondences, then
    # the warm bound of the next iteration (3D move).
    dist = nn_cuda._trim_sentinel(c["dist"])
    m_n, matched, ok = m_p2l.decode_p2l_payload(c["pay"], dist)
    dt = align3d.estimate_transform_p2l(src, matched, m_n, smask & ok, cfg)
    src1 = dt.apply_points(src)
    move = torch.linalg.norm(src1 - src, dim=-1)
    qb_w = (torch.sqrt(dist) + move) ** 2 * (1.0 + 32.0 * eps)

    def warm_bound(query_p, pack):
        qb = torch.full((qp,), float("-inf"), device=device)
        qb[:n] = qb_w
        return qb

    warm = _nn_list_case("p2l warm", src1, dst, dmask, payload, warm_bound,
                         device, tile, q_tile)
    gen = torch.Generator(device="cpu").manual_seed(7)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    dm2 = dmask & ~drop
    normals2, valid2 = estimate_normals_voxel(dst, dm2, P2L_VOXEL_M)
    pay2 = m_p2l.build_p2l_payload(dst, normals2, valid2, dm2)
    masked = _nn_list_case("p2l masked-db", src, dst, dm2, pay2, cold,
                           device, tile, q_tile)
    sentinel = int((pay2[:, 3] >= m_p2l._C_VALID_MAX).sum())
    print(f"# nn_list p2l masked-db: {sentinel} db rows carry the sentinel "
          "plane offset")
    rec = _nn_list_record(warm, q_tile, device)
    rec.update(path="p2l", max_abs_err=max(c["err"], warm["err"],
                                           masked["err"]))
    return rec


def _first_p2l_correspondences(device, stride: int):
    """Frame 1's first-iteration p2l correspondences (cold exact NN of the
    sorted frame 0 against the sorted frame 1): (src, matched plane
    points, matched normals, pair mask)."""
    src, smask, dst, dmask, payload = _p2l_pair(device, stride)
    res, pay = nearest_neighbor_matched(src, dst, dmask, payload=payload,
                                        backend="torch")
    m_n, matched, ok = m_p2l.decode_p2l_payload(pay, res.dist_sq)
    return src, matched, m_n, smask & ok


def _degenerate_p2l(src, matched, m_n, mask):
    """The systems that must stop at iteration 1 with the identity: one
    plane (a Cholesky pivot fails), 5 valid points, sigma = 0 (every
    residual 0) and an all-masked input."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    noise = (torch.rand(src.shape[0], generator=gen) * 0.01).to(src.device)
    z = torch.zeros_like(m_n)
    z[:, 2] = 1.0
    plane = src.clone()
    plane[:, 2] = plane[:, 2] + 0.01 + noise
    five = torch.zeros_like(mask)
    five[torch.nonzero(mask)[:5, 0]] = True
    return {"one-plane": (src, plane, z, mask),
            "five-points": (src, matched, m_n, five),
            "sigma-0": (src, src, m_n, mask),
            "all-masked": (src, matched, m_n, torch.zeros_like(mask))}


def phase_p2l_loop(device="cuda", stride: int = 1):
    """Kernel 11 vs its plain version on frame 1's first-iteration
    correspondences, and the degenerate systems."""
    cfg = _config()
    src, matched, m_n, mask = _first_p2l_correspondences(device, stride)
    solver = (cfg.huber_k, cfg.inner_delta_sq_tol, cfg.inner_max_iter,
              cfg.point_scale)
    args = (src, matched, m_n, mask, *solver)
    rot, t, it = align3d_cuda.p2l_loop(*args)
    rot_p, t_p, it_p = align3d_cuda.p2l_loop_plain(*args)
    err = max(float(torch.max(torch.abs(rot - rot_p))),
              float(torch.max(torch.abs(t - t_p))))
    print(f"# p2l_loop: {int(mask.sum())} valid of {src.shape[0]} points; "
          f"iterations kernel {int(it)} plain {int(it_p)}; max |diff| rot/t "
          f"{err:.3e} (tol {IRLS_TOL})")
    if not err <= IRLS_TOL:
        raise RuntimeError(f"p2l_loop differs from its plain version: {err}")
    if int(it) != int(it_p):
        raise RuntimeError("p2l_loop: iteration count differs from the "
                           "plain version's")
    eye = torch.eye(3, device=src.device)
    for name, case in _degenerate_p2l(src, matched, m_n, mask).items():
        for fn in (align3d_cuda.p2l_loop, align3d_cuda.p2l_loop_plain):
            r_d, t_d, it_d = fn(*case, *solver)
            if not (torch.equal(r_d, eye) and bool(torch.all(t_d == 0))
                    and int(it_d) == 1):
                raise RuntimeError(f"{fn.__name__} {name}: moved or ran "
                                   f"{int(it_d)} iterations")
        print(f"# p2l_loop {name}: kernel and plain stop at iteration 1 "
              "with the identity")
    ms = time_ms(lambda: align3d_cuda.p2l_loop(*args), device, reps=20)
    plain_ms = time_ms(lambda: align3d_cuda.p2l_loop_plain(*args), device,
                       reps=1)
    ops = float(int(it)) * float(mask.sum()) * P2L_OPS_PER_POINT
    b, by = bound_ms(10 * src.shape[0] * 4 + 16 * 4, ops)
    return dict(name="p2l_loop", route="cuda", path="p2l",
                source="icp_rust_tpu_torch/csrc/p2l_loop.cu",
                replaces="icp_rust_tpu/ops/align3d_pallas.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, iterations=int(it))


def phase_p2l_stats(device="cuda", stride: int = 1):
    """Kernel 14 vs its plain version at the identity and at one warm
    transform, through align3d.weighted_gn_update_p2l_cuda (kernel 14's
    path: its launches are counted there)."""
    cfg = _config()
    src, matched, m_n, mask = _first_p2l_correspondences(device, stride)
    ident = RigidTransform3.identity(device=src.device)
    warm = align3d.estimate_transform_p2l(
        src, matched, m_n, mask, cfg.with_(align_backend="torch"))
    k = cfg.huber_k
    _sync(device)
    cuda_build.reset_launches()
    updates = [align3d.weighted_gn_update_p2l_cuda(t, src, matched, m_n,
                                                    mask, k)
               for t in (ident, warm)]
    _sync(device)
    launches = dict(cuda_build.LAUNCHES)
    worst, abs_err = 0.0, 0.0
    for name, t, upd in zip(("identity", "warm"), (ident, warm), updates):
        got = align3d_cuda.p2l_stats(src, matched, m_n, mask, t.rot, t.t, k)
        want = align3d_cuda.p2l_stats_plain(src, matched, m_n, mask, t.rot,
                                            t.t, k)
        rel, dn, sig_rel = align3d_cuda.stats_errors(got, want)
        abs_err = max(abs_err, float(torch.max(torch.abs(got - want))))
        print(f"# p2l_stats {name}: sums and error max rel {rel:.3e} "
              f"(tol {P2L_STATS_TOL}), count diff {dn:g}, sigma rel "
              f"{sig_rel:.3e} (tol {P2L_SIGMA_TOL}); update ok "
              f"{bool(upd.ok)}")
        if not (rel <= P2L_STATS_TOL and dn == 0.0
                and sig_rel <= P2L_SIGMA_TOL):
            raise RuntimeError(f"p2l_stats {name} differs from its plain "
                               "version")
        worst = max(worst, rel)
    args = (src, matched, m_n, mask, warm.rot, warm.t, k)
    ms = time_ms(lambda: align3d_cuda.p2l_stats(*args), device, reps=20)
    plain_ms = time_ms(lambda: align3d_cuda.p2l_stats_plain(*args), device,
                       reps=3)
    ops = float(mask.sum()) * P2L_OPS_PER_POINT
    b, by = bound_ms(10 * src.shape[0] * 4 + 12 * 4 + 32 * 4, ops)
    return dict(name="p2l_stats", route="cuda", path="p2l_stats",
                source="icp_rust_tpu_torch/csrc/p2l_stats.cu",
                replaces="icp_rust_tpu/ops/align3d_pallas.py:120",
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, launches=launches["p2l_stats"],
                max_rel_err=worst)


def _run_p2l(pts, mask, cfg, device, voxel: float = P2L_VOXEL_M):
    """One timed ``run_odometry_p2l_fused`` call with the launch counts
    zeroed just before it; returns (transforms, path, stats, seconds,
    launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    tf, path, stats = run_odometry_p2l_fused(pts, mask, cfg, voxel,
                                             with_metrics=True,
                                             device=device)
    _sync(device)
    return tf, path, stats, time.perf_counter() - t0, \
        dict(cuda_build.LAUNCHES)


def phase_p2l(device="cuda", n_frames: int = 96, stride: int = 1,
              plain_frames: int = 8, tile: int = 2048,
              voxel: float = P2L_VOXEL_M):
    """The p2l path: SE(3) point-to-plane odometry over the synthetic
    sequence, twice (bitwise equal; the second run timed), then the plain
    path on the first frames.  ``voxel``: the normals' voxel size, for
    subsampled frames."""
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    tf1, path1, _, first_sec, _ = _run_p2l(pts, mask, cfg, device, voxel)
    tf, path, stats, sec, launches = _run_p2l(pts, mask, cfg, device, voxel)
    if not (np.array_equal(path, path1) and torch.equal(tf.rot, tf1.rot)
            and torch.equal(tf.t, tf1.t)):
        raise RuntimeError("p2l path: two runs differ")
    ate = ate_rmse(path[:, :2], gt)
    z_max = float(np.abs(path[:, 2]).max())
    outer = stats.outer_iters.cpu().numpy()
    total = int(outer.sum())
    fps = (n_frames - 1) / sec
    print(f"# p2l path: {n_frames} frames of {pts.shape[1]} points, "
          f"{sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), bitwise equal to the first run; ATE-xy vs "
          f"ground truth {ate:.6f} m, max |z| {z_max:.6f} m; outer "
          f"iterations per frame mean {outer.mean():.3f} min {outer.min()} "
          f"max {outer.max()} total {total}; launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"p2l path ATE-xy {ate} >= {ATE_GATE_M}")
    if not z_max < P2L_Z_GATE_M:
        raise RuntimeError(f"p2l path max |z| {z_max} >= {P2L_Z_GATE_M}")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_list"] == launches["p2l_loop"] == total
                        and total > 0):
        raise RuntimeError(f"p2l path launches {launches}, expected "
                           f"{total} nn_list and p2l_loop")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    _, p_path, _, p_sec, p_launch = _run_p2l(pts[:plain_frames],
                                             mask[:plain_frames], plain_cfg,
                                             device, voxel)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# p2l plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s; trajectory vs kernel path {d:.3e} m (gate "
          f"{PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"p2l plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"p2l kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate, z_max=z_max, fps=fps,
                seconds=sec, outer_mean=float(outer.mean()))


def profile_p2l(device="cuda", n_frames: int = 16):
    """torch.profiler over the p2l path's first ``n_frames`` frames (after
    a warm-up run): device time by kernel, the device's idle share against
    an unprofiled run's wall time, and the voxel normals' share (their
    device time over the same dst frames, profiled on their own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    _run_p2l(pts, mask, cfg, device)
    _, _, _, wall, _ = _run_p2l(pts, mask, cfg, device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_p2l(pts, mask, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    frames = n_frames - 1
    p = torch.as_tensor(pts, dtype=torch.float32, device=device)
    k = torch.as_tensor(mask, device=device)
    dsts = [m_icp._spatial_sort(p[i], k[i]) for i in range(1, n_frames)]
    with profile(activities=[ProfilerActivity.CUDA]) as nprof:
        for dst, dmask, _ in dsts:
            estimate_normals_voxel(dst, dmask, P2L_VOXEL_M)
        _sync(device)
    normals_ms = sum(e.self_device_time_total for e in nprof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3
    print(f"# profile p2l: {frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms ({wall * 1e3 / frames:.3f} ms/frame); "
          f"device busy {busy_ms:.3f} ms ({busy_ms / frames:.3f} ms/frame),"
          f" idle share {1.0 - busy_ms / (wall * 1e3):.4f}; voxel normals "
          f"{normals_ms:.3f} ms device ({normals_ms / busy_ms:.4f} of busy)")
    for e in kern[:12]:
        print(f"# profile p2l kernel {e.self_device_time_total / 1e3:9.3f} "
              f"ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _frames_as_run(frames, device):
    """Frames stacked as the SLAM entry points stack them (padded to a
    multiple of 128, unsorted): (points, masks) on ``device``."""
    pts, mask = io.pad_points(frames)
    return (torch.as_tensor(pts, dtype=torch.float32, device=device),
            torch.as_tensor(mask, device=device))


def _sweep_check(kind, name, query, db, dmask, payload, device,
                 q_tile: int, db_tile: int):
    """One kernel 4/5/6 check: the kernel vs its plain version (bitwise
    dist, idx, payload) and vs a brute-force sweep (idx, trimmed dist, the
    winner's payload where a valid point exists, zeros where none does).
    query (..., Q, D); db (..., M, D).  Returns the timing record's
    inputs."""
    d_dim = query.shape[-1]
    n = query.shape[-2]
    if kind == "nn_pruned":
        args = nn_sweep_cuda.prepare_pruned(query, db, dmask, payload, q_tile,
                                            db_tile) + (d_dim, q_tile,
                                                        db_tile)
        fn, plain = nn_sweep_cuda.nn_pruned, nn_sweep_cuda.nn_pruned_plain
    else:
        q_pad = -(-n // q_tile) * q_tile
        query_p = torch.zeros((*query.shape[:-2], q_pad, d_dim),
                              dtype=torch.float32, device=device)
        query_p[..., :n, :] = query
        m_pad = -(-db.shape[-2] // db_tile) * db_tile
        pay = db[..., :0] if payload is None else payload
        dbf_cm = nn_cuda._dbf_cm_matched(db, dmask, pay, m_pad)
        if kind == "nn_sweep":
            args = (query_p, dbf_cm)
            fn, plain = nn_sweep_cuda.nn_sweep, nn_sweep_cuda.nn_sweep_plain
        else:
            args = (query_p, dbf_cm, d_dim)
            fn, plain = nn_sweep_cuda.nn_matched, \
                nn_sweep_cuda.nn_matched_plain
    got = fn(*args)
    want = plain(*args)
    _sync(device)
    what = f"{kind} {name}"
    _equal_or_raise(got, want, what)
    brute = nn_torch(query, db, dmask, tile=db_tile)
    hit = torch.isfinite(brute.dist_sq)
    dist = nn_cuda._trim_sentinel(got[0][..., :n])
    ok = (torch.equal(got[1][..., :n], brute.index)
          and torch.equal(dist, brute.dist_sq))
    if payload is not None:
        pay_n = got[2][..., :n, :]
        want_pay = torch.take_along_dim(
            payload.expand(*brute.index.shape[:-1], *payload.shape[-2:]),
            brute.index[..., None].long(), dim=-2)
        ok = (ok and torch.equal(pay_n[hit], want_pay[hit])
              and bool(torch.all(pay_n[~hit] == 0)))
    if not ok:
        raise RuntimeError(f"{what}: differs from brute force")
    fin = torch.isfinite(got[0])
    err = float(torch.max(torch.abs(got[0][fin] - want[0][fin]))) \
        if bool(fin.any()) else 0.0
    walked = None
    if kind == "nn_pruned":
        walked = nn_sweep_cuda.tiles_walked(*args)
    on_card = torch.device(device).type == "cuda"
    case_ms = time_ms(lambda: fn(*args), device, reps=3 if on_card else 1)
    batch = f"{query.shape[0]} x " if query.ndim == 3 else ""
    tiles = ""
    if walked is not None:
        slots = (args[0].shape[0] // nn_sweep_cuda.SUB
                 * (args[1].shape[1] // db_tile))
        tiles = f"; (block, db tile) sweeps {walked} of {slots}"
    print(f"# {what}: bitwise equal to plain and brute force; {batch}{n} "
          f"queries x {db.shape[-2]} db points ({int(dmask.sum())} valid), "
          f"F = {0 if payload is None else payload.shape[-1]}{tiles}; "
          f"{case_ms:.4f} ms")
    return dict(kind=kind, fn=fn, plain=plain, args=args, err=err,
                walked=walked, n=n, valid=float(dmask.sum()), db_tile=db_tile)


_SWEEP_SOURCES = {"nn_sweep": 55, "nn_matched": 177, "nn_pruned": 385}


def _sweep_record(case, path: str, device, max_abs_err: float):
    """Kernel 4, 5 or 6's timing, plain timing and bound at one case's
    shapes.  Operations: every (query, valid db point) pair of the plain
    sweeps; for kernel 6 the pairs of the (block, db tile) sweeps it
    makes on these inputs."""
    kind, args = case["kind"], case["args"]
    query_p, dbf_cm = args[0], args[1]
    d_dim = query_p.shape[-1]
    reps = 20 if torch.device(device).type == "cuda" else 1
    ms = time_ms(lambda: case["fn"](*args), device, reps=reps)
    plain_ms = time_ms(lambda: case["plain"](*args), device, reps=2)
    b = query_p.shape[0] if query_p.ndim == 3 else 1
    qp = query_p.shape[-2]
    f_dim = dbf_cm.shape[-2] - d_dim
    per_pair = NN_OPS_PER_PAIR_3D if d_dim == 3 else NN_OPS_PER_PAIR_2D
    if kind == "nn_pruned":
        pairs = float(case["walked"]) * nn_sweep_cuda.SUB * case["db_tile"]
        tables = sum(x.numel() * 4 for x in args[2:5])
    else:
        pairs = float(case["n"]) * case["valid"]
        tables = 0
    n_bytes = (query_p.numel() * 4 + dbf_cm.numel() * 4 + tables
               + b * qp * (4 + 4 + 4 * f_dim))
    bound, by = bound_ms(n_bytes, pairs * per_pair)
    return dict(name=kind, route="cuda", path=path,
                source=f"icp_rust_tpu_torch/csrc/{kind}.cu",
                replaces=f"icp_rust_tpu/ops/nn_pallas.py:{_SWEEP_SOURCES[kind]}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def phase_nn_sweeps(device="cuda", stride: int = 1, small: int = 3072,
                    n_wide: int = 8, q_tile: int = 512, db_tile: int = 2048):
    """Kernels 4, 5 and 6 vs their plain versions and a brute-force sweep,
    at the shapes the SLAM paths give them: kernel 6 at run_slam3d's full
    width (frames 0 and 1 as it pads them, unsorted and Morton-sorted,
    with exact ties, a masked db, the p2l payload unseeded and a fully
    masked db); kernels 5 and 4 on 3072-point frames (2 db tiles; the p2l
    payload for kernel 4) and on ``n_wide`` pairs of full xy scans (the
    batched 2D path off the pair-grid route)."""
    frames, _ = io.synthesize_frames3d(max(n_wide + 1, 2), seed=0)
    frames = [f[::stride] for f in frames]
    pts, mask = _frames_as_run(frames, device)
    src, smask, dst, dmask = pts[0], mask[0], pts[1], mask[1]
    cases, errs = {}, {"nn_sweep": 0.0, "nn_matched": 0.0, "nn_pruned": 0.0}

    def run(kind, name, query, db, dm, payload=None, qt=q_tile):
        c = _sweep_check(kind, name, query, db, dm, payload, device, qt,
                         db_tile)
        errs[kind] = max(errs[kind], c["err"])
        cases[(kind, name)] = c

    run("nn_pruned", "full-width", src, dst, dmask)
    s_src, s_smask, _ = m_icp._spatial_sort(src, smask)
    s_dst, s_dmask, _ = m_icp._spatial_sort(dst, dmask)
    run("nn_pruned", "morton-sorted", s_src, s_dst, s_dmask)
    half = int(dmask.sum()) // 2
    dup = torch.cat([dst[:half], dst[:half]])
    run("nn_pruned", "ties", dst[:half], dup,
        torch.ones(dup.shape[0], dtype=torch.bool, device=device))
    gen = torch.Generator(device="cpu").manual_seed(11)
    drop = torch.rand(dst.shape[0], generator=gen).to(device) < 0.5
    run("nn_pruned", "masked-db", src, dst, dmask & ~drop)
    normals, n_valid = estimate_normals_voxel(s_dst, s_dmask, P2L_VOXEL_M)
    payload = m_p2l.build_p2l_payload(s_dst, normals, n_valid, s_dmask)
    run("nn_pruned", "p2l-payload", s_src, s_dst, s_dmask, payload, qt=256)
    none = torch.zeros_like(dmask)
    run("nn_pruned", "all-masked", src, dst, none, payload, qt=256)

    # Small frames (2 db tiles): kernel 5 as _mean_nn_dist, kernel 4 with
    # the p2l payload as the point-to-plane ICP sorts and packs them.
    f_src, f_sm, _ = m_icp._spatial_sort(src[:small], smask[:small])
    f_dst, f_dm, _ = m_icp._spatial_sort(dst[:small], dmask[:small])
    run("nn_sweep", "small", src[:small], dst[:small], dmask[:small])
    nrm, nv = estimate_normals_voxel(f_dst, f_dm, P2L_VOXEL_M)
    run("nn_matched", "small-p2l", f_src, f_dst, f_dm,
        m_p2l.build_p2l_payload(f_dst, nrm, nv, f_dm), qt=256)
    run("nn_sweep", "small-all-masked", src[:small], dst[:small],
        none[:small])
    run("nn_matched", "small-all-masked", f_src, f_dst, none[:small],
        f_dst[:, :2], qt=256)
    # n_wide pairs of full xy scans, a batch grid axis.
    xy = pts[:, :, :2]
    run("nn_sweep", "wide-batched", xy[:-1], xy[1:], mask[1:])
    run("nn_matched", "wide-batched-xy", xy[:-1], xy[1:], mask[1:], xy[1:],
        qt=256)

    return [
        _sweep_record(cases[("nn_pruned", "full-width")], "slam3d", device,
                      errs["nn_pruned"]),
        _sweep_record(cases[("nn_sweep", "small")], "slam3d-small", device,
                      errs["nn_sweep"]),
        _sweep_record(cases[("nn_matched", "small-p2l")], "slam3d-small",
                      device, errs["nn_matched"]),
        _sweep_record(cases[("nn_sweep", "wide-batched")], "slam2d-wide",
                      device, errs["nn_sweep"]),
        _sweep_record(cases[("nn_matched", "wide-batched-xy")],
                      "slam2d-wide", device, errs["nn_matched"]),
    ]


def _run_slam(fn, frames, cfg, device, **kw):
    """One timed SLAM run with the launch counts zeroed just before it;
    returns (result, seconds, launches)."""
    _sync(device)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    res = fn(frames, cfg, device=device, **kw)
    _sync(device)
    return res, time.perf_counter() - t0, dict(cuda_build.LAUNCHES)


def phase_slam3d(device="cuda", n_frames: int = 96, stride: int = 1,
                 plain_frames: int = 12, voxel: float = P2L_VOXEL_M):
    """run_slam3d over the p2l path's synthetic frames with its defaults
    (loop radius 1 m, gap 8, at most 16 candidates), twice (the second run
    timed); then the kernel and the plain path on the first
    ``plain_frames`` frames."""
    frames, traj = io.synthesize_frames3d(n_frames, seed=0)
    frames = [f[::stride] for f in frames]
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    cfg = _config()
    kw = dict(normals_voxel_size=voxel)
    first, first_sec, _ = _run_slam(run_slam3d, frames, cfg, device, **kw)
    res, sec, launches = _run_slam(run_slam3d, frames, cfg, device, **kw)
    picked = m_slam._candidates(res.odometry_path, 1.0, 8, 16)
    ate = ate_rmse(res.optimized_path[:, :2], gt)
    ate_odo = ate_rmse(res.odometry_path[:, :2], gt)
    rerun = float(np.abs(res.optimized_path - first.optimized_path).max())
    print(f"# slam3d: {n_frames} frames of {frames[0].shape[0]}-"
          f"{max(len(f) for f in frames)} points, {sec:.4f} s per sequence, "
          f"{n_frames / sec:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s); candidates {len(picked)}, loop closures "
          f"{res.n_loop_closures}; graph error before {res.error_before:.6e} "
          f"after {res.error_after:.6e}; ATE-xy vs ground truth optimized "
          f"{ate:.6f} m, odometry {ate_odo:.6f} m; optimized path vs the "
          f"first run {rerun:.3e} m; launches {launches}")
    if res.n_loop_closures < 1:
        raise RuntimeError("slam3d: no loop closure")
    if not res.error_after <= res.error_before:
        raise RuntimeError("slam3d: the graph error grew")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"slam3d ATE-xy {ate} >= {ATE_GATE_M}")
    want = n_frames - 1 + len(picked)
    if torch.device(device).type == "cuda" and not (
            launches["nn_pruned"] == want and launches["nn_list"] > 0
            and launches["p2l_loop"] > 0 and launches["nn_sweep"] == 0
            and launches["nn_matched"] == 0):
        raise RuntimeError(f"slam3d launches {launches}, expected {want} "
                           "nn_pruned")
    head = frames[:plain_frames]
    k_res, _, _ = _run_slam(run_slam3d, head, cfg, device, **kw)
    p_res, p_sec, p_launch = _run_slam(
        run_slam3d, head, cfg.with_(nn_backend="torch",
                                    align_backend="torch"), device, **kw)
    d = float(np.abs(p_res.optimized_path - k_res.optimized_path).max())
    print(f"# slam3d plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s, loop closures {p_res.n_loop_closures} (kernel "
          f"path {k_res.n_loop_closures}); optimized path vs kernel path "
          f"{d:.3e} m (gate {PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"slam3d plain path launched kernels: {p_launch}")
    if not (d < PLAIN_GATE_M
            and p_res.n_loop_closures == k_res.n_loop_closures):
        raise RuntimeError(f"slam3d kernel vs plain path {d} m")
    return dict(launches=launches, ate=ate, seconds=sec,
                closures=res.n_loop_closures, candidates=len(picked))


def room_sequence(n_poses: int = 28, n_points: int = 3072,
                  scene_n: int = 6000, seed: int = 0):
    """A planar room (floor, two walls, a ramp) seen from a closing loop
    with full 6-DoF motion, ``n_points`` points per frame (the scene of
    the JAX package's tests/test_slam3d.py, made here with numpy and the
    port's geometry): (frames, ground-truth positions in pose 0's frame)."""
    rng = np.random.default_rng(seed)
    lo_hi = (([-3, -3, 0], [3, 3, 0], scene_n // 2),
             ([-3, -3, 0], [3, -3, 2], scene_n // 4),
             ([-3, 3, 0], [-3, 3, 2], scene_n // 4),
             ([1, 1, 0], [3, 3, 1], scene_n // 4))
    parts = [rng.uniform(lo, hi, (k, 3)) for lo, hi, k in lo_hi]
    parts[3][:, 2] = 0.5 * (parts[3][:, 0] - 1.0)
    scene = np.concatenate(parts).astype(np.float32)
    poses = []
    for k in range(n_poses):
        a = 2 * np.pi * k / (n_poses - 1)
        poses.append(RigidTransform3.from_twist(torch.tensor(
            [np.cos(a), np.sin(a), 0.05 * np.sin(2 * a), 0.02 * np.sin(a),
             0.02 * np.cos(a), a], dtype=torch.float32)))
    frames = []
    for p in poses:
        pts = p.inverse().apply_points(torch.as_tensor(scene)).numpy() \
            + rng.normal(0, 0.004, scene.shape).astype(np.float32)
        frames.append(pts[rng.permutation(len(pts))[:n_points]])
    p0_inv = poses[0].inverse()
    gt = np.stack([p0_inv.compose(p).t.numpy() for p in poses])
    return frames, gt.astype(np.float64)


def phase_slam3d_small(device="cuda", n_poses: int = 28,
                       n_points: int = 3072, scene_n: int = 6000):
    """run_slam3d on small frames (2 db tiles): kernels 4 and 5 serve its
    NN searches, and the loop closure pulls the end pose in."""
    frames, gt = room_sequence(n_poses, n_points, scene_n)
    kw = dict(loop_radius=0.8, min_gap=8, max_loop_candidates=8,
              normals_voxel_size=0.4)
    cfg = ICPConfig(compute_dtype=torch.float32)
    _, first_sec, _ = _run_slam(run_slam3d, frames, cfg, device, **kw)
    res, sec, launches = _run_slam(run_slam3d, frames, cfg, device, **kw)
    end_odo = float(np.linalg.norm(res.odometry_path[-1] - gt[-1]))
    end_opt = float(np.linalg.norm(res.optimized_path[-1] - gt[-1]))
    print(f"# slam3d small frames: {n_poses} frames of {n_points} points, "
          f"{sec:.4f} s (first run {first_sec:.4f} s); loop closures {res.n_loop_closures}; graph error "
          f"before {res.error_before:.6e} after {res.error_after:.6e}; end "
          f"error odometry {end_odo:.6f} m optimized {end_opt:.6f} m; "
          f"launches {launches}")
    if res.n_loop_closures < 1:
        raise RuntimeError("slam3d small frames: no loop closure")
    if not end_opt <= max(0.8 * end_odo, 0.02):
        raise RuntimeError(f"slam3d small frames: end error {end_opt} m")
    if torch.device(device).type == "cuda" and not (
            launches["nn_matched"] > 0 and launches["nn_sweep"] > 0
            and launches["nn_pruned"] == 0 and launches["nn_list"] == 0):
        raise RuntimeError(f"slam3d small frames launches {launches}")
    return dict(launches=launches, seconds=sec)


def phase_slam2d(device="cuda", n_scans: int = BATCH_SCANS,
                 pad: int = BATCH_PAD, wide_frames: int = 12,
                 wide_stride: int = 1):
    """run_slam2d on the batched path's scans (pair-grid and batched IRLS
    kernels; the batched mean NN distance on the plain sweep), then on the
    xy of ``wide_frames`` full frames (kernels 4 and 5 with a batch axis).
    The synthetic scans are in metres: loop radius 1.5 m and 1 m."""
    pts, mask, _, _ = scans2d(n_scans, pad)
    scans = [p[m] for p, m in zip(pts, mask)]
    cfg = _config()
    res, sec, launches = _run_slam(run_slam2d, scans, cfg, device,
                                   loop_radius=1.5, min_gap=20)
    print(f"# slam2d: {n_scans} scans padded to {pad}, {sec:.4f} s; loop "
          f"closures {res.n_loop_closures}; graph error before "
          f"{res.error_before:.6e} after {res.error_after:.6e}; launches "
          f"{launches}")
    if not res.error_after <= res.error_before:
        raise RuntimeError("slam2d: the graph error grew")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_pairs"] > 0
                        and launches["irls_loop_batched"] > 0
                        and launches["nn_sweep"] == 0
                        and launches["nn_matched"] == 0):
        raise RuntimeError(f"slam2d launches {launches}")
    frames, _ = io.synthesize_frames3d(wide_frames, seed=4)
    wide = [f[::wide_stride, :2] for f in frames]
    w_res, w_sec, w_launch = _run_slam(run_slam2d, wide, cfg, device,
                                       loop_radius=1.0, min_gap=8)
    print(f"# slam2d wide scans: {wide_frames} scans of {len(wide[0])} "
          f"points, {w_sec:.4f} s; loop closures {w_res.n_loop_closures}; "
          f"graph error before {w_res.error_before:.6e} after "
          f"{w_res.error_after:.6e}; launches {w_launch}")
    if not w_res.error_after <= w_res.error_before:
        raise RuntimeError("slam2d wide scans: the graph error grew")
    if on_card and not (w_launch["nn_matched"] > 0
                        and w_launch["nn_sweep"] > 0):
        raise RuntimeError(f"slam2d wide scans launches {w_launch}")
    return dict(launches=launches, wide_launches=w_launch, seconds=sec)


def profile_slam3d(device="cuda", n_frames: int = 96):
    """Where run_slam3d's time goes at full width: host-clock time (with a
    synchronise around each call) in its point-to-plane ICP calls, its
    mean-NN-distance calls (kernel 6) and its graph solve, against the
    run's wall time; then torch.profiler over a second run: device time by
    kernel and the device's idle share against an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames, _ = io.synthesize_frames3d(n_frames, seed=0)
    cfg = _config()
    spent = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    names = ("icp_point_to_plane", "_mean_nn_dist", "_solve_graph")
    saved = {n: getattr(m_slam, n) for n in names}
    _run_slam(run_slam3d, frames, cfg, device)
    _, wall, _ = _run_slam(run_slam3d, frames, cfg, device)
    try:
        for n in names:
            setattr(m_slam, n, timed(n, saved[n]))
        _, split_wall, _ = _run_slam(run_slam3d, frames, cfg, device)
    finally:
        for n in names:
            setattr(m_slam, n, saved[n])
    rest = split_wall - sum(spent.values())
    print(f"# profile slam3d: {n_frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms; with a synchronise around each call "
          f"{split_wall * 1e3:.3f} ms: " + ", ".join(
              f"{n} {spent[n] * 1e3:.3f} ms ({spent[n] / split_wall:.4f})"
              for n in names)
          + f", the rest {rest * 1e3:.3f} ms ({rest / split_wall:.4f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_slam(run_slam3d, frames, cfg, device)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile slam3d: device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile slam3d kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _gn_check(name, got, want, upd, ref):
    """Gate one gn_stats case: stats against the plain version's, and the
    update against weighted_gauss_newton_update's.  Returns (max relative
    error, max absolute error of the packed stats)."""
    rel, dn, sig_rel = align2d_cuda.gn_stats_errors(got, want)
    d = float(torch.max(torch.abs(upd.delta - ref.delta)))
    same_ok = torch.equal(upd.ok, ref.ok)
    print(f"# {name}: sums and error max rel {rel:.3e} (tol {GN_STATS_TOL}),"
          f" count diff {dn:g}, sigma rel {sig_rel:.3e} (tol "
          f"{GN_SIGMA_TOL}); update delta vs the einsum update {d:.3e} "
          f"(tol {GN_DELTA_TOL}), ok equal {same_ok} "
          f"({int(upd.ok.sum())} of {upd.ok.numel()} ok)")
    if not (rel <= GN_STATS_TOL and dn == 0.0 and sig_rel <= GN_SIGMA_TOL
            and d <= GN_DELTA_TOL and same_ok):
        raise RuntimeError(f"{name} differs from its plain version or the "
                           "einsum update")
    return rel, float(torch.max(torch.abs(got - want)))


def phase_gn_stats(device="cuda", stride: int = 1,
                   n_scans: int = BATCH_SCANS, pad: int = BATCH_PAD):
    """Kernels 12 and 13 vs their plain versions through
    align2d.weighted_gn_update_cuda (their only caller: their launches are
    counted there), at the main path's and the batched path's shapes."""
    cfg = _config()
    k, eps = cfg.huber_k, cfg.det_rel_eps
    src, smask, dst, dmask = _first_pair(device, stride)
    _, matched = nearest_neighbor_matched(
        src, dst, dmask, payload=dst[:, :2], backend="torch",
        tile=cfg.nn_dst_tile)
    s_xy = src[:, :2].contiguous()
    ident = RigidTransform2.identity(device=src.device)
    warm = align2d.estimate_transform(s_xy, matched, smask,
                                      cfg.with_(align_backend="torch"))
    b_src, b_smask, b_dst, b_dmask = _batch(device, n_scans, pad, sort=True)
    _, b_matched = nearest_neighbor_matched(b_src, b_dst, b_dmask,
                                            backend="torch", tile=pad)
    extra = torch.zeros_like(b_smask[:2])
    extra[1, :101] = True  # an odd count; row 0 all masked
    bs = torch.cat([b_src, b_src[:2]])
    bd = torch.cat([b_matched, b_matched[:2]])
    bk = torch.cat([b_smask, extra])
    rng = np.random.default_rng(8)
    tw = rng.normal(0, 1, (bs.shape[0], 3)) * [0.05, 0.05, 0.02]
    tw[-2:] = 0.0
    bt = RigidTransform2.from_twist(torch.as_tensor(
        tw, dtype=torch.float32, device=bs.device))
    cases = [("gn_stats identity", ident, s_xy, matched, smask),
             ("gn_stats warm", warm, s_xy, matched, smask),
             ("gn_stats_batched", bt, bs, bd, bk)]
    _sync(device)
    cuda_build.reset_launches()
    updates = [align2d.weighted_gn_update_cuda(t, a, b, m, k, eps)
               for _, t, a, b, m in cases]
    _sync(device)
    launches = dict(cuda_build.LAUNCHES)
    worst = {"gn_stats": (0.0, 0.0), "gn_stats_batched": (0.0, 0.0)}
    for (name, t, a, b, m), upd in zip(cases, updates):
        kern = name.split()[0]
        fn = getattr(align2d_cuda, kern)
        plain = getattr(align2d_cuda, kern + "_plain")
        ref = align2d.weighted_gauss_newton_update(t, a, b, m, k, eps)
        rel, err = _gn_check(name, fn(a, b, m, t.rot, t.t, k),
                             plain(a, b, m, t.rot, t.t, k), upd, ref)
        worst[kern] = tuple(map(max, worst[kern], (rel, err)))
    if not (updates[2].ok[-1] and not updates[2].ok[-2]):
        raise RuntimeError("gn_stats_batched: the odd-count pair is not ok "
                           "or the all-masked pair is")
    recs = []
    for kern, line, args in (
            ("gn_stats", 188, (s_xy, matched, smask, warm.rot, warm.t, k)),
            ("gn_stats_batched", 467, (bs, bd, bk, bt.rot, bt.t, k))):
        fn = getattr(align2d_cuda, kern)
        plain = getattr(align2d_cuda, kern + "_plain")
        ms = time_ms(lambda: fn(*args), device, reps=20)
        plain_ms = time_ms(lambda: plain(*args), device, reps=3)
        n_pts, n_pairs = args[0].shape[-2], args[0][..., 0, 0].numel()
        b, by = bound_ms(5 * n_pairs * n_pts * 4 + n_pairs * (6 + 16) * 4,
                         float(args[2].sum()) * IRLS_OPS_PER_POINT)
        recs.append(dict(name=kern, route="cuda", path=kern,
                         source=f"icp_rust_tpu_torch/csrc/{kern}.cu",
                         replaces=f"icp_rust_tpu/ops/align2d_pallas.py:{line}",
                         max_abs_err=worst[kern][1], ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=None,
                         launches=launches[kern], max_rel_err=worst[kern][0]))
    return recs


def _run_submap(pts, mask, cfg, device, with_metrics: bool = True, **kw):
    """One timed ``run_submap_odometry`` call with the launch counts zeroed
    just before it; returns (transforms, path, stats or None, seconds,
    launches, dropped points, hidden-cells warnings), the last two read
    from the runner's warnings."""
    _sync(device)
    cuda_build.reset_launches()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        out = run_submap_odometry(pts, mask, cfg, with_metrics=with_metrics,
                                  device=device, **kw)
        _sync(device)
        sec = time.perf_counter() - t0
    msgs = [str(w.message) for w in wl]
    dropped = sum(int(re.search(r"dropped (\d+) points", m).group(1))
                  for m in msgs if "hash map dropped" in m)
    hidden = [m for m in msgs if "view_rows hid" in m]
    stats = out[2] if with_metrics else None
    return (out[0], out[1], stats, sec, dict(cuda_build.LAUNCHES), dropped,
            hidden)


def phase_submap(device="cuda", n_frames: int = 96, stride: int = 1,
                 plain_frames: int = 8, tile: int = 2048, kw=None):
    """The scan-to-submap path at bench_submap.py's width, twice (bitwise
    equal; the second run timed), then the plain path on the first
    frames.  ``kw``: the map settings, for subsampled frames."""
    kw = SUBMAP_KW if kw is None else kw
    pts, mask, gt = frames3d(n_frames, stride)
    cfg = _config(nn_dst_tile=tile)
    tf1, path1, _, first_sec, _, _, _ = _run_submap(pts, mask, cfg, device,
                                                    **kw)
    tf, path, stats, sec, launches, dropped, hidden = _run_submap(
        pts, mask, cfg, device, **kw)
    if not (np.array_equal(path, path1) and torch.equal(tf.rot, tf1.rot)
            and torch.equal(tf.t, tf1.t)):
        raise RuntimeError("submap path: two runs differ")
    ate = ate_rmse(path, gt)
    outer = stats.outer_iters.cpu().numpy()
    total = int(outer.sum())
    fps = (n_frames - 1) / sec
    print(f"# submap path: {n_frames} frames of {pts.shape[1]} points, "
          f"{kw}, {sec:.4f} s, {fps:.2f} frames/s (host clock; first run "
          f"{first_sec:.4f} s), bitwise equal to the first run; ATE vs "
          f"ground truth {ate:.6f} m; outer iterations per frame mean "
          f"{outer.mean():.3f} min {outer.min()} max {outer.max()} total "
          f"{total}; dropped points {dropped}; hidden-cells warnings "
          f"{len(hidden)}; launches {launches}")
    if not ate < ATE_GATE_M:
        raise RuntimeError(f"submap path ATE {ate} >= {ATE_GATE_M}")
    if hidden:
        raise RuntimeError(f"submap path hid occupied cells: {hidden}")
    on_card = torch.device(device).type == "cuda"
    if on_card and not (launches["nn_list"] == launches["irls_loop"] == total
                        and total > 0):
        raise RuntimeError(f"submap path launches {launches}, expected "
                           f"{total} nn_list and irls_loop")
    plain_cfg = cfg.with_(nn_backend="torch", align_backend="torch")
    _, p_path, _, p_sec, p_launch, _, _ = _run_submap(
        pts[:plain_frames], mask[:plain_frames], plain_cfg, device, **kw)
    d = ate_rmse(p_path, path[:plain_frames - 1])
    print(f"# submap plain path on the first {plain_frames} frames: "
          f"{p_sec:.3f} s; trajectory vs kernel path {d:.3e} m (gate "
          f"{PLAIN_GATE_M})")
    if any(p_launch.values()):
        raise RuntimeError(f"submap plain path launched kernels: {p_launch}")
    if not d < PLAIN_GATE_M:
        raise RuntimeError(f"submap kernel vs plain trajectory {d} m")
    return dict(launches=launches, ate=ate, fps=fps, seconds=sec,
                outer_total=total, dropped=dropped)


def walls_sequence(n_frames: int = 8, n_pts: int = 400, seed: int = 0):
    """The JAX package's tests/test_submap.py wall world, scanned from a
    slowly moving pose: frames (F, n_pts, 2) in sensor coordinates and the
    ground-truth sensor positions in frame 0's coordinates."""
    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(8):
        a = rng.uniform(-8, 8, 2)
        ang = rng.uniform(0, np.pi)
        walls.append((a, np.array([np.cos(ang), np.sin(ang)]),
                      rng.uniform(3, 8)))
    poses = np.column_stack([0.06 * np.arange(n_frames),
                             0.04 * np.arange(n_frames),
                             0.015 * np.arange(n_frames)])
    frames = []
    for x, y, th in poses:
        widx = rng.integers(0, len(walls), n_pts)
        ts = rng.uniform(0, 1, n_pts)
        pw = np.stack([walls[i][0] + walls[i][1] * t * walls[i][2]
                       for i, t in zip(widx, ts)])
        c, s = np.cos(th), np.sin(th)
        local = (pw - [x, y]) @ np.array([[c, -s], [s, c]])
        frames.append(local + rng.normal(0, 0.003, local.shape))
    c, s = np.cos(poses[0, 2]), np.sin(poses[0, 2])
    gt = (poses[1:, :2] - poses[0, :2]) @ np.array([[c, -s], [s, c]])
    return np.stack(frames), gt


def phase_submap_2d(device="cuda", n_frames: int = 8, n_pts: int = 400):
    """The small 2D runs, fused and re-voxelize, on the wall world."""
    pts, gt = walls_sequence(n_frames, n_pts)
    mask = np.ones(pts.shape[:2], bool)
    cfg = _config()
    out = {}
    for fused in (True, False):
        _, path, _, sec, launches, dropped, _ = _run_submap(
            pts, mask, cfg, device, with_metrics=False, fused=fused,
            **SUBMAP_2D_KW)
        err = float(np.linalg.norm(path - gt, axis=1).max())
        name = "fused" if fused else "re-voxelize"
        print(f"# submap 2D {name}: {n_frames} frames of {n_pts} points, "
              f"{sec:.4f} s; max error vs ground truth {err:.6f} m (gate "
              f"{SUBMAP_2D_GATE_M}); dropped points {dropped}; launches "
              f"{launches}")
        if not err < SUBMAP_2D_GATE_M:
            raise RuntimeError(f"submap 2D {name}: max error {err} m")
        if torch.device(device).type == "cuda" and not (
                launches["nn_matched"] > 0 and launches["irls_loop"] > 0
                and launches["nn_list"] == 0):
            raise RuntimeError(f"submap 2D {name} launches {launches}")
        out[name] = dict(launches=launches, err=err)
    return out


def profile_submap(device="cuda", n_frames: int = 96):
    """Where the submap path's time goes at full width: host-clock time
    (with a synchronise around each call) in its ICP calls, its hash
    inserts and its Morton resorts, against the run's wall time; then
    torch.profiler over a second run: device time by kernel and the
    device's idle share against an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, mask, _ = frames3d(n_frames)
    cfg = _config()
    spent = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    patches = ((m_submap, "icp3d_planar"), (m_submap.vh, "insert"),
               (m_submap, "morton_order"))
    saved = [getattr(mod, n) for mod, n in patches]
    _run_submap(pts, mask, cfg, device, with_metrics=False, **SUBMAP_KW)
    wall = _run_submap(pts, mask, cfg, device, with_metrics=False,
                       **SUBMAP_KW)[3]
    try:
        for (mod, n), fn in zip(patches, saved):
            setattr(mod, n, timed(n, fn))
        split_wall = _run_submap(pts, mask, cfg, device, with_metrics=False,
                                 **SUBMAP_KW)[3]
    finally:
        for (mod, n), fn in zip(patches, saved):
            setattr(mod, n, fn)
    rest = split_wall - sum(spent.values())
    print(f"# profile submap: {n_frames} frames, unprofiled wall "
          f"{wall * 1e3:.3f} ms ({wall * 1e3 / (n_frames - 1):.3f} ms/frame);"
          f" with a synchronise around each call {split_wall * 1e3:.3f} ms: "
          + ", ".join(f"{n} {spent[n] * 1e3:.3f} ms "
                      f"({spent[n] / split_wall:.4f})" for _, n in patches)
          + f", the rest {rest * 1e3:.3f} ms ({rest / split_wall:.4f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_submap(pts, mask, cfg, device, with_metrics=False, **SUBMAP_KW)
    avgs = prof.key_averages()
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"# profile submap: device busy {busy_ms:.3f} ms "
          f"({busy_ms / (n_frames - 1):.3f} ms/frame), idle share "
          f"{1.0 - busy_ms / (wall * 1e3):.4f}")
    for e in kern[:12]:
        print(f"# profile submap kernel {e.self_device_time_total / 1e3:9.3f}"
              f" ms {e.count:6d} calls  {e.key[:90]}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))


def _ptxas_lines(report: dict):
    for name, log in sorted(report.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")


def main() -> int:
    profile_run = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 must be False for the geometry")
    device = "cuda"
    t0 = time.perf_counter()
    _ptxas_lines(cuda_build.build())
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {smi}")
    records = [phase_nn_list(device), phase_irls(device), phase_frame(device)]
    main_run = phase_main(device)
    run_2d = phase_2d(device)
    records += phase_nn_pairs(device)
    records += [phase_irls_batched(device), phase_frame_pairs(device)]
    batched = phase_batched(device)
    records += [phase_nn_list_p2l(device), phase_p2l_loop(device),
                phase_p2l_stats(device)]
    p2l = phase_p2l(device)
    records += phase_nn_sweeps(device)
    slam3 = phase_slam3d(device)
    slam3_small = phase_slam3d_small(device)
    slam2 = phase_slam2d(device)
    records += phase_gn_stats(device)
    sub = phase_submap(device)
    sub_2d = phase_submap_2d(device)
    if profile_run:
        profile_main(device)
        profile_batched(device)
        profile_p2l(device)
        profile_slam3d(device)
        profile_submap(device)
    launches = {
        ("nn_list", "main"): main_run["launches"]["nn_list"],
        ("irls_loop", "main"): main_run["launches"]["irls_loop"],
        ("icp2d_frame", "2d"): run_2d["launches"]["icp2d_frame"],
        ("nn_pairs", "batched"): batched["launches"]["nn_pairs"],
        ("nn_pairs_list", "batched"): batched["launches"]["nn_pairs_list"],
        ("irls_loop_batched", "batched"):
            batched["launches"]["irls_loop_batched"],
        ("icp2d_frame_pairs", "batched"):
            batched["frame_launches"]["icp2d_frame_pairs"],
        ("nn_list", "p2l"): p2l["launches"]["nn_list"],
        ("p2l_loop", "p2l"): p2l["launches"]["p2l_loop"],
        ("nn_pruned", "slam3d"): slam3["launches"]["nn_pruned"],
        ("nn_sweep", "slam3d-small"): slam3_small["launches"]["nn_sweep"],
        ("nn_matched", "slam3d-small"):
            slam3_small["launches"]["nn_matched"],
        ("nn_sweep", "slam2d-wide"): slam2["wide_launches"]["nn_sweep"],
        ("nn_matched", "slam2d-wide"): slam2["wide_launches"]["nn_matched"],
    }
    runs = {"main": main_run["launches"], "2d": run_2d["launches"],
            "batched": batched["launches"],
            "batched-pairs": batched["frame_launches"],
            "p2l": p2l["launches"], "slam3d": slam3["launches"],
            "slam3d-small": slam3_small["launches"],
            "slam2d": slam2["launches"],
            "slam2d-wide": slam2["wide_launches"],
            "submap": sub["launches"],
            "submap-2d": sub_2d["fused"]["launches"],
            "submap-2d-revoxelize": sub_2d["re-voxelize"]["launches"]}
    for rec in records:
        if (rec["name"], rec["path"]) in launches:
            rec["launches"] = launches[(rec["name"], rec["path"])]
        if rec["launches"] <= 0:
            raise RuntimeError(f"{rec['name']} never launched on its path "
                               f"({rec['path']})")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    # One entry per kernel: its first record's path and shapes; the other
    # shapes it was timed at, and its launches on every path driven.
    entries = {}
    for rec in records:
        entry = entries.get(rec["name"])
        if entry is None:
            entry = entries[rec["name"]] = {k: rec[k] for k in keys}
            entry["launches_by_path"] = {rec["path"]: rec["launches"]}
            entry["launches_by_path"].update(
                (p, n[rec["name"]]) for p, n in runs.items()
                if n[rec["name"]])
            entry["other_shapes"] = []
        else:
            entry["other_shapes"].append({k: rec[k] for k in (
                "path", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")})
    if sorted(entries) != sorted(cuda_build.SOURCES):
        raise RuntimeError(f"kernels line has {sorted(entries)}")
    print(f"# submap: {sub['fps']:.2f} frames/s, ATE {sub['ate']:.6f} m, "
          f"{sub['outer_total']} outer iterations, dropped points "
          f"{sub['dropped']}; 2D max errors "
          f"{sub_2d['fused']['err']:.6f} / {sub_2d['re-voxelize']['err']:.6f}"
          f" m")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
