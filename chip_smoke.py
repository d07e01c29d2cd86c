#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the seven Hopper kernels from ``icp_rust_tpu_torch/csrc`` (one
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

The launch counts of each path are zeroed just before it and read just
after.  Prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Bounds:
the larger of (bytes read once + written once) / 3.35 TB/s and counted
operations / 67 TFLOP/s (H100 SXM float32 without tensor cores).

    python3 chip_smoke.py --profile

adds torch.profiler traces of the main path's first 16 frames and of the
batched path: device time by kernel and the device's idle share, and the
profiler's table.

The phases take ``device`` and sizes, so a CPU test rehearses them at a
tiny size with the kernels' plain versions.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models import icp2d as m_icp
from icp_rust_tpu_torch.models.odometry import ate_rmse, run_odometry_fused
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, cuda_build, \
    nn_cuda, nn_pairs_cuda
from icp_rust_tpu_torch.ops.nn import nearest_neighbor_matched, nn_torch
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
# The batched workload: 210 scans, the size of the reference's scans/2d
# sequence (411-670 points per scan, padded to 768).
BATCH_SCANS = 210
BATCH_PAD = 768
BATCH_COUNTS = (411, 670)


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


def phase_nn_list(device="cuda", stride: int = 1, tile: int = 2048,
                  q_tile: int = 256):
    """Kernel 1 vs its plain version and a brute-force sweep."""
    cfg = _config(nn_dst_tile=tile, nn_query_tile=q_tile)
    src, smask, dst, dmask = _first_pair(device, stride)
    n = src.shape[0]
    qp = -(-n // q_tile) * q_tile
    eps = torch.finfo(torch.float32).eps

    def padded(q):
        out = torch.zeros((qp, 3), dtype=torch.float32, device=device)
        out[:n] = q
        return out

    def run_case(name, query, db, dmask_c, qb_fn):
        pack = nn_cuda.pack_db(db, dmask_c, db[:, :2], db_tile=tile)
        n_chunks = pack.dbf_cm.shape[1] // 128
        cap = min(nn_cuda._LIST_CAP, n_chunks)
        query_p = padded(query)
        qb = qb_fn(query_p, pack)
        lists, cnt = nn_cuda._survivor_lists(query_p, pack.cbox, qb, 3,
                                             q_tile, cap)
        got = nn_cuda.nn_list(query_p, pack.dbf_cm, lists, cnt, 3, q_tile,
                              cap)
        want = nn_cuda.nn_list_plain(query_p, pack.dbf_cm, lists, cnt, 3,
                                     q_tile, cap)
        _sync(device)
        for a, b, what in zip(got, want, ("dist", "idx", "payload")):
            if not torch.equal(a, b):
                raise RuntimeError(f"nn_list {name}: {what} differs from "
                                   "the plain version")
        brute = nn_torch(query, db, dmask_c, tile=tile)
        if not (torch.equal(got[1][:n], brute.index)
                and torch.equal(nn_cuda._trim_sentinel(got[0][:n]),
                                brute.dist_sq)):
            raise RuntimeError(f"nn_list {name}: differs from brute force")
        walked = torch.where(cnt > cap, n_chunks, cnt)
        fin = torch.isfinite(got[0])
        err = float(torch.max(torch.abs(got[0][fin] - want[0][fin]))) \
            if bool(fin.any()) else 0.0
        case_ms = time_ms(lambda: nn_cuda.nn_list(
            query_p, pack.dbf_cm, lists, cnt, 3, q_tile, cap), device, reps=5)
        print(f"# nn_list {name}: bitwise equal to plain and brute force; "
              f"chunks walked per tile mean {float(walked.float().mean()):.2f}"
              f" max {int(walked.max())} of {n_chunks} "
              f"(full sweeps {int((cnt > cap).sum())}); {case_ms:.4f} ms")
        return dict(query_p=query_p, pack=pack, lists=lists, cnt=cnt,
                    walked=walked, cap=cap, err=err, dist=got[0][:n],
                    pay=got[2][:n])

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
    args = (warm["query_p"], warm["pack"].dbf_cm, warm["lists"],
            warm["cnt"], 3, q_tile, warm["cap"])
    ms = time_ms(lambda: nn_cuda.nn_list(*args), device, reps=50)
    plain_ms = time_ms(lambda: nn_cuda.nn_list_plain(*args), device, reps=3)
    f_total = warm["pack"].dbf_cm.shape[0]
    pairs = float(warm["walked"].sum()) * 128 * q_tile
    n_bytes = (qp * 3 * 4 + warm["pack"].dbf_cm.numel() * 4
               + warm["lists"].numel() * 4 + warm["cnt"].numel() * 4
               + qp * (4 + 4 + 4 * (f_total - 3)))
    b, by = bound_ms(n_bytes, pairs * NN_OPS_PER_PAIR_3D)
    return dict(name="nn_list", route="cuda",
                source="icp_rust_tpu_torch/csrc/nn_list.cu",
                replaces="icp_rust_tpu/ops/nn_pallas.py:873",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None)


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
    return dict(name="irls_loop", route="cuda",
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
    return dict(name="icp2d_frame", route="cuda",
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
            name=rec_name, route="cuda",
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
    return dict(name="irls_loop_batched", route="cuda",
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
    return dict(name="icp2d_frame_pairs", route="cuda",
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
    if profile_run:
        profile_main(device)
        profile_batched(device)
    launches = {"nn_list": main_run["launches"]["nn_list"],
                "irls_loop": main_run["launches"]["irls_loop"],
                "icp2d_frame": run_2d["launches"]["icp2d_frame"],
                "nn_pairs": batched["launches"]["nn_pairs"],
                "nn_pairs_list": batched["launches"]["nn_pairs_list"],
                "irls_loop_batched": batched["launches"]["irls_loop_batched"],
                "icp2d_frame_pairs":
                    batched["frame_launches"]["icp2d_frame_pairs"]}
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["launches"] <= 0:
            raise RuntimeError(f"{rec['name']} never launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
