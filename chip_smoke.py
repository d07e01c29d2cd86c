#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the three Hopper kernels from ``icp_rust_tpu_torch/csrc`` (one
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

The launch counts of each path are zeroed just before it and read just
after.  Prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Bounds:
the larger of (bytes read once + written once) / 3.35 TB/s and counted
operations / 67 TFLOP/s (H100 SXM float32 without tensor cores).

    python3 chip_smoke.py --profile

adds a torch.profiler trace of the main path's first 16 frames: device
time by kernel and the device's idle share, and the profiler's table.

The phases take ``device`` and sizes, so a CPU test rehearses them at a
tiny size with the kernels' plain versions.
"""

from __future__ import annotations

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
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, cuda_build, nn_cuda
from icp_rust_tpu_torch.ops.nn import nearest_neighbor_matched, nn_torch
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
    if profile_run:
        profile_main(device)
    launches = {"nn_list": main_run["launches"]["nn_list"],
                "irls_loop": main_run["launches"]["irls_loop"],
                "icp2d_frame": run_2d["launches"]["icp2d_frame"]}
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
