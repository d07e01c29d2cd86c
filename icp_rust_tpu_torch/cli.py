"""Command-line interface: the counterpart of the reference's example
binaries (examples/scan2d.rs, scan3d.rs), headless, with JSONL metrics,
checkpoints and trajectory export (the JAX package's ``cli.py``).

Usage (from the repo root):
    python -m icp_rust_tpu_torch.cli odometry2d --scans DIR [--frames N]
        [--compare-oracle] [--f32] [--device cpu|cuda]
        [--metrics run.jsonl] [--checkpoint ck.npz --every 10 [--resume]]
        [--plot traj.png] [--submap]
    python -m icp_rust_tpu_torch.cli odometry3d --hdf5 scans.hdf5
        [--synthesize N] [--p2l]
    python -m icp_rust_tpu_torch.cli slam --scans DIR  (odometry + loop
        closures + pose graph)
    python -m icp_rust_tpu_torch.cli slam3d --hdf5 scans.hdf5  (SE(3)
        p2l odometry + 3D loop closures + SE(3) pose graph)

Each command prints a one-line JSON summary and runs on ``--device``
(``cuda`` unless given).  ``--f32`` runs the float32 config there; the
float64 reference-parity config runs only with ``--device cpu``, and
without ``--f32`` on the card the command exits with guidance.  ``odometry3d`` and ``slam3d`` read HDF5 and need ``h5py``;
plots need ``matplotlib``; both are imported only where used.  The JAX
package's persistent compile cache has no counterpart here: the CUDA
kernels are built once into ``icp_rust_tpu_torch/_build/``
(``ops/cuda_build.py``), which every later run reuses.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _config(args):
    """(config, device) for the command's flags."""
    import torch

    from icp_rust_tpu_torch.config import ICPConfig

    if args.f32:
        return ICPConfig(compute_dtype=torch.float32,
                         point_scale=float(args.point_scale),
                         det_rel_eps=1e-9), args.device
    if args.device != "cpu":
        # The card runs float32 only; fail with guidance instead of the
        # entry point's error deep in the run.
        raise SystemExit(
            "the float64 reference-parity config runs on the CPU only; "
            "pass --f32 to run on the card (python -m "
            "icp_rust_tpu_torch.cli ... --f32), or --device cpu for the "
            "float64 config")
    return ICPConfig(compute_dtype=torch.float64), "cpu"


def _pyplot(what: str = "plot"):
    """matplotlib's pyplot on the Agg backend; None, after saying that
    ``what`` is skipped, when matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib unavailable; skipping {what}", file=sys.stderr)
        return None
    return plt


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _plot(path_xy: np.ndarray, out: str, extra=None):
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(path_xy[:, 0], path_xy[:, 1], "-o", ms=2, label="trajectory")
    if extra is not None:
        ax.plot(extra[:, 0], extra[:, 1], "-x", ms=2, label="oracle")
        ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")


def _overlay_frames(frames, transforms, path, out_dir, every, offset=0):
    """Per-frame scan overlay, pose axes and trajectory every ``every``
    frames as PNGs (the headless counterpart of reference
    examples/scan2d.rs:92-112 and scan3d.rs:133-161).  3D scans and paths
    render as their xy projection; a 2D transform on a 3D scan (the planar
    driver) back-transforms xy only.  ``offset``: the frame index of
    ``transforms[0]`` minus 1 (after a resume the list is shorter than
    the path)."""
    plt = _pyplot("overlays")
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    base = np.asarray(frames[0], np.float64)
    path = np.asarray(path, np.float64)
    for i in range(0, len(transforms), every):
        t = transforms[i]
        fi = offset + i
        rot, tt = _np(t.rot), _np(t.t)
        # The driver maps first-frame -> current-frame; draw the current
        # scan back in the first frame: p0 = R^T (p - t).
        scan = np.asarray(frames[fi + 1], np.float64)
        if rot.shape[0] == scan.shape[1]:
            scan = (scan - tt) @ rot
        else:
            scan = np.concatenate([(scan[:, :2] - tt) @ rot, scan[:, 2:]],
                                  axis=1)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(base[:, 0], base[:, 1], ".", ms=1, color="#999",
                label="frame 0")
        ax.plot(scan[:, 0], scan[:, 1], ".", ms=1, color="#d33",
                label=f"frame {fi + 1}")
        ax.plot(path[: fi + 1, 0], path[: fi + 1, 1], "-", color="#36c",
                lw=1, label="trajectory")
        # Pose axes at the sensor position: the xy of R's first two
        # columns, the sensor's x and y axes in frame 0.
        pos = path[fi]
        span = float(np.abs(base).max()) * 0.08
        ax.arrow(pos[0], pos[1], rot[0, 0] * span, rot[1, 0] * span,
                 color="#2a2", width=span * 0.02)
        ax.arrow(pos[0], pos[1], rot[0, 1] * span, rot[1, 1] * span,
                 color="#a2a", width=span * 0.02)
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=7)
        fig.savefig(os.path.join(out_dir, f"frame_{fi + 1:04d}.png"),
                    dpi=100)
        plt.close(fig)
    print(f"wrote overlays to {out_dir}", file=sys.stderr)


def _checkpointer(args):
    from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer

    if not args.checkpoint:
        return None
    return SequenceCheckpointer(args.checkpoint, args.every)


def _oracle_path(frames):
    """The reference flow on the native C++ oracle, or on the numpy one
    when the native library cannot be built; returns (path, name)."""
    from icp_rust_tpu_torch.native import oracle as native

    if native.available():
        return native.run_odometry2d(frames)[1], "native_cpp"
    from icp_rust_tpu_torch.utils import oracle_np

    return oracle_np.run_odometry2d(frames)[1], "numpy"


def cmd_odometry2d(args):
    from icp_rust_tpu_torch.models.odometry import ate_rmse, \
        run_odometry_device
    from icp_rust_tpu_torch.models.submap import run_submap_odometry
    from icp_rust_tpu_torch.utils import io as scan_io
    from icp_rust_tpu_torch.utils.metrics import MetricsLogger

    cfg, device = _config(args)
    frames = scan_io.load_scan2d_sequence(args.scans, limit=args.frames)
    # The reference example starts at 001.txt (examples/scan2d.rs:69-71).
    frames = frames[1:]
    pts, mask = scan_io.pad_points(frames)
    log = MetricsLogger(args.metrics) if args.metrics else None
    ckpt = _checkpointer(args)
    t0 = time.perf_counter()
    transforms = None
    if args.submap:
        # The scan-to-scan path's observability surface: JSONL rows (wall
        # time per segment, shared by its frames), every-K checkpoints of
        # the whole carry with the voxel map, bitwise --resume.
        _, path = run_submap_odometry(
            pts, mask, cfg, voxel_size=args.voxel_size,
            capacity=args.map_capacity, metrics=log, checkpoint=ckpt,
            resume=args.resume, warm_start=args.warm_start,
            view_rows=args.view_rows, device=device)
    else:
        transforms, path = run_odometry_device(
            pts, mask, cfg, metrics=log, checkpoint=ckpt,
            resume=args.resume, device=device)
    seconds = time.perf_counter() - t0
    if log is not None:
        log.close()
    if args.overlay_dir and transforms is not None:
        _overlay_frames(frames, transforms, path, args.overlay_dir,
                        args.overlay_every, len(path) - len(transforms))
    summary = {
        "frames": len(frames) - 1,
        "seconds": seconds,
        "frames_per_s": (len(frames) - 1) / seconds,
        "path_end": path[-1].tolist(),
    }
    if args.compare_oracle:
        path_o, summary["oracle"] = _oracle_path(frames)
        summary["ate_rmse_vs_oracle"] = ate_rmse(path, path_o)
        if args.plot:
            _plot(path, args.plot, extra=path_o)
    elif args.plot:
        _plot(path, args.plot)
    print(json.dumps(summary))


def _frames3d(args):
    from icp_rust_tpu_torch.utils import io as scan_io

    if args.synthesize:
        scan_io.synthesize_scans3d(args.hdf5, n_frames=args.synthesize)
        print(f"synthesized {args.synthesize} frames -> {args.hdf5}",
              file=sys.stderr)
    frames = scan_io.load_scans3d_hdf5(args.hdf5)
    return frames[: args.frames] if args.frames else frames


def cmd_odometry3d(args):
    from icp_rust_tpu_torch.models.odometry import run_odometry_device, \
        run_odometry_p2l
    from icp_rust_tpu_torch.utils import io as scan_io
    from icp_rust_tpu_torch.utils.metrics import MetricsLogger

    cfg, device = _config(args)
    frames = _frames3d(args)
    pts, mask = scan_io.pad_points(frames)
    log = MetricsLogger(args.metrics) if args.metrics else None
    kw = dict(metrics=log, checkpoint=_checkpointer(args),
              resume=args.resume, device=device)
    t0 = time.perf_counter()
    if args.p2l:
        # SE(3) point-to-plane odometry (voxel-PCA normals) instead of
        # the reference's planar 3D-match/SE(2)-solve flow.
        transforms, path = run_odometry_p2l(
            pts, mask, cfg, normals_voxel_size=args.normals_voxel, **kw)
    else:
        transforms, path = run_odometry_device(pts, mask, cfg, **kw)
    seconds = time.perf_counter() - t0
    if log is not None:
        log.close()
    if args.overlay_dir and transforms:
        _overlay_frames(frames, transforms, path, args.overlay_dir,
                        args.overlay_every, len(path) - len(transforms))
    summary = {
        "frames": len(frames) - 1,
        "seconds": seconds,
        "frames_per_s": (len(frames) - 1) / seconds,
        "path_end": path[-1].tolist(),
    }
    if args.plot:
        _plot(path, args.plot)
    print(json.dumps(summary))


def cmd_slam(args):
    from icp_rust_tpu_torch.models.slam import run_slam2d
    from icp_rust_tpu_torch.utils import io as scan_io

    cfg, device = _config(args)
    frames = scan_io.load_scan2d_sequence(args.scans, limit=args.frames)[1:]
    result = run_slam2d(frames, cfg, loop_radius=args.loop_radius,
                        min_gap=args.loop_gap, checkpoint=_checkpointer(args),
                        resume=args.resume, device=device)
    summary = {
        "frames": len(frames) - 1,
        "loop_closures": int(result.n_loop_closures),
        "graph_error_before": float(result.error_before),
        "graph_error_after": float(result.error_after),
    }
    if args.plot:
        _plot(result.optimized_path, args.plot, extra=result.odometry_path)
    print(json.dumps(summary))


def cmd_slam3d(args):
    from icp_rust_tpu_torch.models.slam import run_slam3d

    cfg, device = _config(args)
    frames = _frames3d(args)
    result = run_slam3d(
        frames, cfg, loop_radius=args.loop_radius, min_gap=args.loop_gap,
        normals_voxel_size=args.normals_voxel,
        checkpoint=_checkpointer(args), resume=args.resume, device=device)
    if args.overlay_dir:
        # The optimized pose maps frame-k points into the map frame;
        # _overlay_frames applies the inverse of what it is given, so it
        # gets pose^-1 (reference examples/scan3d.rs:133-161, xy).
        poses = result.poses
        transforms = [type(poses)(poses.rot[k], poses.t[k]).inverse()
                      for k in range(1, poses.t.shape[0])]
        _overlay_frames(frames, transforms, result.optimized_path[1:],
                        args.overlay_dir, args.overlay_every)
    summary = {
        "frames": len(frames) - 1,
        "loop_closures": int(result.n_loop_closures),
        "graph_error_before": float(result.error_before),
        "graph_error_after": float(result.error_after),
        "path_end": result.optimized_path[-1].tolist(),
    }
    if args.plot:
        _plot(result.optimized_path[:, :2], args.plot,
              extra=result.odometry_path[:, :2])
    print(json.dumps(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="icp_rust_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--frames", type=int, default=None)
        p.add_argument("--f32", action="store_true",
                       help="the float32 config; without it the float64 "
                            "config, which needs --device cpu")
        p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
        p.add_argument("--point-scale", default=3000.0)
        p.add_argument("--metrics", default=None)
        p.add_argument("--plot", default=None)
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--every", type=int, default=10)
        p.add_argument("--resume", action="store_true",
                       help="resume from --checkpoint's last saved state")
        p.add_argument("--overlay-dir", default=None,
                       help="dump per-frame scan-overlay PNGs here")
        p.add_argument("--overlay-every", type=int, default=5)

    p2 = sub.add_parser("odometry2d")
    p2.add_argument("--scans", required=True)
    p2.add_argument("--compare-oracle", action="store_true")
    p2.add_argument("--submap", action="store_true")
    p2.add_argument("--voxel-size", type=float, default=30.0)
    p2.add_argument("--map-capacity", type=int, default=8192)
    p2.add_argument("--warm-start", choices=("prev", "cv"), default="prev",
                    help="submap warm start; cv is unstable on long "
                         "sequences")
    p2.add_argument("--view-rows", type=int, default=None,
                    help="match against only the first N rows of the "
                         "sorted map view (exact while occupancy fits; "
                         "overflow warns)")
    common(p2)
    p2.set_defaults(fn=cmd_odometry2d)

    p3 = sub.add_parser("odometry3d")
    p3.add_argument("--hdf5", required=True)
    p3.add_argument("--synthesize", type=int, default=None)
    p3.add_argument("--p2l", action="store_true",
                    help="SE(3) point-to-plane instead of planar SE(2)")
    p3.add_argument("--normals-voxel", type=float, default=0.3)
    common(p3)
    p3.set_defaults(fn=cmd_odometry3d)

    p3s = sub.add_parser("slam3d")
    p3s.add_argument("--hdf5", required=True)
    p3s.add_argument("--synthesize", type=int, default=None)
    p3s.add_argument("--loop-radius", type=float, default=1.0)
    p3s.add_argument("--loop-gap", type=int, default=8)
    p3s.add_argument("--normals-voxel", type=float, default=0.3)
    common(p3s)
    p3s.set_defaults(fn=cmd_slam3d)

    ps = sub.add_parser("slam")
    ps.add_argument("--scans", required=True)
    ps.add_argument("--loop-radius", type=float, default=300.0)
    ps.add_argument("--loop-gap", type=int, default=20)
    common(ps)
    ps.set_defaults(fn=cmd_slam)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
