"""3D odometry demo: the reference examples/scan3d.rs flow, headless.

Takes the synthetic 3D sequence (75 packets x 384 points a frame, the
||p|| > 0.2 range filter; examples/scan3d.rs:34-69, 104): in memory by
default, or from an HDF5 file in the reference reader's schema with
``--hdf5`` (synthesized there when absent; needs h5py).  Runs planar-motion
3D ICP odometry (3D matching, SE(2) solve; reference src/lib.rs:133-174)
through ``run_odometry_fused`` on ``--device`` and saves the xy
trajectory overlay as a PNG (when matplotlib is present).

Run:  python -m icp_rust_tpu_torch.examples.scan3d [--hdf5 FILE]
          [--frames N] [--out PNG] [--device cuda|cpu]
"""

import argparse
import os

import torch

from icp_rust_tpu_torch.cli import _pyplot
from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.models.odometry import run_odometry_fused
from icp_rust_tpu_torch.utils import io as scan_io


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hdf5", default=None)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="scan3d_trajectory.png")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.hdf5 is None:
        frames, _ = scan_io.synthesize_frames3d(args.frames, seed=0)
    else:
        if not os.path.exists(args.hdf5):
            scan_io.synthesize_scans3d(args.hdf5, n_frames=args.frames,
                                       seed=0)
        frames = scan_io.load_scans3d_hdf5(args.hdf5)[: args.frames]
    pts, mask = scan_io.pad_points(frames, pad_to=28800)
    cfg = ICPConfig(compute_dtype=torch.float32, point_scale=1.0,
                    det_rel_eps=1e-9)
    _, path = run_odometry_fused(pts, mask, cfg, device=args.device)
    print(f"{len(frames)} frames; final position {path[-1]}")

    plt = _pyplot()
    if plt is None:
        return path
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.scatter(frames[0][:, 0], frames[0][:, 1], s=0.5, c="tab:blue",
               alpha=0.4, label="frame 0 (xy)")
    ax.plot(path[:, 0], path[:, 1], "-o", c="tab:red", ms=3,
            label="trajectory")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return path


if __name__ == "__main__":
    main()
