"""2D odometry demo: the reference examples/scan2d.rs flow, headless.

Loads a directory of 2D scans (``NNN.txt``, "x y" in millimetres), matches
each against the first frame, warm-started from the previous estimate
(reference scan2d.rs:65-88), through ``run_odometry_fused`` on
``--device``, and saves the trajectory and the scan overlay as a PNG
(when matplotlib is present) instead of a live window.

Run:  python -m icp_rust_tpu_torch.examples.scan2d --scans DIR
          [--frames N] [--out PNG] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from icp_rust_tpu_torch.cli import _pyplot
from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.models.odometry import run_odometry_fused
from icp_rust_tpu_torch.utils import io as scan_io


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", required=True)
    ap.add_argument("--frames", type=int, default=210)
    ap.add_argument("--out", default="scan2d_trajectory.png")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    frames = scan_io.load_scan2d_sequence(args.scans, limit=args.frames)
    pts, mask = scan_io.pad_points(frames, multiple=128)
    cfg = ICPConfig(compute_dtype=torch.float32, point_scale=3000.0,
                    det_rel_eps=1e-9)
    transforms, path = run_odometry_fused(pts, mask, cfg,
                                          device=args.device)
    print(f"{len(frames)} frames; final position {path[-1]}")

    plt = _pyplot()
    if plt is None:
        return path
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.scatter(frames[0][:, 0], frames[0][:, 1], s=1, c="tab:blue",
               label="frame 0 (fixed src)")
    # The last frame back in frame 0's coordinates: R^T (p - t).
    rot = transforms.rot[-1].cpu().numpy().astype(np.float64)
    t = transforms.t[-1].cpu().numpy().astype(np.float64)
    back = (frames[-1] - t) @ rot
    ax.scatter(back[:, 0], back[:, 1], s=1, c="tab:green",
               label="last frame (aligned)")
    ax.plot(path[:, 0], path[:, 1], "-", c="tab:red", lw=1.5,
            label="trajectory")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return path


if __name__ == "__main__":
    main()
