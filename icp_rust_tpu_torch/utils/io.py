"""Scan IO: the reference's 2D scans, padding, and 3D data synthesis.

- 2D scans: whitespace "x y" text files, 000.txt..209.txt
  (reference examples/scan2d.rs:10-34).
- 3D frames: the reference reads an HDF5 file of per-packet (24, 16, 3)
  datasets, 75 packets to a frame, and drops points with ||p|| <= 0.2
  (examples/scan3d.rs:9,34-69,104).  The blob is absent from the
  reference checkout, so ``synthesize_frames3d`` makes an equivalent
  sequence with a known ground-truth trajectory, in memory: it draws the
  same random stream as writing the HDF5 file and reading it back (wall
  world, per-frame scan, shuffle, 75 packets of 384 points in order,
  range filter), so its frames are bit-identical to that round trip.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

N_POINTS_IN_PACKET = 24 * 16  # reference examples/scan3d.rs:9
PACKETS_PER_FRAME = 75  # reference examples/scan3d.rs:104
RANGE_FILTER = 0.2  # reference examples/scan3d.rs:67


def load_scan2d(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1, 2)


def load_scan2d_sequence(directory: str,
                         limit: int | None = None) -> List[np.ndarray]:
    """All frames NNN.txt of a directory, in name order."""
    names = sorted(f for f in os.listdir(directory) if f.endswith(".txt"))
    if limit is not None:
        names = names[:limit]
    return [load_scan2d(os.path.join(directory, n)) for n in names]


def pad_points(scans: Sequence[np.ndarray], pad_to: int | None = None,
               multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged scans into (F, N, D) + bool mask (F, N).  Pad value 0
    is safe: every consumer masks the point axis."""
    dim = scans[0].shape[1]
    max_n = max(len(s) for s in scans)
    if pad_to is None:
        pad_to = -(-max_n // multiple) * multiple
    if pad_to < max_n:
        raise ValueError(f"pad_to={pad_to} < longest scan {max_n}")
    pts = np.zeros((len(scans), pad_to, dim), dtype=np.float64)
    mask = np.zeros((len(scans), pad_to), dtype=bool)
    for i, s in enumerate(scans):
        pts[i, : len(s)] = s
        mask[i, : len(s)] = True
    return pts, mask


def _make_world(rng: np.random.Generator, n_walls: int = 14):
    """A synthetic indoor-ish world of vertical wall segments (anchor xy,
    direction xy, length) within the reference example's +-3 m plot range
    (examples/scan3d.rs:127)."""
    walls = []
    for _ in range(n_walls):
        a = rng.uniform(-6, 6, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(2.0, 6.0)
        walls.append((a, np.array([np.cos(ang), np.sin(ang)]), length))
    return walls


def ground_truth_trajectory(n_frames: int) -> np.ndarray:
    """Smooth planar trajectory (x, y, theta) per frame, ~5 cm and ~1 deg
    between frames."""
    i = np.arange(n_frames)
    x = 0.05 * i * np.cos(0.02 * i)
    y = 0.03 * i
    theta = 0.02 * i
    return np.column_stack([x, y, theta])


def _scan_from_pose(walls, pose: np.ndarray, n_points: int,
                    rng: np.random.Generator) -> np.ndarray:
    """A LiDAR-like frame from ``pose`` = (x, y, theta), in the sensor
    frame: fresh points on the walls with range noise, plus a few
    sub-0.2 invalid returns like the real sensor's."""
    x, y, theta = pose
    c, s = np.cos(theta), np.sin(theta)
    n_good = n_points - n_points // 40
    widx = rng.integers(0, len(walls), n_good)
    anchors = np.stack([walls[i][0] for i in widx])
    dirs = np.stack([walls[i][1] for i in widx])
    lens = np.array([walls[i][2] for i in widx])
    ts = rng.uniform(0, 1, n_good) * lens
    xy = anchors + dirs * ts[:, None]
    z = rng.uniform(0.2, 1.8, n_good)
    rel = xy - [x, y]
    local_xy = rel @ np.array([[c, s], [-s, c]]).T
    pts = np.column_stack([local_xy, z])
    pts += rng.normal(0, 0.005, pts.shape)
    n_bad = n_points - n_good
    bad = rng.uniform(-0.05, 0.05, (n_bad, 3))
    return np.concatenate([pts, bad], axis=0)


def synthesize_frames3d(n_frames: int = 8, seed: int = 0,
                        apply_range_filter: bool = True,
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The synthetic 3D sequence in memory: (frames, ground truth
    (n_frames, 3) as x, y, theta).  Each frame is 75 packets of 384
    points (28,800 before the ||p|| > 0.2 filter)."""
    rng = np.random.default_rng(seed)
    world = _make_world(rng)
    traj = ground_truth_trajectory(n_frames)
    n = N_POINTS_IN_PACKET * PACKETS_PER_FRAME
    frames = []
    for fi in range(n_frames):
        pts = _scan_from_pose(world, traj[fi], n, rng)
        rng.shuffle(pts)
        if apply_range_filter:
            pts = pts[np.linalg.norm(pts, axis=1) > RANGE_FILTER]
        frames.append(pts)
    return frames, traj
