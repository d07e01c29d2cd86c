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
  ``synthesize_scans3d`` writes that file, ``load_scans3d_hdf5`` reads it
  and ``ensure_scans3d`` does both as needed; they import ``h5py``
  inside, so importing this module never needs it.
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


def synthesize_scans3d(path: str, n_frames: int = 8,
                       seed: int = 0) -> np.ndarray:
    """Write the synthetic sequence as an HDF5 file in the reference
    reader's schema and return the ground-truth (x, y, theta) trajectory.

    Schema (examples/scan3d.rs:34-61): one (24, 16, 3) float64 dataset per
    packet, 75 consecutive packets to a frame, named so that the file's
    alphabetical order is the packet order.  The frames are
    ``synthesize_frames3d``'s before the range filter (the same random
    stream).  Needs ``h5py``, imported here only."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames, traj = synthesize_frames3d(n_frames, seed=seed,
                                       apply_range_filter=False)
    with h5py.File(path, "w") as f:
        k = 0
        for pts in frames:
            for p in range(PACKETS_PER_FRAME):
                pkt = pts[p * N_POINTS_IN_PACKET:(p + 1) * N_POINTS_IN_PACKET]
                f.create_dataset(f"{k:06d}", data=pkt.reshape(24, 16, 3))
                k += 1
        f.attrs["ground_truth_xytheta"] = traj
    return traj


def ensure_scans3d(path: str, n_frames: int,
                   seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """Load the HDF5 sequence at ``path``, synthesizing it first when it is
    absent or holds fewer than ``n_frames`` frames (a shorter file would
    shrink the workload); returns (frames[:n_frames], traj[:n_frames]).
    A longer file's prefix is not a shorter synthesis: the random streams
    differ.  Needs ``h5py``."""
    import h5py

    def n_avail() -> int:
        with h5py.File(path, "r") as f:
            return len(f.attrs["ground_truth_xytheta"])

    if not os.path.exists(path) or n_avail() < n_frames:
        synthesize_scans3d(path, n_frames=n_frames, seed=seed)
    with h5py.File(path, "r") as f:
        traj = np.asarray(f.attrs["ground_truth_xytheta"])
    frames = load_scans3d_hdf5(path)
    return frames[:n_frames], traj[:n_frames]


def load_scans3d_hdf5(path: str,
                      apply_range_filter: bool = True) -> List[np.ndarray]:
    """Read frames as the reference example does: 75 packets of (24, 16,
    3) each -> (28,800, 3), then drop ||p|| <= 0.2
    (examples/scan3d.rs:51-69, 104-119).  Needs ``h5py``."""
    import h5py

    frames = []
    with h5py.File(path, "r") as f:
        names = sorted(f.keys())
        for start in range(0, len(names) - PACKETS_PER_FRAME + 1,
                           PACKETS_PER_FRAME):
            pts = np.concatenate(
                [np.asarray(f[names[start + i]]).reshape(-1, 3)
                 for i in range(PACKETS_PER_FRAME)], axis=0)
            if apply_range_filter:
                pts = pts[np.linalg.norm(pts, axis=1) > RANGE_FILTER]
            frames.append(pts)
    return frames
