"""Synthetic VLP-16 frames: a frozen copy of the port's
``utils/io.synthesize_frames3d`` and its ground-truth trajectory.

The reference crate reads one Velodyne VLP-16 rotation as 75 packets of
24 x 16 points and drops returns with ||p|| <= 0.2 m
(tier4/icp_rust examples/scan3d.rs:9,67,104).  Its HDF5 blob is not
public, so the frames are made here: a world of vertical wall segments,
a smooth planar trajectory, fresh points on the walls in each frame with
5 mm noise, a few sub-0.2 m returns that the range filter drops, shuffled.

With ``world_seed=None`` one random stream makes the world and then the
frames, and the result is bitwise ``synthesize_frames3d(n, seed)``.  With a
``world_seed`` the world comes from its own stream, so every run seed scans
the same world along the same path and only the samples and the noise
change.  Vectorised over points: the same draws in the same order as the
original, without its per-point Python lists.
"""

from __future__ import annotations

import numpy as np

N_POINTS_IN_PACKET = 24 * 16
PACKETS_PER_FRAME = 75
RANGE_FILTER = 0.2


def make_world(rng: np.random.Generator, n_walls: int = 14):
    """Wall segments as arrays: anchors (W, 2), unit directions (W, 2),
    lengths (W,), drawn as the original draws them."""
    anchors, dirs, lens = [], [], []
    for _ in range(n_walls):
        anchors.append(rng.uniform(-6, 6, 2))
        ang = rng.uniform(0, np.pi)
        lens.append(rng.uniform(2.0, 6.0))
        dirs.append(np.array([np.cos(ang), np.sin(ang)]))
    return np.stack(anchors), np.stack(dirs), np.array(lens)


def ground_truth_trajectory(n_frames: int) -> np.ndarray:
    """(x, y, theta) per frame: ~5 cm and ~1 degree between frames."""
    i = np.arange(n_frames)
    return np.column_stack([0.05 * i * np.cos(0.02 * i), 0.03 * i, 0.02 * i])


def scan_from_pose(world, pose, n_points: int,
                   rng: np.random.Generator) -> np.ndarray:
    """One frame seen from ``pose`` = (x, y, theta), in the sensor frame."""
    anchors, dirs, lens = world
    x, y, theta = pose
    c, s = np.cos(theta), np.sin(theta)
    n_good = n_points - n_points // 40
    widx = rng.integers(0, len(lens), n_good)
    ts = rng.uniform(0, 1, n_good) * lens[widx]
    xy = anchors[widx] + dirs[widx] * ts[:, None]
    z = rng.uniform(0.2, 1.8, n_good)
    local_xy = (xy - [x, y]) @ np.array([[c, s], [-s, c]]).T
    pts = np.column_stack([local_xy, z])
    pts += rng.normal(0, 0.005, pts.shape)
    bad = rng.uniform(-0.05, 0.05, (n_points - n_good, 3))
    return np.concatenate([pts, bad], axis=0)


def synthesize(n_frames: int, seed: int, world_seed: int | None = None):
    """(frames: list of (n_i, 3) float64 after the range filter, ground
    truth (n_frames, 3) as x, y, theta)."""
    rng = np.random.default_rng(seed)
    world = make_world(rng if world_seed is None
                       else np.random.default_rng(world_seed))
    traj = ground_truth_trajectory(n_frames)
    n = N_POINTS_IN_PACKET * PACKETS_PER_FRAME
    frames = []
    for fi in range(n_frames):
        pts = scan_from_pose(world, traj[fi], n, rng)
        pts = pts[rng.permutation(n)]  # the draws of rng.shuffle(pts)
        frames.append(pts[np.linalg.norm(pts, axis=1) > RANGE_FILTER])
    return frames, traj


def pad(frames, pad_to: int):
    """Stack ragged clouds into (F, pad_to, D) float64 and a bool mask."""
    dim = frames[0].shape[1]
    pts = np.zeros((len(frames), pad_to, dim))
    mask = np.zeros((len(frames), pad_to), dtype=bool)
    for i, f in enumerate(frames):
        if len(f) > pad_to:
            raise ValueError(f"a cloud of {len(f)} points exceeds {pad_to}")
        pts[i, :len(f)] = f
        mask[i, :len(f)] = True
    return pts, mask


def make(spec: dict, seed: int) -> dict:
    """The configuration's sequence: points (F, N, 3) float32, mask (F,
    N), and each frame's true pose in the world (pose_rot (F, 3, 3),
    pose_t (F, 3), float64; planar motion)."""
    frames, traj = synthesize(spec["frames"], seed, spec.get("world_seed"))
    step = spec.get("point_stride", 1)
    pts, mask = pad([f[::step] for f in frames], spec["pad_to"])
    c, s = np.cos(traj[:, 2]), np.sin(traj[:, 2])
    rot = np.zeros((len(traj), 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = c, -s
    rot[:, 1, 0], rot[:, 1, 1] = s, c
    rot[:, 2, 2] = 1.0
    t = np.zeros((len(traj), 3))
    t[:, :2] = traj[:, :2]
    return dict(points=pts.astype(np.float32), mask=mask, pose_rot=rot,
                pose_t=t)
