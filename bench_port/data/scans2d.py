"""Synthetic planar scans the size of the reference crate's 2D sequence
(tier4/icp_rust examples/scan2d.rs, scans/2d: 210 scans of 411-670
points).  The scans are not public, so each is ray-cast here, as a planar
scanner takes it: ``rays`` beams at a fixed angular step over ``fov_deg``,
each returning its first hit (walls occlude what lies behind them), beams
with no hit within ``max_range`` returning nothing, and each range with
``noise`` m of Gaussian noise.

The world is the wall segments of ``frames3d`` (``world_seed``) less those
that the trajectory crosses, inside a room: the rectangle around the kept
walls and the path, ``room_margin`` m out.  The path is ``frames3d``'s.
A scan's points are in the sensor frame, in beam order.

The geometry alone sets which beams return, so every seed gives every scan
the same number of points; the seed draws the noise.  Each count has to
lie within [min_points, max_points], the source's range: a scan outside
it raises.
"""

from __future__ import annotations

import numpy as np

from bench_port.data.frames3d import (ground_truth_trajectory, make_world,
                                      pad)


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _segments(anchors, ends):
    d = ends - anchors
    lens = np.linalg.norm(d, axis=-1)
    return anchors, d / lens[:, None], lens


def path_crosses(world, path: np.ndarray) -> np.ndarray:
    """(W,) True where a wall segment meets the polyline ``path`` (K, 2)."""
    anchors, dirs, lens = world
    p, q = path[:-1, None], path[1:, None]
    a, b = anchors[None], (anchors + dirs * lens[:, None])[None]
    s1 = _cross(q - p, a - p) * _cross(q - p, b - p)
    s2 = _cross(b - a, p - a) * _cross(b - a, q - a)
    return ((s1 <= 0) & (s2 <= 0)).any(0)


def make_room(spec: dict, path: np.ndarray):
    """The scans' world: the kept walls and the room around them."""
    world = make_world(np.random.default_rng(spec["world_seed"]))
    keep = ~path_crosses(world, path)
    anchors, dirs, lens = (w[keep] for w in world)
    pts = np.concatenate([anchors, anchors + dirs * lens[:, None], path])
    lo = pts.min(0) - spec["room_margin"]
    hi = pts.max(0) + spec["room_margin"]
    corners = np.array([[lo[0], lo[1]], [hi[0], lo[1]], [hi[0], hi[1]],
                        [lo[0], hi[1]]])
    ra, rd, rl = _segments(corners, np.roll(corners, -1, 0))
    return (np.concatenate([anchors, ra]), np.concatenate([dirs, rd]),
            np.concatenate([lens, rl]))


def beams(spec: dict) -> np.ndarray:
    """The beams' angles in the sensor frame, at a fixed step."""
    fov = np.deg2rad(spec["fov_deg"])
    k = np.arange(spec["rays"])
    return -fov / 2 + fov * (k + 0.5) / spec["rays"]


def ranges(world, pose, phi: np.ndarray) -> np.ndarray:
    """Each beam's range to its first wall from ``pose`` = (x, y, theta),
    inf where it meets none."""
    anchors, dirs, lens = world
    x, y, theta = pose
    d = np.stack([np.cos(phi + theta), np.sin(phi + theta)], -1)[:, None]
    ap = (anchors - [x, y])[None]
    den = _cross(d, dirs[None])
    with np.errstate(divide="ignore", invalid="ignore"):
        s = _cross(ap, dirs[None]) / den
        u = _cross(ap, d) / den
    hit = (den != 0) & (s > 0) & (u >= 0) & (u <= lens[None])
    return np.where(hit, s, np.inf).min(1)


def synthesize(spec: dict, seed: int):
    """(scans: list of (n_i, 2) float64 in the sensor frame, ground truth
    (scans, 3) as x, y, theta)."""
    rng = np.random.default_rng(seed)
    traj = ground_truth_trajectory(spec["scans"])
    world = make_room(spec, traj[:, :2])
    phi = beams(spec)
    unit = np.stack([np.cos(phi), np.sin(phi)], -1)
    scans = []
    for i, pose in enumerate(traj):
        r = ranges(world, pose, phi)
        seen = r <= spec["max_range"]
        n = int(seen.sum())
        if not spec["min_points"] <= n <= spec["max_points"]:
            raise ValueError(f"scan {i} has {n} returns, outside "
                             f"[{spec['min_points']}, {spec['max_points']}]")
        rr = r[seen] + rng.normal(0, spec["noise"], n)
        scans.append(unit[seen] * rr[:, None])
    return scans, traj


def poses(traj: np.ndarray):
    """Each scan's pose in the world as (rot (S, D, D), t (S, D))."""
    c, s = np.cos(traj[:, 2]), np.sin(traj[:, 2])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return rot, traj[:, :2].copy()


def make(spec: dict, seed: int) -> dict:
    """points (S, pad_to, 2) float32, mask (S, pad_to), and each scan's
    true pose in the world (pose_rot (S, 2, 2), pose_t (S, 2), float64)."""
    scans, traj = synthesize(spec, seed)
    pts, mask = pad(scans, spec["pad_to"])
    rot, t = poses(traj)
    return dict(points=pts.astype(np.float32), mask=mask, pose_rot=rot,
                pose_t=t)
