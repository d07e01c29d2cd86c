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
- SE(3) pose graphs: ``load_g2o`` reads g2o's text format
  (``VERTEX_SE3:QUAT`` and ``EDGE_SE3:QUAT`` lines, as sphere2500.g2o
  holds them) into a ``models.pose_graph.PoseGraph``, ``save_g2o`` writes
  one.  g2o's edge error is (t, the quaternion's vector part), which is
  (v, w / 2) of the port's twist residual to first order, so the
  information's rotation rows and columns are halved on reading and
  doubled on writing (exact in binary).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

G2O_VERTEX = "VERTEX_SE3:QUAT"
G2O_EDGE = "EDGE_SE3:QUAT"
# g2o's error (t, q_vec) to the port's twist (v, w): w = 2 q_vec.
_G2O_TO_TWIST = np.array([1.0, 1.0, 1.0, 0.5, 0.5, 0.5])
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


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Unit quaternions (K, 4) as (x, y, z, w) -> rotations (K, 3, 3)."""
    x, y, z, w = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotations (K, 3, 3) -> unit quaternions (K, 4) as (x, y, z, w),
    w >= 0, each from its largest component (Shepperd)."""
    tr = np.trace(r, axis1=-2, axis2=-1)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    lead = np.argmax(np.column_stack([d, tr]), -1)
    q = np.empty((len(r), 4))
    for k, m in enumerate(r):
        if lead[k] == 3:
            s = 2 * np.sqrt(1 + tr[k])
            q[k] = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                    (m[1, 0] - m[0, 1]) / s, s / 4]
            continue
        i = lead[k]
        j, l = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(1 + m[i, i] - m[j, j] - m[l, l])
        q[k, i], q[k, 3] = s / 4, (m[l, j] - m[j, l]) / s
        q[k, j], q[k, l] = (m[j, i] + m[i, j]) / s, (m[l, i] + m[i, l]) / s
    return q * np.where(q[:, 3:] < 0, -1, 1)


def load_g2o(path: str, dtype=None, device="cpu"):
    """An SE(3) ``PoseGraph`` from a g2o file: its ``VERTEX_SE3:QUAT``
    poses in id order, each ``EDGE_SE3:QUAT`` (i, j, z_ij, information from
    its upper triangle, row by row) in file order, every edge on; other
    lines are skipped.  Float64 unless ``dtype`` is given."""
    from icp_rust_tpu_torch.convert import pose_graph_from_numpy

    verts, edges = {}, []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] == G2O_VERTEX:
                verts[int(tok[1])] = np.array(tok[2:9], np.float64)
            elif tok and tok[0] == G2O_EDGE:
                edges.append((int(tok[1]), int(tok[2]),
                              np.array(tok[3:31], np.float64)))
    ids = sorted(verts)
    index = {v: k for k, v in enumerate(ids)}
    pose = np.stack([verts[v] for v in ids])
    ev = np.stack([e[2] for e in edges])
    upper = np.zeros((len(edges), 6, 6))
    iu, ju = np.triu_indices(6)
    upper[:, iu, ju] = ev[:, 7:]
    info = upper + np.triu(upper, 1).transpose(0, 2, 1)
    info *= _G2O_TO_TWIST[:, None] * _G2O_TO_TWIST[None, :]
    return pose_graph_from_numpy(
        _quat_to_rot(pose[:, 3:]), pose[:, :3],
        [index[e[0]] for e in edges], [index[e[1]] for e in edges],
        _quat_to_rot(ev[:, 3:7]), ev[:, :3], info,
        np.ones(len(edges), bool), device=device, dtype=dtype)


def save_g2o(path: str, graph) -> None:
    """Write an SE(3) ``PoseGraph``'s poses (ids 0..P-1) and its edges that
    are on as g2o text, the inverse of ``load_g2o``."""
    def rows(rot, t):
        rot, t = (np.asarray(x.detach().cpu(), np.float64) for x in (rot, t))
        return np.concatenate([t, _rot_to_quat(rot)], -1)

    on = graph.edge_mask.cpu().numpy()
    info = graph.info.detach().cpu().numpy()[on].astype(np.float64)
    info = info / (_G2O_TO_TWIST[:, None] * _G2O_TO_TWIST[None, :])
    iu, ju = np.triu_indices(6)
    upper = info[:, iu, ju]
    meas = rows(graph.meas.rot, graph.meas.t)[on]
    ei, ej = (x.cpu().numpy()[on] for x in (graph.edge_i, graph.edge_j))
    with open(path, "w") as f:
        for k, p in enumerate(rows(graph.poses.rot, graph.poses.t)):
            f.write(" ".join([G2O_VERTEX, str(k)] + [repr(float(x))
                                                      for x in p]) + "\n")
        for i, j, z, u in zip(ei, ej, meas, upper):
            f.write(" ".join([G2O_EDGE, str(i), str(j)]
                             + [repr(float(x)) for x in (*z, *u)]) + "\n")
