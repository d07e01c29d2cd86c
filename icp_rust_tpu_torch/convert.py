"""Carry state from the JAX package's objects to this package's.

The system has no weights; its state is a configuration and a transform.
``config_from_fields`` builds an ``ICPConfig`` from the fields of the JAX
package's config (``dataclasses.asdict``), with the backend names mapped
("xla" -> "torch", "pallas" and "pairs" -> "cuda") and the compute
dtype taken by name; ``transform_from_numpy`` builds a
``RigidTransform2`` and ``transform3_from_numpy`` a ``RigidTransform3``;
``pose_graph_from_numpy`` builds a ``models.pose_graph.PoseGraph`` from
the arrays of the JAX package's ``PoseGraph``; ``voxel_hash_map_from_numpy``
builds an ``ops.voxel_hash.VoxelHashMap`` (the scan-to-submap path's state)
from the arrays of the JAX package's one; ``hash_grid_from_numpy`` builds
an ``ops.gridhash.HashGrid`` from the fields of the JAX package's.  None
imports the JAX package: they take plain values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.pose_graph import PoseGraph
from icp_rust_tpu_torch.ops.gridhash import HashGrid
from icp_rust_tpu_torch.ops.voxel_hash import VoxelHashMap

# "pairs" forced the pair-grid NN kernels for a batched query; here the
# kernel route ("cuda") takes them for every batched query they serve.
_BACKEND = {"auto": "auto", "xla": "torch", "pallas": "cuda",
            "pairs": "cuda", "torch": "torch", "cuda": "cuda"}
# "interpret" forced the whole-frame kernels (in interpret mode) for single
# and batched calls alike, which is what "pairs" does here.
_FRAME_BACKEND = {"auto": "auto", "off": "off", "interpret": "pairs",
                  "pairs": "pairs"}


def _dtype_by_name(value) -> torch.dtype:
    name = value if isinstance(value, str) else np.dtype(
        getattr(value, "dtype", value)).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute dtype {value!r}")
    return dt


def config_from_fields(fields: dict) -> ICPConfig:
    """ICPConfig from a dict of the JAX config's fields."""
    known = {f.name for f in dataclasses.fields(ICPConfig)}
    out = {}
    for key, value in fields.items():
        if key not in known:
            raise ValueError(f"unknown config field {key!r}")
        if key in ("nn_backend", "align_backend"):
            if value not in _BACKEND:
                raise ValueError(f"unknown {key} {value!r}")
            value = _BACKEND[value]
        elif key == "frame_backend":
            if value not in _FRAME_BACKEND:
                raise ValueError(f"unknown frame_backend {value!r}")
            value = _FRAME_BACKEND[value]
        elif key == "compute_dtype":
            value = _dtype_by_name(value)
        out[key] = value
    return ICPConfig(**out)


def _rt_tensors(rot, t, device, dtype):
    rot = np.asarray(rot)
    t = np.asarray(t)
    dt = dtype if dtype is not None else _dtype_by_name(rot.dtype)
    return (torch.as_tensor(rot).to(device=device, dtype=dt),
            torch.as_tensor(t).to(device=device, dtype=dt))


def transform_from_numpy(rot, t, device="cpu",
                         dtype=None) -> RigidTransform2:
    """RigidTransform2 from array-likes rot (..., 2, 2) and t (..., 2)."""
    return RigidTransform2(*_rt_tensors(rot, t, device, dtype))


def transform3_from_numpy(rot, t, device="cpu",
                          dtype=None) -> RigidTransform3:
    """RigidTransform3 from array-likes rot (..., 3, 3) and t (..., 3), e.g.
    the JAX package's ``RigidTransform3`` state as numpy arrays."""
    rot, t = _rt_tensors(rot, t, device, dtype)
    if rot.shape[-2:] != (3, 3) or t.shape[-1:] != (3,):
        raise ValueError(f"rot must be (..., 3, 3) and t (..., 3), got "
                         f"{tuple(rot.shape)}, {tuple(t.shape)}")
    return RigidTransform3(rot, t)


def pose_graph_from_numpy(poses_rot, poses_t, edge_i, edge_j, meas_rot,
                          meas_t, info, edge_mask, device="cpu",
                          dtype=None) -> PoseGraph:
    """PoseGraph from array-likes: poses (P, d, d) and (P, d), edges (E,)
    and (E,), measurements (E, d, d) and (E, d), info (E, dof, dof), mask
    (E,); d = 2 builds an SE(2) graph, d = 3 an SE(3) one.  The float
    arrays keep their dtype unless ``dtype`` is given."""
    tcls = RigidTransform2 if np.shape(poses_t)[-1] == 2 else RigidTransform3
    poses = tcls(*_rt_tensors(poses_rot, poses_t, device, dtype))
    meas = tcls(*_rt_tensors(meas_rot, meas_t, device, dtype))

    def index(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return PoseGraph(
        poses=poses, edge_i=index(edge_i), edge_j=index(edge_j), meas=meas,
        info=torch.as_tensor(np.array(info)).to(device=device,
                                                 dtype=poses.t.dtype),
        edge_mask=torch.as_tensor(np.array(edge_mask, bool), device=device))


def voxel_hash_map_from_numpy(key, psum, cnt, origin, device="cpu",
                              dtype=None) -> VoxelHashMap:
    """VoxelHashMap from array-likes: key (C,) int32 cell ids, psum (C, D)
    point sums, cnt (C,) counts, origin (D,).  The float arrays keep
    psum's dtype unless ``dtype`` is given."""
    psum = np.asarray(psum)
    dt = dtype if dtype is not None else _dtype_by_name(psum.dtype)

    def floats(x):
        return torch.as_tensor(np.array(x)).to(device=device, dtype=dt)

    return VoxelHashMap(
        key=torch.as_tensor(np.array(key, np.int32), device=device),
        psum=floats(psum), cnt=floats(cnt), origin=floats(origin))


def hash_grid_from_numpy(points, index, starts, counts, cell_size,
                         overflow_frac, table_size: int, bucket_cap: int,
                         device="cpu", dtype=None) -> HashGrid:
    """HashGrid from array-likes: points (M, D) sorted by slot, index (M,),
    starts (T + 1,) and counts (T,) int32, cell_size and overflow_frac
    scalars, and the ints table_size (T) and bucket_cap.  The float arrays
    keep points' dtype unless ``dtype`` is given."""
    points = np.asarray(points)
    dt = dtype if dtype is not None else _dtype_by_name(points.dtype)
    starts, counts = np.asarray(starts), np.asarray(counts)
    if starts.shape != (table_size + 1,) or counts.shape != (table_size,):
        raise ValueError(f"starts must be ({table_size + 1},) and counts "
                         f"({table_size},), got {starts.shape}, "
                         f"{counts.shape}")

    def ints(x):
        return torch.as_tensor(np.array(x, np.int32), device=device)

    def floats(x):
        return torch.as_tensor(np.array(x)).to(device=device, dtype=dt)

    return HashGrid(points=floats(points), index=ints(index),
                    starts=ints(starts), counts=ints(counts),
                    cell_size=floats(cell_size),
                    overflow_frac=floats(overflow_frac),
                    table_size=int(table_size), bucket_cap=int(bucket_cap))
