"""Carry state from the JAX package's objects to this package's.

The system has no weights; its state is a configuration and a transform.
``config_from_fields`` builds an ``ICPConfig`` from the fields of the JAX
package's config (``dataclasses.asdict``), with the backend names mapped
("xla" -> "torch", "pallas" and "pairs" -> "cuda") and the compute
dtype taken by name; ``transform_from_numpy`` builds a
``RigidTransform2``.  Neither imports the JAX package: they take plain
values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2

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


def transform_from_numpy(rot, t, device="cpu",
                         dtype=None) -> RigidTransform2:
    """RigidTransform2 from array-likes rot (..., 2, 2) and t (..., 2)."""
    rot = np.asarray(rot)
    t = np.asarray(t)
    dt = dtype if dtype is not None else _dtype_by_name(rot.dtype)
    return RigidTransform2(
        rot=torch.as_tensor(rot).to(device=device, dtype=dt),
        t=torch.as_tensor(t).to(device=device, dtype=dt))
