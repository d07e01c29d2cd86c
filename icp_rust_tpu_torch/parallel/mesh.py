"""Process-group init and the device mesh (JAX package
``parallel/mesh.py``).

``initialize_distributed`` starts the default ``torch.distributed``
process group; ``make_mesh`` lays the ranks on a named ("dp", "sp") grid
with ``init_device_mesh``, row-major as ``jax.sharding.Mesh`` lays the
devices: rank r sits at (r // sp, r % sp).  ``axis`` gives the sharded
drivers one named axis of a mesh: its group, this rank's place on it and
its size.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from icp_rust_tpu_torch.config import resolve_device


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``.

    Only the benign case, a default process group that is already
    initialized, is passed over; every other failure (a bad rendezvous, a
    timeout, mismatched world sizes) raises, so a misconfigured world
    never degrades to one process.  Logs the rank, the world size and the
    device."""
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)
    device = (f"cuda:{torch.cuda.current_device()}"
              if torch.cuda.is_available() else "cpu")
    logging.getLogger(__name__).info(
        "torch.distributed: rank %d/%d (%s backend), device %s",
        dist.get_rank(), dist.get_world_size(), dist.get_backend(), device)


def require_device(device_type: str) -> None:
    """Raise unless ``device_type`` is "cpu", or "cuda" with a card."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to run on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device_type {device_type!r}")


def make_mesh(axis_names: Sequence[str] = ("dp", "sp"),
              axis_sizes: Sequence[int] | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the initialized process group.

    By default the pair axis (the first) takes all ranks and the others
    are 1; the sizes must multiply to the world size (ValueError).
    ``device_type`` "cuda" needs a card (RuntimeError without one); pass
    "cpu" to run on the CPU."""
    require_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "initialize_distributed first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} != world size {n}")
    return init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh: DeviceMesh, dtype=None) -> torch.device:
    """The device this rank computes on: the mesh's device type, on the
    current card for "cuda".  With the ICP drivers' ``dtype``,
    ``resolve_device``'s rules hold (the card runs float32 only); the
    pose graphs run in float64 on either."""
    if mesh.device_type != "cuda":
        return resolve_device(mesh.device_type, dtype)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; build the mesh "
                           "with device_type='cpu' to run on the CPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    return dev if dtype is None else resolve_device(dev, dtype)


class Axis(NamedTuple):
    group: dist.ProcessGroup
    rank: int   # this rank's place along the axis
    size: int


def axis(mesh: DeviceMesh, name: str) -> Axis:
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} lack {name!r}")
    dim = mesh.mesh_dim_names.index(name)
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(dim))


def block(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``: rows
    [r n / size, (r + 1) n / size).  n must divide by the axis size, as
    the JAX package's shardings require."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"axis of length {n} does not divide over "
                         f"{ax.size} ranks")
    k = n // ax.size
    return x.narrow(dim, ax.rank * k, k)
