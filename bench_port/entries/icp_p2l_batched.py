"""Drives the port's batched point-to-plane ICP,
``models/icp_p2l.icp_point_to_plane``, on every pair of the sequence in
one call: src (P, N, 3) against dst (P, N, 3), from the traffic's warm
starts, voxel normals per pair.  The one module of a cell of this entry
that imports the program."""

from __future__ import annotations

import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
from icp_rust_tpu_torch.ops import cuda_build

# The port's nearest-neighbour kernels (ops/cuda_build.SOURCES), for the
# metric readers.
CONTEXT = {"nn_kernels": ("nn_list", "nn_pairs", "nn_pairs_list",
                          "nn_sweep", "nn_matched", "nn_pruned")}


def program_config(icp: dict, overrides: dict) -> ICPConfig:
    """The configuration's ICP settings as the port takes them."""
    kw = {k: v for k, v in icp.items() if k in ICPConfig.__dataclass_fields__}
    kw.update(overrides)
    kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    return ICPConfig(**kw)


def on_device(data: dict, inputs: dict, device):
    """The pairs' clouds and warm starts on the device, once: (src, smask,
    dst, dmask, rot0, t0), gathered from one (F, N, D) tensor of the
    sequence's frames."""
    pts = torch.as_tensor(data["points"]).to(device)
    mask = torch.as_tensor(data["mask"]).to(device)
    pairs = inputs["pairs"].to(device)
    s, d = pairs[:, 0], pairs[:, 1]
    return (pts[s], mask[s], pts[d], mask[d],
            inputs["rot0"].float().to(device),
            inputs["t0"].float().to(device))


def prepare(data: dict, inputs: dict, config: dict, traffic: dict,
            device) -> dict:
    src, smask, dst, dmask, rot0, t0 = on_device(data, inputs, device)
    return dict(src=src, smask=smask, dst=dst, dmask=dmask,
                t0=RigidTransform3(rot0, t0),
                cfg=program_config(config["icp"], traffic.get("program", {})),
                voxel=config["normals"]["voxel_size"], device=device)


def call(st: dict):
    """One batched call; returns the program's (P,)-batched transform."""
    return icp_point_to_plane(st["src"], st["dst"], st["smask"], st["dmask"],
                              st["t0"], st["cfg"],
                              normals_voxel_size=st["voxel"],
                              device=st["device"])


def answers(outs):
    """The calls' transforms as (rot (C, P, 3, 3), t (C, P, 3))."""
    return (torch.stack([o.rot for o in outs]),
            torch.stack([o.t for o in outs]))


def build() -> None:
    """Compile whatever kernel is not built yet (all sources at once, one
    nvcc each, into the port's build directory inside the checkout)."""
    cuda_build.build()


def reset_counts() -> None:
    cuda_build.reset_launches()


def counts() -> dict:
    return dict(cuda_build.LAUNCHES)
