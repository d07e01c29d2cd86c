"""Drives the port's batched 2D ICP, ``parallel/sharded.batched_icp2d``
(no mesh: one lockstep ``models/icp2d.icp2d`` call, or with the traffic's
``frame_backend="pairs"`` one pair-frame kernel launch), on every pair of
the sequence in one call, from the traffic's warm starts.  The one module
of a cell of this entry that imports the program."""

from __future__ import annotations

from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.parallel.sharded import batched_icp2d
from bench_port.entries.icp_p2l_batched import (CONTEXT, answers,  # noqa
                                                build, counts, on_device,
                                                program_config,
                                                reset_counts)


def prepare(data: dict, inputs: dict, config: dict, traffic: dict,
            device) -> dict:
    src, smask, dst, dmask, rot0, t0 = on_device(data, inputs, device)
    return dict(src=src, smask=smask, dst=dst, dmask=dmask,
                t0=RigidTransform2(rot0, t0),
                cfg=program_config(config["icp"], traffic.get("program", {})),
                device=device)


def call(st: dict):
    """One batched call; returns the program's (P,)-batched transform."""
    return batched_icp2d(st["src"], st["dst"], st["smask"], st["dmask"],
                         st["t0"], st["cfg"], device=st["device"])
