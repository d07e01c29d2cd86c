"""Drives the port's pose-graph Gauss-Newton, ``models/pose_graph.optimize``
with the configuration's ``graph`` settings (the dense solve), on the whole
graph from its initial guess in one call, in float64.  The one module of a
cell of this entry that imports the program."""

from __future__ import annotations

import torch

from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import pose_graph
from bench_port.inputs.graph import EDGE_KEYS


def prepare(data: dict, inputs: dict, config: dict, traffic: dict,
            device) -> dict:
    g = {k: inputs[k].to(device) for k in EDGE_KEYS}
    graph = pose_graph.PoseGraph(
        poses=RigidTransform3(inputs["rot0"].to(device),
                              inputs["t0"].to(device)),
        edge_i=g["edge_i"], edge_j=g["edge_j"],
        meas=RigidTransform3(g["meas_rot"], g["meas_t"]), info=g["info"],
        edge_mask=torch.ones_like(g["edge_i"], dtype=torch.bool))
    return dict(graph=graph, settings=config["graph"])


def call(st: dict):
    """One solve of the whole graph; returns the program's PoseGraph."""
    return pose_graph.optimize(st["graph"], **st["settings"])


def answers(outs):
    """The calls' poses as (rot (C, P, 3, 3), t (C, P, 3))."""
    return (torch.stack([o.poses.rot for o in outs]),
            torch.stack([o.poses.t for o in outs]))


def build() -> None:
    """Nothing to build: the graph path launches none of the port's
    kernels."""


# The program's count of linear solves; a program without it counts
# nothing.
def reset_counts() -> None:
    if hasattr(pose_graph, "reset_solves"):
        pose_graph.reset_solves()


def counts() -> dict:
    return dict(getattr(pose_graph, "SOLVES", {}))
