"""The generator of pose-graph traffic: the configuration's graph as one
call solves it, from the graph's initial guess.  With ``shuffle_edges`` the
run's seed orders the edges (the order of the assembly's atomic adds,
never the amount of work).  A call's work is the graph's edges."""

from __future__ import annotations

import numpy as np
import torch

EDGE_KEYS = ("edge_i", "edge_j", "meas_rot", "meas_t", "info")


def make(data: dict, traffic: dict, seed: int) -> dict:
    """The run's graph: its edges in the run's order (``EDGE_KEYS``,
    tensors), the initial guess ``rot0``, ``t0`` and the true poses
    ``gt_rot``, ``gt_t`` (float64), ``work`` (edges a call) and an empty
    ``context``: no metric reader takes more of the graph."""
    e = len(data["edge_i"])
    order = (np.random.default_rng(seed % (1 << 64)).permutation(e)
             if traffic.get("shuffle_edges") else np.arange(e))
    out = {k: torch.as_tensor(data[k][order]) for k in EDGE_KEYS}
    out.update(rot0=torch.as_tensor(data["guess_rot"]),
               t0=torch.as_tensor(data["guess_t"]),
               gt_rot=torch.as_tensor(data["gt_rot"]),
               gt_t=torch.as_tensor(data["gt_t"]), work=e, context={})
    return out
