"""The reference side of a 2D point-to-point cell: the reference ICP in
the program's place (``solve``) and the judge of the program's answers
(``steps``).  Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import torch

from bench_port.reference import icp
from bench_port.reference.p2l import _pairs


def solve(data: dict, pairs, rot0, t0, icp_cfg: dict, normals_cfg: dict,
          dtype, device):
    """Every pair aligned by the reference from (rot0, t0), computed in
    ``dtype``: (rot (P, 2, 2), t (P, 2))."""
    src, smask, dst, dmask = _pairs(data, pairs, dtype, device)
    return icp.icp_2d(rot0.to(device, dtype), t0.to(device, dtype), src,
                      smask, dst, dmask, icp_cfg)


def steps(data: dict, pairs, which, rot, t, icp_cfg: dict,
          normals_cfg: dict, device, dtype=torch.float64):
    """|The reference's next update| at each answer: answer a is pair
    ``which[a]``'s (rot[a], t[a])."""
    src, smask, dst, dmask = _pairs(data, pairs, dtype, device)
    w = which.to(device)
    return icp.first_step_2d(rot.to(device, dtype), t.to(device, dtype),
                             src[w], smask[w], dst[w], dmask[w], icp_cfg)
