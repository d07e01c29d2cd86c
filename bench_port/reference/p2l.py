"""The reference side of a point-to-plane cell: the reference ICP in the
program's place (``solve``) and the judge of the program's answers
(``steps``).  Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import torch

from bench_port.reference import icp


def _pairs(data: dict, pairs, dtype, device):
    pts = torch.as_tensor(data["points"]).to(device=device, dtype=dtype)
    msk = torch.as_tensor(data["mask"]).to(device)
    s, d = pairs[:, 0], pairs[:, 1]
    return pts[s], msk[s], pts[d], msk[d]


def solve(data: dict, pairs, rot0, t0, icp_cfg: dict, normals_cfg: dict,
          dtype, device):
    """Every pair aligned by the reference from (rot0, t0), computed in
    ``dtype``: (rot (P, 3, 3), t (P, 3))."""
    src, smask, dst, dmask = _pairs(data, pairs, dtype, device)
    return icp.icp_p2l(rot0.to(device, dtype), t0.to(device, dtype), src,
                       smask, dst, dmask, icp_cfg, normals_cfg["voxel_size"])


def steps(data: dict, pairs, which, rot, t, icp_cfg: dict,
          normals_cfg: dict, device, dtype=torch.float64):
    """|The reference's next update| at each answer: answer a is pair
    ``which[a]``'s (rot[a], t[a])."""
    src, smask, dst, dmask = _pairs(data, pairs, dtype, device)
    nrm = icp.voxel_normals(dst, dmask, normals_cfg["voxel_size"])
    w = which.to(device)
    return icp.first_step_p2l(rot.to(device, dtype), t.to(device, dtype),
                              src[w], smask[w], dst[w], dmask[w], icp_cfg,
                              (nrm[0][w], nrm[1][w]))
