"""Sequential scan odometry: the reference examples' end-to-end flow.

Parity with reference examples/scan2d.rs:56-115 and scan3d.rs:104-131:
frame 0 is the src kept fixed forever; each later frame becomes dst; the
estimate is warm-started from the previous transform; the trajectory is
the translation of T^-1 per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.icp2d import ICPStats, icp2d, icp3d_planar, \
    presort_src


def run_odometry_fused(frames, masks, config: ICPConfig = ICPConfig(),
                       with_metrics: bool = False, device="cuda"):
    """Whole-sequence scan-to-first-scan odometry on ``device``.

    frames: (F, N, D) padded (D = 2 runs ``icp2d``, D = 3
    ``icp3d_planar``); masks: (F, N).  The frames are uploaded once.
    Returns (transforms, path): ``transforms`` is one RigidTransform2 with
    a leading (F-1,) frame axis, ``path`` a (F-1, 2) numpy trajectory.
    With ``with_metrics`` the per-frame ICPStats (leading frame axis) ride
    along as a third element."""
    dev = resolve_device(device, config.compute_dtype)
    pts = torch.as_tensor(frames).to(device=dev, dtype=config.compute_dtype)
    msk = torch.as_tensor(masks).to(device=dev, dtype=torch.bool)
    icp = icp2d if pts.shape[-1] == 2 else icp3d_planar
    # Frame 0 is the fixed src: its sort is loop-invariant.
    src, src_mask, presorted = presort_src(pts[0], msk[0], pts[0], config)
    t = RigidTransform2.identity(dtype=config.compute_dtype, device=dev)
    rots, ts, path, stats = [], [], [], []
    for i in range(1, pts.shape[0]):
        out = icp(src, pts[i], src_mask, msk[i], t, config,
                  return_stats=with_metrics, src_presorted=presorted,
                  device=dev)
        if with_metrics:
            t, st = out
            stats.append(st)
        else:
            t = out
        rots.append(t.rot)
        ts.append(t.t)
        path.append(t.inverse().t)
    transforms = RigidTransform2(torch.stack(rots), torch.stack(ts))
    path = torch.stack(path).to(torch.float64).cpu().numpy()
    if with_metrics:
        stacked = ICPStats(*[torch.stack(list(f)) for f in zip(*stats)])
        return transforms, path, stacked
    return transforms, path


def ate_rmse(path_a: np.ndarray, path_b: np.ndarray) -> float:
    """Absolute trajectory error (RMSE over per-frame position error)."""
    d = np.linalg.norm(path_a - path_b, axis=-1)
    return float(np.sqrt(np.mean(d * d)))
