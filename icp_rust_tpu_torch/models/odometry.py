"""Sequential scan odometry: the reference examples' end-to-end flow.

Parity with reference examples/scan2d.rs:56-115 and scan3d.rs:104-131:
frame 0 is the src kept fixed forever; each later frame becomes dst; the
estimate is warm-started from the previous transform; the trajectory is
the translation of T^-1 per frame.  ``run_odometry_fused`` runs the SE(2)
drivers, ``run_odometry_p2l_fused`` the SE(3) point-to-plane one.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.icp2d import ICPStats, icp2d, icp3d_planar, \
    presort_src
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane


def _run_sequence(frames, masks, config: ICPConfig, with_metrics: bool,
                  device, icp, transform_cls, **icp_kwargs):
    """The scan-to-first-scan loop shared by both runners: upload the
    frames once, hoist frame 0's loop-invariant sort, warm-start each
    ``icp`` call from the previous transform."""
    dev = resolve_device(device, config.compute_dtype)
    pts = torch.as_tensor(frames).to(device=dev, dtype=config.compute_dtype)
    msk = torch.as_tensor(masks).to(device=dev, dtype=torch.bool)
    src, src_mask, presorted = presort_src(pts[0], msk[0], pts[0], config)
    t = transform_cls.identity(dtype=config.compute_dtype, device=dev)
    rots, ts, path, stats = [], [], [], []
    for i in range(1, pts.shape[0]):
        out = icp(src, pts[i], src_mask, msk[i], t, config,
                  return_stats=with_metrics, src_presorted=presorted,
                  device=dev, **icp_kwargs)
        if with_metrics:
            t, st = out
            stats.append(st)
        else:
            t = out
        rots.append(t.rot)
        ts.append(t.t)
        path.append(t.inverse().t)
    # A one-frame sequence gives a 0-length frame axis, as the JAX
    # package's lax.scan over no frames does.
    transforms = transform_cls(_stack(rots, t.rot), _stack(ts, t.t))
    path = _stack(path, t.t).to(torch.float64).cpu().numpy()
    if with_metrics:
        if stats:
            stacked = ICPStats(*[torch.stack(list(f)) for f in zip(*stats)])
        else:
            empty = t.t.new_empty((0,))
            stacked = ICPStats(empty.to(torch.int32), empty, empty, empty)
        return transforms, path, stacked
    return transforms, path


def _stack(xs, like):
    """torch.stack of per-frame tensors shaped like ``like``; (0, ...)
    when there is none."""
    return torch.stack(xs) if xs else like.new_empty((0, *like.shape))


def run_odometry_fused(frames, masks, config: ICPConfig = ICPConfig(),
                       with_metrics: bool = False, device="cuda"):
    """Whole-sequence scan-to-first-scan odometry on ``device``.

    frames: (F, N, D) padded (D = 2 runs ``icp2d``, D = 3
    ``icp3d_planar``); masks: (F, N).  The frames are uploaded once.
    Returns (transforms, path): ``transforms`` is one RigidTransform2 with
    a leading (F-1,) frame axis, ``path`` a (F-1, 2) numpy trajectory.
    With ``with_metrics`` the per-frame ICPStats (leading frame axis) ride
    along as a third element."""
    icp = icp2d if np.shape(frames)[-1] == 2 else icp3d_planar
    return _run_sequence(frames, masks, config, with_metrics, device, icp,
                         RigidTransform2)


def run_odometry_p2l_fused(frames, masks, config: ICPConfig = ICPConfig(),
                           normals_voxel_size: float = 0.3,
                           with_metrics: bool = False, device="cuda"):
    """Whole-sequence SE(3) point-to-plane odometry on ``device``, each
    frame's voxel-PCA normals computed in its ``icp_point_to_plane`` call.

    frames: (F, N, 3) padded; masks: (F, N).  Returns (transforms, path):
    ``transforms`` is one RigidTransform3 with a leading (F-1,) frame
    axis, ``path`` the (F-1, 3) numpy trajectory of ``t.inverse().t``.
    With ``with_metrics`` the per-frame ICPStats ride along as a third
    element."""
    return _run_sequence(frames, masks, config, with_metrics, device,
                         icp_point_to_plane, RigidTransform3,
                         normals_voxel_size=normals_voxel_size)


def ate_rmse(path_a: np.ndarray, path_b: np.ndarray) -> float:
    """Absolute trajectory error (RMSE over per-frame position error)."""
    d = np.linalg.norm(path_a - path_b, axis=-1)
    return float(np.sqrt(np.mean(d * d)))
