"""Sequential scan odometry: the reference examples' end-to-end flow.

Parity with reference examples/scan2d.rs:56-115 and scan3d.rs:104-131:
frame 0 is the src kept fixed forever; each later frame becomes dst; the
estimate is warm-started from the previous transform; the trajectory is
the translation of T^-1 per frame.  ``run_odometry_fused`` runs the SE(2)
drivers, ``run_odometry_p2l_fused`` the SE(3) point-to-plane one, each
returning the sequence's transforms with a frame axis.  The per-frame
runners ``run_odometry`` (a list of ragged scans), ``run_odometry_device``
and ``run_odometry_p2l`` run the same loop and return a list of
transforms; the last two add JSONL metrics rows, every-K checkpoints and
a bitwise resume.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_rust_tpu_torch.config import ICPConfig, resolve_device
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models.driver import ICPStats, presort_src
from icp_rust_tpu_torch.models.icp2d import se2_driver
from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
from icp_rust_tpu_torch.utils import io as scan_io


def _run_sequence(frames, masks, config: ICPConfig, with_stats: bool,
                  device, icp, transform_cls, metrics=None, checkpoint=None,
                  resume: bool = False, **icp_kwargs):
    """The scan-to-first-scan loop shared by every runner: upload the
    frames once, hoist frame 0's loop-invariant sort, warm-start each
    ``icp`` call from the previous transform.

    Returns (transforms, path, stats): per-frame lists of the transforms
    and ICPStats this call computed, and the (F-1, D) float64 numpy
    trajectory, whose rows before a resume's cursor are the checkpoint's
    (kept in the compute dtype on the device until then).  ``metrics`` (a
    ``utils.metrics.MetricsLogger``) gets one row per frame, which turns
    ``with_stats`` on; ``checkpoint`` (a
    ``utils.checkpoint.SequenceCheckpointer``) saves the cursor, the
    transform and the path so far every K frames; ``resume`` starts after
    its cursor from its transform, in the compute dtype on the device."""
    dev = resolve_device(device, config.compute_dtype)
    dt = config.compute_dtype
    pts = torch.as_tensor(frames).to(device=dev, dtype=dt)
    msk = torch.as_tensor(masks).to(device=dev, dtype=torch.bool)
    src, src_mask, presorted = presort_src(pts[0], msk[0], pts[0], config)
    t = transform_cls.identity(dtype=dt, device=dev)
    start, path = 1, []
    if resume and checkpoint is not None:
        state = checkpoint.restore()
        if state is not None:
            start = int(state["frame_cursor"]) + 1
            t = transform_cls(torch.as_tensor(state["t_rot"]).to(dev, dt),
                              torch.as_tensor(state["t_t"]).to(dev, dt))
            path = [torch.as_tensor(row).to(dev, dt) for row in state["path"]]
    with_stats = with_stats or metrics is not None
    transforms, stats = [], []
    for i in range(start, pts.shape[0]):
        if metrics is not None:
            metrics.start_frame()
        out = icp(src, pts[i], src_mask, msk[i], t, config,
                  return_stats=with_stats, src_presorted=presorted,
                  device=dev, **icp_kwargs)
        if with_stats:
            t, st = out
            stats.append(st)
        else:
            t = out
        transforms.append(t)
        path.append(t.inverse().t)
        if metrics is not None:
            metrics.end_frame(
                i, huber_error=float(st.huber_error),
                mean_nn_dist=float(st.mean_nn_dist),
                inlier_fraction=float(st.inlier_fraction),
                extra={"outer_iters": int(st.outer_iters)})
        if checkpoint is not None:
            checkpoint.maybe_save(i, {"t_rot": t.rot, "t_t": t.t,
                                      "path": torch.stack(path)})
    return transforms, _stack(path, t.t).to(torch.float64).cpu().numpy(), \
        stats


def _fused(frames, masks, config: ICPConfig, with_metrics: bool, device,
           icp, transform_cls, **icp_kwargs):
    """The fused runners' return: one transform with a leading (F-1,)
    frame axis, the float64 numpy path and, with ``with_metrics``, the
    stacked ICPStats."""
    transforms, path, stats = _run_sequence(
        frames, masks, config, with_metrics, device, icp, transform_cls,
        **icp_kwargs)
    like = transform_cls.identity(
        dtype=config.compute_dtype,
        device=resolve_device(device, config.compute_dtype))
    # A one-frame sequence gives a 0-length frame axis, as the JAX
    # package's lax.scan over no frames does.
    stacked = transform_cls(_stack([t.rot for t in transforms], like.rot),
                            _stack([t.t for t in transforms], like.t))
    if not with_metrics:
        return stacked, path
    if stats:
        st = ICPStats(*[torch.stack(list(f)) for f in zip(*stats)])
    else:
        empty = like.t.new_empty((0,))
        st = ICPStats(empty.to(torch.int32), empty, empty, empty)
    return stacked, path, st


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
    return _fused(frames, masks, config, with_metrics, device,
                  se2_driver(np.shape(frames)[-1]), RigidTransform2)


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
    return _fused(frames, masks, config, with_metrics, device,
                  icp_point_to_plane, RigidTransform3,
                  normals_voxel_size=normals_voxel_size)


def run_odometry(frames, config: ICPConfig = ICPConfig(),
                 pad_multiple: int | None = None, device="cuda"):
    """Scan-to-first-scan odometry over a list of ragged (N_i, 2) or
    (N_i, 3) scans, padded to a multiple of ``pad_multiple or
    config.pad_multiple``.  Returns (transforms, path): a per-frame list
    of RigidTransform2 and the (F-1, 2) float64 numpy trajectory."""
    pts, mask = scan_io.pad_points(
        frames, multiple=pad_multiple or config.pad_multiple)
    transforms, path, _ = _run_sequence(
        pts, mask, config, False, device, se2_driver(pts.shape[-1]),
        RigidTransform2)
    return transforms, path


def run_odometry_device(frames, masks, config: ICPConfig = ICPConfig(),
                        metrics=None, checkpoint=None, resume: bool = False,
                        device="cuda"):
    """Per-frame scan-to-first-scan odometry on ``device``, with the
    observability surface of the JAX package's runner of the same name.

    frames: (F, N, D) padded; masks: (F, N).  The frames are uploaded
    once.  Returns (transforms, path): a list of RigidTransform2, one per
    frame computed by this call, and the (F-1, 2) float64 numpy trajectory
    (after a resume its first rows come from the checkpoint, so the list
    is shorter than the path).

    ``metrics``: a ``utils.metrics.MetricsLogger``; each frame adds a
    JSONL row of its wall time and its ICPStats (outer iterations, final
    Huber error, mean NN distance, inlier fraction), read back with one
    host sync per frame.  With it the ICP calls return stats, which keeps
    a scan of at most ``config.frame_kernel_max`` 2D points off the
    whole-frame kernel, as in the JAX package.  ``checkpoint``: a
    ``utils.checkpoint.SequenceCheckpointer``; every K frames the cursor,
    the transform and the path so far are saved atomically.
    ``resume=True`` starts after the checkpoint's cursor and reproduces
    the rest of the trajectory bitwise (the engine is deterministic given
    its (src, transform) state)."""
    transforms, path, _ = _run_sequence(
        frames, masks, config, False, device,
        se2_driver(np.shape(frames)[-1]), RigidTransform2, metrics=metrics,
        checkpoint=checkpoint, resume=resume)
    return transforms, path


def run_odometry_p2l(frames, masks, config: ICPConfig = ICPConfig(),
                     normals_voxel_size: float = 0.3, metrics=None,
                     checkpoint=None, resume: bool = False, device="cuda"):
    """Per-frame SE(3) point-to-plane odometry on ``device``: the 6-DoF
    counterpart of :func:`run_odometry_device`, with the same metrics rows,
    every-K checkpoints and bitwise resume.

    frames: (F, N, 3) padded; masks: (F, N).  Returns (transforms, path):
    a list of RigidTransform3 and the (F-1, 3) float64 numpy trajectory."""
    transforms, path, _ = _run_sequence(
        frames, masks, config, False, device, icp_point_to_plane,
        RigidTransform3, metrics=metrics, checkpoint=checkpoint,
        resume=resume, normals_voxel_size=normals_voxel_size)
    return transforms, path


def ate_rmse(path_a: np.ndarray, path_b: np.ndarray) -> float:
    """Absolute trajectory error (RMSE over per-frame position error)."""
    d = np.linalg.norm(path_a - path_b, axis=-1)
    return float(np.sqrt(np.mean(d * d)))
