"""The robust SE(2) solver kernels: ``csrc/irls_loop.cu`` (the whole inner
IRLS loop in one launch) and ``csrc/icp2d_frame.cu`` (a whole 2D ICP
call in one launch), their wrappers and their plain PyTorch versions.

Counterparts of icp_rust_tpu/ops/align2d_pallas.py's
``_inner_loop_kernel`` and ``_icp2d_frame_kernel``.  Both kernels run the
device routine of ``csrc/irls.cuh``, so they share one op sequence.

Plain versions: the inner loop's is ``align2d.irls_loop_torch`` (the
``align_backend="torch"`` loop); the frame's is the unfused ``icp2d``
outer loop with ``frame_backend="off"`` and torch backends.  A wrapper
takes the plain version only for a CPU tensor; a CUDA tensor reaches the
kernel or raises.  The kernels take float32 only: the float64 reference
path is a CPU path.

Tolerance against the plain versions: float32 roundoff of the sums, which
are taken in another order (block tree vs torch reductions); the medians
are exact order statistics of residuals that may differ in their last bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import align2d, cuda_build
from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL
_SMALL_ANGLE_F32 = float(torch.finfo(torch.float32).eps) ** 0.25
FRAME_MAX_POINTS = 1536


def _solver_params(huber_k: float, det_rel_eps: float, tol_d2: float,
                   max_iter: int, point_scale: float) -> list:
    """The kernels' IrlsParams in order; ctypes rounds each float to f32
    once, as the JAX kernel's f32 constants are (k * k and 2 * k are taken
    in double first)."""
    return [huber_k, huber_k * huber_k, 2.0 * huber_k, det_rel_eps, tol_d2,
            int(max_iter), point_scale, _SMALL_ANGLE_F32]


def _check_cuda_f32(name: str, *tensors: Tensor) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(
                f"{name}: the kernel takes float32, got {x.dtype} (the "
                "float64 reference path runs on the CPU)")


def irls_loop_plain(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
                    det_rel_eps: float, tol_d2: float, max_iter: int,
                    point_scale: float):
    """Plain PyTorch version of the irls_loop kernel."""
    return align2d.irls_loop_torch(src, dst, mask, huber_k, det_rel_eps,
                                   tol_d2, max_iter, point_scale)


def irls_loop(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
              det_rel_eps: float, tol_d2: float, max_iter: int,
              point_scale: float):
    """The fixed-correspondence IRLS loop from identity.  src/dst (N, 2)
    in solver units, mask (N,), huber_k in solver units.  Returns
    (rot (2, 2), t (2,), iterations): an int from the plain version, a
    0-d float tensor from the kernel."""
    if src.device.type == "cpu":
        return irls_loop_plain(src, dst, mask, huber_k, det_rel_eps,
                               tol_d2, max_iter, point_scale)
    if src.device.type != "cuda":
        raise ValueError(f"irls_loop: unsupported device {src.device}")
    _check_cuda_f32("irls_loop", src, dst)
    n = src.shape[0]
    if src.shape != (n, 2) or dst.shape != (n, 2) or mask.shape != (n,):
        raise ValueError("irls_loop: src/dst must be (N, 2), mask (N,)")
    cols = [src[:, 0].contiguous(), src[:, 1].contiguous(),
            dst[:, 0].contiguous(), dst[:, 1].contiguous(),
            mask.to(device=src.device, dtype=torch.float32).contiguous()]
    scratch = torch.empty(2 * n, dtype=torch.float32, device=src.device)
    out = torch.empty(8, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = cuda_build.launcher("irls_loop")(*[c.data_ptr() for c in cols], n, scratch.data_ptr(),
                out.data_ptr(),
                *_solver_params(huber_k, det_rel_eps, tol_d2, max_iter,
                                point_scale), stream)
    cuda_build.LAUNCHES["irls_loop"] += 1
    cuda_build.check(status, "irls_loop")
    return out[:4].reshape(2, 2), out[4:6], out[6]


def icp2d_frame_plain(src: Tensor, dst: Tensor, src_mask: Tensor,
                      dst_mask: Tensor, t0: RigidTransform2,
                      config: ICPConfig):
    """Plain PyTorch version of the icp2d_frame kernel: the unfused outer
    loop with torch NN and solver, in solver units."""
    from icp_rust_tpu_torch.models import icp2d as icp2d_mod

    cfg = config.with_(frame_backend="off", nn_backend="torch",
                       align_backend="torch")
    t, it = icp2d_mod._icp2d_solver(src, dst, src_mask, dst_mask, t0, cfg)
    return t.rot, t.t, it


def icp2d_frame(src: Tensor, dst: Tensor, src_mask: Tensor,
                dst_mask: Tensor, t0: RigidTransform2, config: ICPConfig):
    """A whole warm-started 2D ICP call (Icp2d::estimate with the exact
    fixed-point exit) in one launch.  src (N, 2), dst (M, 2) in solver
    units, N, M <= 1536; t0 the warm start in solver units.  Returns
    (rot, t, outer iterations)."""
    if src.device.type == "cpu":
        return icp2d_frame_plain(src, dst, src_mask, dst_mask, t0, config)
    out = icp2d_frame_raw(src, dst, src_mask, dst_mask, t0, config)
    return out[:4].reshape(2, 2), out[4:6], out[6]


def icp2d_frame_raw(src: Tensor, dst: Tensor, src_mask: Tensor,
                    dst_mask: Tensor, t0: RigidTransform2,
                    config: ICPConfig) -> Tensor:
    """Launch the icp2d_frame kernel on CUDA tensors; returns its (8,)
    output: r00 r01 r10 r11 tx ty, outer and summed inner iterations."""
    if src.device.type != "cuda":
        raise ValueError(f"icp2d_frame: unsupported device {src.device}")
    _check_cuda_f32("icp2d_frame", src, dst, t0.rot, t0.t)
    n, m = src.shape[0], dst.shape[0]
    if (src.shape != (n, 2) or dst.shape != (m, 2)
            or not 0 < n <= FRAME_MAX_POINTS
            or not 0 < m <= FRAME_MAX_POINTS):
        raise ValueError(
            f"icp2d_frame: src/dst must be (N, 2) with 0 < N <= "
            f"{FRAME_MAX_POINTS}, got {tuple(src.shape)}, {tuple(dst.shape)}")
    dstm = torch.where(dst_mask[:, None], dst,
                       torch.full_like(dst, _SENTINEL)).contiguous()
    srcc = src.contiguous()
    smask = src_mask.to(device=src.device, dtype=torch.float32).contiguous()
    tp = torch.cat([t0.rot.reshape(-1), t0.t.reshape(-1)]).contiguous()
    out = torch.empty(8, dtype=torch.float32, device=src.device)
    s = config.point_scale
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = cuda_build.launcher("icp2d_frame")(srcc.data_ptr(), smask.data_ptr(), dstm.data_ptr(), n, m,
                tp.data_ptr(), out.data_ptr(),
                *_solver_params(config.huber_k / s, config.det_rel_eps,
                                config.inner_delta_sq_tol,
                                config.inner_max_iter, s),
                config.outer_iters, stream)
    cuda_build.LAUNCHES["icp2d_frame"] += 1
    cuda_build.check(status, "icp2d_frame")
    return out
