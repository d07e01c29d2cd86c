"""The robust SE(2) solver kernels, their wrappers and their plain PyTorch
versions:

- ``csrc/irls_loop.cu``: the whole inner IRLS loop of one pair in one
  launch (align2d_pallas ``_inner_loop_kernel``);
- ``csrc/irls_loop_batched.cu``: the same loop for B pairs in one launch,
  one block per pair (``_inner_loop_batched_kernel``);
- ``csrc/icp2d_frame.cu``: a whole 2D ICP call in one launch
  (``_icp2d_frame_kernel``);
- ``csrc/icp2d_frame_pairs.cu``: B whole 2D ICP calls in one launch, one
  block per pair, each to its own fixed point
  (``_icp2d_frame_pairs_kernel``);
- ``csrc/gn_stats.cu``: one GN update's packed statistics at a given
  transform (``_gn_kernel``);
- ``csrc/gn_stats_batched.cu``: the same for B pairs, one block per pair
  (``_gn_batched_kernel``).

All six run the device routines of ``csrc/irls.cuh`` (the two stats
kernels its ``gn_stats_block``, one iteration's statistics of the loop),
and the two frame kernels the block body of ``csrc/frame.cuh``, so they
share one op sequence.

Plain versions: the inner loops' is ``align2d.irls_loop_torch`` (the
``align_backend="torch"`` loop, batched over pairs); the frames' is the
unfused ``icp2d`` outer loop with ``frame_backend="off"`` and torch
backends, which does not sort: the frame kernels search the unsorted db;
the stats kernels' is ``gn_stats_plain``, the same 16 numbers in
``gn_stats_block``'s op order with the exact medians of ``ops/select``.
A wrapper takes the plain version only for a CPU tensor; a CUDA tensor
reaches the kernel or raises.  The kernels take float32 only: the float64
reference path is a CPU path.

Tolerance against the plain versions: float32 roundoff of the sums, which
are taken in another order (block tree vs torch reductions); the medians
are exact order statistics of residuals that may differ in their last bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import align2d, cuda_build, robust
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
    """Plain PyTorch version of the irls_loop and irls_loop_batched
    kernels: the torch loop, whose done lanes freeze.  Returns (rot, t,
    iterations per lane) with the batch axes of src."""
    return align2d.irls_loop_torch(src, dst, mask, huber_k, det_rel_eps,
                                   tol_d2, max_iter, point_scale)


irls_loop_batched_plain = irls_loop_plain


def irls_loop(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
              det_rel_eps: float, tol_d2: float, max_iter: int,
              point_scale: float):
    """The fixed-correspondence IRLS loop from identity.  src/dst (N, 2)
    in solver units, mask (N,), huber_k in solver units.  Returns
    (rot (2, 2), t (2,), iterations): a 0-d tensor, int32 from the plain
    version, float from the kernel."""
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
    status = cuda_build.launcher("irls_loop")(
        *[c.data_ptr() for c in cols], n, scratch.data_ptr(), out.data_ptr(),
        *_solver_params(huber_k, det_rel_eps, tol_d2, max_iter, point_scale),
        stream)
    cuda_build.LAUNCHES["irls_loop"] += 1
    cuda_build.check(status, "irls_loop")
    return out[:4].reshape(2, 2), out[4:6], out[6]


def irls_loop_batched(src: Tensor, dst: Tensor, mask: Tensor,
                      huber_k: float, det_rel_eps: float, tol_d2: float,
                      max_iter: int, point_scale: float):
    """The fixed-correspondence IRLS loop from identity for B pairs at
    once, each pair stopping on its own.  src/dst (B, N, 2) in solver
    units, mask (B, N).  Returns (rot (B, 2, 2), t (B, 2), iterations per
    pair (B,)): int32 from the plain version, float from the kernel."""
    if src.device.type == "cpu":
        return irls_loop_batched_plain(src, dst, mask, huber_k, det_rel_eps,
                                       tol_d2, max_iter, point_scale)
    if src.device.type != "cuda":
        raise ValueError(f"irls_loop_batched: unsupported device {src.device}")
    _check_cuda_f32("irls_loop_batched", src, dst)
    b, n = src.shape[:2]
    if (src.shape != (b, n, 2) or dst.shape != (b, n, 2)
            or mask.shape != (b, n) or n == 0):
        raise ValueError(
            "irls_loop_batched: src/dst must be (B, N, 2), mask (B, N)")
    cols = [src[..., 0].contiguous(), src[..., 1].contiguous(),
            dst[..., 0].contiguous(), dst[..., 1].contiguous(),
            mask.to(device=src.device, dtype=torch.float32).contiguous()]
    scratch = torch.empty(2 * b * n, dtype=torch.float32, device=src.device)
    out = torch.empty((b, 8), dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = cuda_build.launcher("irls_loop_batched")(
        *[c.data_ptr() for c in cols], b, n, scratch.data_ptr(),
        out.data_ptr(),
        *_solver_params(huber_k, det_rel_eps, tol_d2, max_iter, point_scale),
        stream)
    cuda_build.LAUNCHES["irls_loop_batched"] += 1
    cuda_build.check(status, "irls_loop_batched")
    return out[:, :4].reshape(b, 2, 2), out[:, 4:6], out[:, 6]


def icp2d_frame_plain(src: Tensor, dst: Tensor, src_mask: Tensor,
                      dst_mask: Tensor, t0: RigidTransform2,
                      config: ICPConfig):
    """Plain PyTorch version of the icp2d_frame and icp2d_frame_pairs
    kernels: the unfused outer loop with torch NN and solver and no sort,
    in solver units.  A lane that reaches its fixed point stays bitwise
    unchanged while the others go on.  Returns (rot, t, outer iterations
    per lane, int32)."""
    from icp_rust_tpu_torch.models import icp2d as icp2d_mod

    cfg = config.with_(frame_backend="off", nn_backend="torch",
                       align_backend="torch")
    t, _, lane_it = icp2d_mod._icp2d_solver(src, dst, src_mask, dst_mask,
                                            t0, cfg)
    return t.rot, t.t, lane_it


icp2d_frame_pairs_plain = icp2d_frame_plain


def icp2d_frame(src: Tensor, dst: Tensor, src_mask: Tensor,
                dst_mask: Tensor, t0: RigidTransform2, config: ICPConfig):
    """Whole warm-started 2D ICP calls (Icp2d::estimate with the exact
    fixed-point exit) in one launch: one pair, src (N, 2) and dst (M, 2),
    through the icp2d_frame kernel, or B pairs, (B, N, 2) and (B, M, 2)
    with (B,)-batched warm starts, through the icp2d_frame_pairs kernel,
    each pair to its own fixed point.  Solver units, N, M <= 1536.
    Returns (rot, t, outer iterations per pair)."""
    if src.device.type == "cpu":
        return icp2d_frame_plain(src, dst, src_mask, dst_mask, t0, config)
    out = icp2d_frame_raw(src, dst, src_mask, dst_mask, t0, config)
    return out[..., :4].reshape(*out.shape[:-1], 2, 2), out[..., 4:6], \
        out[..., 6]


icp2d_frame_pairs = icp2d_frame


def icp2d_frame_raw(src: Tensor, dst: Tensor, src_mask: Tensor,
                    dst_mask: Tensor, t0: RigidTransform2,
                    config: ICPConfig) -> Tensor:
    """Launch icp2d_frame (src (N, 2)) or icp2d_frame_pairs (src
    (B, N, 2)) on CUDA tensors; returns the (8,) or (B, 8) output: r00 r01
    r10 r11 tx ty, outer and summed inner iterations of each pair."""
    name = "icp2d_frame" if src.ndim == 2 else "icp2d_frame_pairs"
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    _check_cuda_f32(name, src, dst, t0.rot, t0.t)
    batch = src.shape[:-2]
    n, m = src.shape[-2], dst.shape[-2]
    if (len(batch) > 1 or src.shape[-1] != 2 or dst.shape != (*batch, m, 2)
            or src_mask.shape != (*batch, n) or dst_mask.shape != (*batch, m)
            or t0.rot.shape != (*batch, 2, 2) or t0.t.shape != (*batch, 2)
            or not 0 < n <= FRAME_MAX_POINTS
            or not 0 < m <= FRAME_MAX_POINTS):
        raise ValueError(
            f"{name}: src/dst must be (N, 2) or (B, N, 2) with 0 < N <= "
            f"{FRAME_MAX_POINTS}, masks and warm starts batched alike; got "
            f"{tuple(src.shape)}, {tuple(dst.shape)}")
    dstm = torch.where(dst_mask[..., None], dst,
                       torch.full_like(dst, _SENTINEL)).contiguous()
    srcc = src.contiguous()
    smask = src_mask.to(device=src.device, dtype=torch.float32).contiguous()
    tp = torch.cat([t0.rot.reshape(*batch, 4), t0.t], dim=-1).contiguous()
    out = torch.empty((*batch, 8), dtype=torch.float32, device=src.device)
    s = config.point_scale
    stream = torch.cuda.current_stream(src.device).cuda_stream
    # The pair-frame launcher takes the pair count before (n, m).
    status = cuda_build.launcher(name)(
        srcc.data_ptr(), smask.data_ptr(), dstm.data_ptr(), *batch, n, m,
        tp.data_ptr(), out.data_ptr(),
        *_solver_params(config.huber_k / s, config.det_rel_eps,
                        config.inner_delta_sq_tol, config.inner_max_iter, s),
        config.outer_iters, stream)
    cuda_build.LAUNCHES[name] += 1
    cuda_build.check(status, name)
    return out


def gn_stats_plain(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                   t: Tensor, huber_k: float) -> Tensor:
    """Plain PyTorch version of the gn_stats and gn_stats_batched kernels
    (_gn_kernel, _gn_batched_kernel): the packed (..., 16) statistics of
    clouds (..., N, 2) at (rot (..., 2, 2), t (..., 2)) in src's dtype, in
    gn_stats_block's op order: residuals, the exact median and MAD per
    dimension, the ten sums and the Huber error over the mask-true points,
    the count, sigma_x, sigma_y, 0, 0.  A fully masked cloud gives zero
    sums, count 0 and sigma 0."""
    dt = src.dtype
    rot, t = rot.to(dt), t.to(dt)
    mask = mask.to(device=src.device, dtype=torch.bool)
    sx, sy, dx, dy = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    r00, r01 = rot[..., 0, 0, None], rot[..., 0, 1, None]
    r10, r11 = rot[..., 1, 0, None], rot[..., 1, 1, None]
    tx, ty = t[..., 0, None], t[..., 1, None]
    r = torch.stack([r00 * sx + r01 * sy + tx - dx,
                     r10 * sx + r11 * sy + ty - dy], dim=-2)  # (..., 2, N)
    m2 = mask[..., None, :].expand(r.shape)
    med, _ = robust.masked_median(r, m2)
    mad, _ = robust.masked_median(torch.abs(r - med[..., None]), m2)
    sig = robust.MAD_SCALE * mad  # (..., 2)
    one = torch.ones_like(sig)
    g = torch.where(sig != 0.0, one / torch.where(sig != 0.0, sig, one),
                    torch.zeros_like(sig))
    # k^2 and 2k rounded once to the working type, as the kernels' f32
    # parameters are; a tensor divisor keeps k / sqrt(e) a true division.
    k2 = huber_k * huber_k
    hk = torch.tensor(huber_k, dtype=dt, device=src.device)
    e = r * r
    u = torch.where(e <= k2, torch.ones_like(e), hk / torch.sqrt(e)) \
        * g[..., None]
    w = torch.stack([-r00 * sy + r01 * sx, -r10 * sy + r11 * sx], dim=-2)
    zero = torch.zeros((), dtype=dt, device=src.device)

    def msum(x):
        return torch.sum(torch.where(mask, x, zero), dim=-1)

    sums = []
    for d in range(2):
        u_d, w_d, r_d = u[..., d, :], w[..., d, :], r[..., d, :]
        uw = u_d * w_d
        sums += [msum(u_d), msum(uw), msum(uw * w_d), msum(u_d * r_d),
                 msum(uw * r_d)]
    ee = e[..., 0, :] + e[..., 1, :]
    rho = torch.where(ee <= k2, ee, 2.0 * huber_k * torch.sqrt(ee) - k2)
    err = msum(rho)
    n = torch.sum(mask, dim=-1).to(dt)
    zeros = torch.zeros_like(err)
    return torch.stack(sums + [err, n, sig[..., 0], sig[..., 1], zeros,
                               zeros], dim=-1)


gn_stats_batched_plain = gn_stats_plain


def _gn_launch(name: str, src: Tensor, dst: Tensor, mask: Tensor,
               rot: Tensor, t: Tensor, huber_k: float) -> Tensor:
    """Launch gn_stats (src (N, 2)) or gn_stats_batched (src (B, N, 2)) on
    CUDA tensors; returns the (16,) or (B, 16) output."""
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    _check_cuda_f32(name, src, dst)
    batch = src.shape[:-2]
    n = src.shape[-2]
    if (src.shape != (*batch, n, 2) or dst.shape != src.shape
            or mask.shape != (*batch, n) or rot.shape != (*batch, 2, 2)
            or t.shape != (*batch, 2) or n == 0 or 0 in batch):
        raise ValueError(
            f"{name}: src/dst must be (N, 2) or (B, N, 2) with N, B > 0, "
            f"mask, rot and t batched alike; got {tuple(src.shape)}, "
            f"{tuple(mask.shape)}, {tuple(rot.shape)}, {tuple(t.shape)}")
    cols = [src[..., 0].contiguous(), src[..., 1].contiguous(),
            dst[..., 0].contiguous(), dst[..., 1].contiguous(),
            mask.to(device=src.device, dtype=torch.float32).contiguous()]
    rt = torch.cat([rot.reshape(*batch, 4), t], dim=-1).to(
        device=src.device, dtype=torch.float32).contiguous()
    scratch = torch.empty(2 * src[..., 0].numel(), dtype=torch.float32,
                          device=src.device)
    out = torch.empty((*batch, 16), dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    # ctypes rounds each float to f32 once (k * k and 2 k taken in double
    # first), as the TPU kernel's f32 constants are.
    status = cuda_build.launcher(name)(
        *[c.data_ptr() for c in cols], *batch, n, rt.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), huber_k, huber_k * huber_k,
        2.0 * huber_k, stream)
    cuda_build.LAUNCHES[name] += 1
    cuda_build.check(status, name)
    return out


def gn_stats(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor, t: Tensor,
             huber_k: float) -> Tensor:
    """One robust GN update's statistics at (rot (2, 2), t (2,)): the
    packed (16,) vector of ``assemble_update`` for src/dst (N, 2) in solver
    units, mask (N,).  The kernel takes any N (the TPU kernel's N % 128 ==
    0 comes from its (M, 128) layout, not copied here)."""
    if src.device.type == "cpu":
        return gn_stats_plain(src, dst, mask, rot, t, huber_k)
    if src.ndim != 2:
        raise ValueError("gn_stats: src/dst must be (N, 2)")
    return _gn_launch("gn_stats", src, dst, mask, rot, t, huber_k)


def gn_stats_batched(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                     t: Tensor, huber_k: float) -> Tensor:
    """The statistics of B pairs at once, each at its own (rot (B, 2, 2),
    t (B, 2)): (B, 16) for src/dst (B, N, 2), mask (B, N)."""
    if src.device.type == "cpu":
        return gn_stats_batched_plain(src, dst, mask, rot, t, huber_k)
    if src.ndim != 3:
        raise ValueError("gn_stats_batched: src/dst must be (B, N, 2)")
    return _gn_launch("gn_stats_batched", src, dst, mask, rot, t, huber_k)


def assemble_update(stats: Tensor, rot: Tensor):
    """(jtj (..., 3, 3), jtr (..., 3), err, count, sigma_x, sigma_y) from
    the packed stats (align2d_pallas.assemble_update), batch-agnostic:
    stats (..., 16), rot (..., 2, 2).  With J = [R | w] per point,
    sum u J_x^T J_x needs only S_u, S_uw and S_uw2 of each dimension, and
    J^T r likewise."""
    s = [stats[..., i] for i in range(14)]
    rot = rot.to(stats.dtype)
    jtj = 0.0
    jtr = 0.0
    for d in range(2):
        a, b = rot[..., d, 0], rot[..., d, 1]
        s_u, s_uw, s_uw2, s_ur, s_uwr = s[5 * d:5 * d + 5]
        jtj = jtj + torch.stack([
            torch.stack([a * a * s_u, a * b * s_u, a * s_uw], dim=-1),
            torch.stack([a * b * s_u, b * b * s_u, b * s_uw], dim=-1),
            torch.stack([a * s_uw, b * s_uw, s_uw2], dim=-1)], dim=-2)
        jtr = jtr + torch.stack([a * s_ur, b * s_ur, s_uwr], dim=-1)
    return jtj, jtr, s[10], s[11], s[12], s[13]


def gn_stats_errors(got: Tensor, want: Tensor):
    """How far packed stats ``got`` (..., 16) are from ``want``, over every
    pair: (max error of the ten sums and the Huber error, each against the
    Cauchy-Schwarz bound of its absolute terms, max |count difference|,
    max relative sigma error).  With u >= 0 the absolute terms of S_uw sum
    to at most sqrt(S_u S_uw2), those of S_ur and S_uwr to at most
    sqrt(S_u g err) and sqrt(S_uw2 g err) (u r_d^2 <= g rho(|r|^2) for
    Huber's rho, g = 1 / sigma_d); S_u, S_uw2 and the error have no
    negative terms.  So the measure is the sums' roundoff whatever
    cancellation a sum has."""
    w = want.detach().to(device="cpu", dtype=torch.float64).reshape(-1, 16)
    d = (got.detach().to(device="cpu", dtype=torch.float64).reshape(-1, 16)
         - w).abs()
    err = w[:, 10]
    scale = torch.empty_like(w[:, :11])
    for base, sig in ((0, w[:, 12]), (5, w[:, 13])):
        g = torch.where(sig != 0.0, 1.0 / torch.where(sig != 0.0, sig, 1.0),
                        0.0)
        s_u, s_uw2 = w[:, base], w[:, base + 2]
        scale[:, base] = s_u
        scale[:, base + 1] = torch.sqrt(s_u * s_uw2)
        scale[:, base + 2] = s_uw2
        scale[:, base + 3] = torch.sqrt(s_u * g * err)
        scale[:, base + 4] = torch.sqrt(s_uw2 * g * err)
    scale[:, 10] = err
    rel = float(torch.max(d[:, :11] / torch.clamp(scale, min=1e-30)))
    sig_rel = float(torch.max(d[:, 12:14] / torch.clamp(
        w[:, 12:14].abs(), min=1e-30)))
    return rel, float(torch.max(d[:, 11])), sig_rel
