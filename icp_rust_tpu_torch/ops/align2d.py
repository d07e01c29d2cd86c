"""SE(2) robust Gauss-Newton alignment core, masked.

Counterpart of the solver core of reference src/lib.rs:

- ``error`` and ``huber_error`` (src/lib.rs:38-50): masked sums of the
  squared residual norms, plain and under Huber's rho;
- ``jacobian``: J = [R | R (-a_y, a_x)^T] per point (src/lib.rs:176-184);
- ``gauss_newton_update`` (src/lib.rs:191-216): the plain GN step;
- ``weighted_gauss_newton_update`` (src/lib.rs:218-261): robust sigma per
  residual dimension, Huber IRLS weights, masked einsum sums, adjugate
  3x3 solve; ``weighted_gn_update_cuda`` takes the same step from the
  packed statistics of the ``gn_stats`` kernels (ops/align2d_cuda.py);
- ``estimate_transform`` (src/lib.rs:59-84): the inner IRLS loop, up to
  ``inner_max_iter`` iterations with the reference's three stop
  conditions in its order: singular/degenerate -> stop; |delta|^2 below
  the tolerance, checked BEFORE the update is applied; the Huber error at
  the pre-update transform exceeding the previous iteration's -> stop.  A
  stopping iteration discards its delta.

``estimate_transform`` dispatches to the one-launch ``irls_loop`` kernel
(ops/align2d_cuda.py), or for a batch of pairs (B, N, 2) to the one-launch
``irls_loop_batched`` kernel, when config.align_backend resolves to
"cuda" (for "auto": float32); else it runs the plain loop
``irls_loop_torch`` here, which is also both kernels' plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import huber, linalg, robust


def residuals(transform: RigidTransform2, src: Tensor, dst: Tensor) -> Tensor:
    """r_i = T(s_i) - d_i; (..., N, 2). Ref src/lib.rs:34-36."""
    return transform.apply_points(src) - dst


def error(transform: RigidTransform2, src: Tensor, dst: Tensor,
          mask: Tensor) -> Tensor:
    """Masked sum of squared residual norms. Ref src/lib.rs:38-43."""
    r = residuals(transform, src, dst)
    return torch.sum(torch.sum(r * r, dim=-1) * mask.to(r.dtype), dim=-1)


def huber_error(transform: RigidTransform2, src: Tensor, dst: Tensor,
                mask: Tensor, huber_k: float) -> Tensor:
    """Masked sum of rho(|r|^2, k). Ref src/lib.rs:45-50."""
    r = residuals(transform, src, dst)
    return torch.sum(huber.rho(torch.sum(r * r, dim=-1), huber_k)
                     * mask.to(r.dtype), dim=-1)


def jacobian(rot: Tensor, src: Tensor) -> Tensor:
    """Per-point SE(2) Jacobian: rot (..., 2, 2), src (..., N, 2) ->
    (..., N, 2, 3)."""
    arm = torch.stack([-src[..., 1], src[..., 0]], dim=-1)
    rot_arm = torch.einsum("...ij,...nj->...ni", rot, arm)
    rot_cols = rot[..., None, :, :].expand(*rot_arm.shape[:-1], 2, 2)
    return torch.cat([rot_cols, rot_arm[..., :, None]], dim=-1)


def _count_gate(mask: Tensor) -> Tensor:
    """check_input_size: n > 0 and n >= dim(=2). Ref src/lib.rs:186-189."""
    return torch.sum(mask, dim=-1) >= 2


class GNUpdate(NamedTuple):
    delta: Tensor  # (..., 3) twist update (zeros where not ok)
    ok: Tensor     # (...,) bool
    err: Tensor    # (...,) error at the PRE-update transform, which rides
                   # along because the residuals are already in hand.
                   # Update-specific: the weighted (IRLS) updates fill it
                   # with the Huber error (what the inner loop's stop 3
                   # compares, src/lib.rs:75-79); gauss_newton_update with
                   # the unweighted squared-residual sum.  Do not mix the
                   # two in one stop-condition chain.


def gauss_newton_update(transform: RigidTransform2, src: Tensor,
                        dst: Tensor, mask: Tensor,
                        det_rel_eps: float = 0.0) -> GNUpdate:
    """Plain GN step. Ref src/lib.rs:191-216."""
    maskf = mask.to(src.dtype)
    j = jacobian(transform.rot, src)
    r = residuals(transform, src, dst)
    jtr = torch.einsum("...nik,...ni,...n->...k", j, r, maskf)
    jtj = torch.einsum("...nik,...nil,...n->...kl", j, j, maskf)
    x, ok_solve = linalg.solve3x3(jtj, jtr, det_rel_eps)
    ok = ok_solve & _count_gate(mask)
    delta = torch.where(ok[..., None], -x, torch.zeros_like(x))
    err = torch.sum(torch.sum(r * r, dim=-1) * maskf, dim=-1)
    return GNUpdate(delta, ok, err)


def weighted_gauss_newton_update(transform: RigidTransform2, src: Tensor,
                                 dst: Tensor, mask: Tensor, huber_k: float,
                                 det_rel_eps: float = 0.0) -> GNUpdate:
    """Robust IRLS GN step. Ref src/lib.rs:218-261: per point and residual
    dimension j, weight drho(r_ij^2, k) scaled by 1/sigma_j (the dimension
    is skipped where sigma_j == 0)."""
    maskf = mask.to(src.dtype)
    r = residuals(transform, src, dst)
    sigma, stats_valid = robust.calc_stddevs(r, mask)
    dim_ok = sigma != 0.0
    g = torch.where(dim_ok, 1.0 / torch.where(dim_ok, sigma,
                                              torch.ones_like(sigma)),
                    torch.zeros_like(sigma))
    w = huber.drho(r * r, huber_k)
    u = w * g[..., None, :] * maskf[..., :, None]
    j = jacobian(transform.rot, src)
    jtr = torch.einsum("...ni,...nik,...ni->...k", u, j, r)
    jtj = torch.einsum("...ni,...nik,...nil->...kl", u, j, j)
    err = torch.sum(huber.rho(torch.sum(r * r, dim=-1), huber_k) * maskf,
                    dim=-1)
    x, ok_solve = linalg.solve3x3(jtj, jtr, det_rel_eps)
    ok = ok_solve & _count_gate(mask) & stats_valid
    delta = torch.where(ok[..., None], -x, torch.zeros_like(x))
    return GNUpdate(delta, ok, err)


def weighted_gn_update_cuda(transform: RigidTransform2, src: Tensor,
                            dst: Tensor, mask: Tensor, huber_k: float,
                            det_rel_eps: float = 0.0) -> GNUpdate:
    """One robust GN update from the packed statistics of the ``gn_stats``
    kernel (src/dst (N, 2)) or, for B pairs (B, N, 2), of the
    ``gn_stats_batched`` kernel: the counterpart of
    ``weighted_gn_update_pallas``, the same math as
    ``weighted_gauss_newton_update`` with the sums in another order."""
    from icp_rust_tpu_torch.ops import align2d_cuda

    fn = (align2d_cuda.gn_stats_batched if src.ndim == 3
          else align2d_cuda.gn_stats)
    stats = fn(src, dst, mask, transform.rot, transform.t, huber_k)
    jtj, jtr, err, nf, _, _ = align2d_cuda.assemble_update(stats,
                                                           transform.rot)
    x, ok_solve = linalg.solve3x3(jtj.to(src.dtype), jtr.to(src.dtype),
                                  det_rel_eps)
    ok = ok_solve & (nf >= 2) & (nf > 0)
    delta = torch.where(ok[..., None], -x, torch.zeros_like(x))
    return GNUpdate(delta, ok, err.to(src.dtype))


def _delta_sq_physical(delta: Tensor, point_scale: float) -> Tensor:
    """|delta|^2 with translation components rescaled to physical units."""
    s = point_scale
    return ((delta[..., 0] * s) ** 2 + (delta[..., 1] * s) ** 2
            + delta[..., 2] ** 2)


def irls_loop_torch(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
                    det_rel_eps: float, tol_d2: float, max_iter: int,
                    point_scale: float):
    """The inner loop with FIXED correspondences, from identity, in plain
    torch.  src/dst (..., N, 2) in solver units, mask (..., N), huber_k in
    solver units.  Batch lanes freeze when done and the loop exits when
    all are.  Returns (rot, t, iterations): per lane, int32, the
    iterations it ran, its stopping one included."""
    dtype = src.dtype
    batch = src.shape[:-2]
    t = RigidTransform2.identity(batch, dtype, src.device)
    prev_err = torch.full(batch, torch.finfo(dtype).max, dtype=dtype,
                          device=src.device)
    done = torch.zeros(batch, dtype=torch.bool, device=src.device)
    lane_it = torch.zeros(batch, dtype=torch.int32, device=src.device)
    it = 0
    while it < max_iter and not bool(torch.all(done)):
        lane_it = lane_it + (~done).to(torch.int32)
        upd = weighted_gauss_newton_update(t, src, dst, mask, huber_k,
                                           det_rel_eps)
        stop = ~upd.ok
        stop = stop | (_delta_sq_physical(upd.delta, point_scale) < tol_d2)
        stop = stop | (upd.err > prev_err)
        keep = done | stop
        t_step = RigidTransform2.from_twist(upd.delta).compose(t)
        t = RigidTransform2(
            rot=torch.where(keep[..., None, None], t.rot, t_step.rot),
            t=torch.where(keep[..., None], t.t, t_step.t),
        )
        prev_err = torch.where(keep, prev_err, upd.err)
        done = keep
        it += 1
    return t.rot, t.t, lane_it


def use_cuda_align(src: Tensor, backend: str) -> bool:
    """Resolve the align backend: the kernel for "cuda", and for "auto"
    on float32."""
    if backend == "cuda":
        return True
    return backend == "auto" and src.dtype == torch.float32


def estimate_transform(src: Tensor, dst: Tensor, mask: Tensor,
                       config: ICPConfig) -> RigidTransform2:
    """Inner alignment loop with FIXED correspondences. Ref
    src/lib.rs:59-84.  src/dst (N, 2), or (B, N, 2) for B pairs, in solver
    units; starts from identity and left-composes Exp(delta)."""
    huber_k = config.huber_k / config.point_scale
    args = (huber_k, config.det_rel_eps, config.inner_delta_sq_tol,
            config.inner_max_iter, config.point_scale)
    if use_cuda_align(src, config.align_backend):
        from icp_rust_tpu_torch.ops import align2d_cuda

        if src.ndim == 2:
            rot, t, _ = align2d_cuda.irls_loop(src, dst, mask, *args)
        elif src.ndim == 3:
            rot, t, _ = align2d_cuda.irls_loop_batched(src, dst, mask, *args)
        else:
            raise NotImplementedError(
                "a kernel-route inner loop over more than one batch axis is "
                "not ported (align2d_pallas._inner_loop_batched_kernel takes "
                "one pair axis); pass align_backend='torch'")
    else:
        rot, t, _ = irls_loop_torch(src, dst, mask, *args)
    return RigidTransform2(rot, t)
