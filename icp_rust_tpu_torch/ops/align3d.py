"""SE(3) robust point-to-plane Gauss-Newton alignment, masked (JAX
package ``ops/align3d.py``; the build's 3D config, BASELINE.json
configs[1]).

The robust machinery mirrors the 2D solver's:

- scalar residual r_i = n_i . (T(s_i) - d_i) per correspondence;
- robust sigma = 1.4826 * MAD over the residuals (the D = 1 analogue of
  reference src/stats.rs:49-60), the update skipped if sigma == 0;
- IRLS weight w = drho(r^2, huber_k) (reference src/huber.rs:17-26);
- the inner loop with the reference's stop conditions in its order
  (src/lib.rs:59-84), left-composed Exp(delta).

Jacobian (T <- Exp(delta) o T, twist (v, w)): with p = T(s),
dr/dv = n and dr/dw = p x n.

``estimate_transform_p2l`` runs the whole loop in one launch of the
``p2l_loop`` kernel (``ops/align3d_cuda.py``) when ``use_cuda_p2l``
resolves to the kernel route; else the plain loop here, whose 6x6 solve is
an LU solve with ``_solve6``'s residual gate, as the JAX package's XLA
path is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.ops import huber, robust
from icp_rust_tpu_torch.ops.align2d import use_cuda_align


class GNUpdate6(NamedTuple):
    delta: Tensor  # (..., 6) twist update (zeros where not ok)
    ok: Tensor     # (...,) bool
    err: Tensor    # (...,) Huber error at the PRE-update transform


def plane_residuals(transform: RigidTransform3, src: Tensor, dst: Tensor,
                    normals: Tensor) -> Tensor:
    """n_i . (T(s_i) - d_i); (..., N)."""
    p = transform.apply_points(src)
    return torch.sum((p - dst) * normals, dim=-1)


def huber_error_p2l(transform: RigidTransform3, src: Tensor, dst: Tensor,
                    normals: Tensor, mask: Tensor, huber_k: float) -> Tensor:
    r = plane_residuals(transform, src, dst, normals)
    return torch.sum(huber.rho(r * r, huber_k) * mask.to(r.dtype), dim=-1)


def _solve6(jtj: Tensor, jtr: Tensor, n_ok: Tensor):
    """Gated 6x6 LU solve shared by the plain and the stats-kernel updates.

    Returns (x, ok): LU on an identity-substituted system where n_ok is
    False; ok also requires a finite x and a small back-substitution
    residual against the system scale (the inf-norm of jtr), which rejects
    (near-)singular systems robustly in f32.  ``solve_ex`` does not raise
    on an exactly singular system: its non-finite x fails the gate, as
    ``jnp.linalg.solve``'s does."""
    eye = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    jtj_safe = torch.where(n_ok[..., None, None], jtj, eye)
    x = torch.linalg.solve_ex(jtj_safe, jtr[..., None])[0][..., 0]
    finite = torch.all(torch.isfinite(x), dim=-1)
    back = torch.einsum("...kl,...l->...k", jtj_safe, x)
    scale = torch.amax(torch.abs(jtr), dim=-1, keepdim=True)
    resid_ok = torch.all(
        torch.abs(back - jtr) <= 1e-3 * torch.clamp(scale, min=1e-30) + 1e-20,
        dim=-1)
    return x, n_ok & finite & resid_ok


def weighted_gn_update_p2l(transform: RigidTransform3, src: Tensor,
                           dst: Tensor, normals: Tensor, mask: Tensor,
                           huber_k: float) -> GNUpdate6:
    """One robust point-to-plane GN step (plain PyTorch)."""
    maskf = mask.to(src.dtype)
    r = plane_residuals(transform, src, dst, normals)  # (..., N)
    sigma, stats_valid = robust.masked_stddev(r, mask)
    dim_ok = sigma != 0.0
    g = torch.where(dim_ok, 1.0 / torch.where(dim_ok, sigma,
                                              torch.ones_like(sigma)),
                    torch.zeros_like(sigma))
    w = huber.drho(r * r, huber_k)
    u = w * g[..., None] * maskf  # (..., N)

    p = transform.apply_points(src)
    j = torch.cat([normals, torch.linalg.cross(p, normals, dim=-1)], dim=-1)
    jtr = torch.einsum("...n,...nk,...n->...k", u, j, r)
    jtj = torch.einsum("...n,...nk,...nl->...kl", u, j, j)
    err = torch.sum(huber.rho(r * r, huber_k) * maskf, dim=-1)
    n_ok = torch.sum(mask, dim=-1) >= 6
    x, solve_ok = _solve6(jtj, jtr, n_ok)
    ok = solve_ok & stats_valid & dim_ok
    delta = torch.where(ok[..., None], -x, torch.zeros_like(x))
    return GNUpdate6(delta, ok, err)


def weighted_gn_update_p2l_cuda(transform: RigidTransform3, src: Tensor,
                                dst: Tensor, normals: Tensor, mask: Tensor,
                                huber_k: float) -> GNUpdate6:
    """One GN update from the ``p2l_stats`` kernel's packed statistics
    (the counterpart of ``weighted_gn_update_p2l_pallas``): the same math
    as ``weighted_gn_update_p2l``, sums in another order.  Unbatched: src,
    dst, normals (N, 3), mask (N,)."""
    from icp_rust_tpu_torch.ops import align3d_cuda

    stats = align3d_cuda.p2l_stats(src, dst, normals, mask, transform.rot,
                                   transform.t, huber_k)
    jtj, jtr, err, nf, sig = align3d_cuda.assemble_p2l(stats)
    x, solve_ok = _solve6(jtj.to(src.dtype), jtr.to(src.dtype), nf >= 6)
    ok = solve_ok & (sig != 0.0)
    delta = torch.where(ok[..., None], -x, torch.zeros_like(x))
    return GNUpdate6(delta, ok, err.to(src.dtype))


# The p2l loop's backend resolves as the SE(2) solver's: the kernel route
# for "cuda", and for "auto" on float32.  The kernel takes any N (the TPU
# kernel's N % 128 == 0 comes from its (M, 128) layout, not copied here).
use_cuda_p2l = use_cuda_align


def _loop_torch(src, dst, normals, mask, huber_k: float, config: ICPConfig):
    """The plain inner loop from identity, batch lanes freezing when done."""
    dtype = src.dtype
    batch = src.shape[:-2]
    t = RigidTransform3.identity(batch, dtype, src.device)
    prev = torch.full(batch, torch.finfo(dtype).max, dtype=dtype,
                      device=src.device)
    done = torch.zeros(batch, dtype=torch.bool, device=src.device)
    s2 = config.point_scale ** 2
    it = 0
    while it < config.inner_max_iter and not bool(torch.all(done)):
        upd = weighted_gn_update_p2l(t, src, dst, normals, mask, huber_k)
        # Physical-units threshold: the translation components rescale.
        d2_phys = (torch.sum(upd.delta[..., :3] ** 2, dim=-1) * s2
                   + torch.sum(upd.delta[..., 3:] ** 2, dim=-1))
        stop = ~upd.ok | (d2_phys < config.inner_delta_sq_tol)
        stop = stop | (upd.err > prev)
        newly = done | stop
        t_step = RigidTransform3.from_twist(upd.delta).compose(t)
        t = RigidTransform3(
            rot=torch.where(newly[..., None, None], t.rot, t_step.rot),
            t=torch.where(newly[..., None], t.t, t_step.t))
        prev = torch.where(newly, prev, upd.err)
        done = newly
        it += 1
    return t


def estimate_transform_p2l(src: Tensor, dst: Tensor, normals: Tensor,
                           mask: Tensor, config: ICPConfig) -> RigidTransform3:
    """Inner IRLS loop with FIXED correspondences (reference loop
    structure, src/lib.rs:59-84, on SE(3)), from identity.  src/dst/normals
    (N, 3) in solver units, mask (N,).  The kernel route is unbatched, as
    the TPU's is; the plain loop also takes batch axes."""
    huber_k = config.huber_k / config.point_scale
    if use_cuda_p2l(src, config.align_backend):
        if src.ndim != 2:
            raise NotImplementedError(
                "a batched kernel-route p2l loop is not ported (the TPU "
                "kernel align3d_pallas._p2l_loop_kernel is unbatched too); "
                "pass align_backend='torch'")
        from icp_rust_tpu_torch.ops import align3d_cuda

        rot, t, _ = align3d_cuda.p2l_loop(
            src, dst, normals, mask, huber_k, config.inner_delta_sq_tol,
            config.inner_max_iter, config.point_scale)
        return RigidTransform3(rot, t)
    return _loop_torch(src, dst, normals, mask, huber_k, config)
