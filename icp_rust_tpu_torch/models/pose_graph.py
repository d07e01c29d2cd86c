"""SE(2)/SE(3) pose-graph optimization (BASELINE.json configs[4]; JAX
package ``models/pose_graph.py``).

Poses T_0..T_{P-1}; edges (i, j, z_ij, info_ij) with residual

    r_e = Log(z_ij^-1 o T_i^-1 o T_j)   in R^dof,

the left-multiplicative boxplus T <- Exp(delta) o T (reference
src/lib.rs:81).  A graph over ``RigidTransform2`` poses optimizes on SE(2)
(3-DoF twists), one over ``RigidTransform3`` on SE(3) (6-DoF); the dispatch
is on ``poses.t.shape[-1]``.

Per-edge Jacobians wrt the local updates delta_i, delta_j are forward-mode
derivatives of that expression at delta = 0 (``torch.func.jacfwd`` under
``torch.func.vmap`` over the edges, as ``jax.jacfwd`` under ``vmap``).  At
a chain edge's own measurement the residual is exactly zero and the
rotation log sits at the identity: its Taylor branches are the selected
ones, and ``torch.where`` keeps the generic branches' infinite tangents
out.  Gauss-Newton builds the (dof P)x(dof P) normal equations; pose 0 is
gauge-fixed with a strong prior.

Solvers:
- ``solve="dense"``: scatter-assembled dense H (``index_put_`` with
  accumulation: float atomics in no fixed order on the card, ~1e-15
  relative run to run in float64), LU solve (``torch.linalg.solve``);
- ``solve="cg"``: matrix-free preconditioned conjugate gradients with
  ``jax.scipy.sparse.linalg.cg``'s stopping rule (||r||² <= tol² ||b||²,
  tol 1e-5) and ``maxiter``; H @ x edge-wise (block-Jacobi
  preconditioner).

``optimize`` runs all ``iters`` Gauss-Newton steps, zeroing the step once
it converged, and CG all ``cg_iters`` steps with converged lanes frozen
(``lax.scan``/``while_loop`` semantics without a host read per step).  The
graph runs in float64 on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.ops import huber


class PoseGraph(NamedTuple):
    poses: "RigidTransform2 | RigidTransform3"  # batched (P,)
    edge_i: Tensor          # (E,) int64
    edge_j: Tensor          # (E,) int64
    meas: "RigidTransform2 | RigidTransform3"   # batched (E,): z_ij
    info: Tensor            # (E, dof, dof) information matrices
    edge_mask: Tensor       # (E,) bool


def _group(poses):
    """(transform class, twist dof) from the pose point dimension."""
    dim = poses.t.shape[-1]
    if dim == 2:
        return RigidTransform2, 3
    if dim == 3:
        return RigidTransform3, 6
    raise ValueError(f"pose dimension must be 2 or 3, got {dim}")


def edge_residual(tcls, ti_rot, ti_t, tj_rot, tj_t, z_rot, z_t, di, dj):
    """r = Log(z^-1 (Exp(di) T_i)^-1 (Exp(dj) T_j)); all args unbatched."""
    ti = tcls(ti_rot, ti_t)
    tj = tcls(tj_rot, tj_t)
    z = tcls(z_rot, z_t)
    ti2 = tcls.from_twist(di).compose(ti)
    tj2 = tcls.from_twist(dj).compose(tj)
    rel = z.inverse().compose(ti2.inverse().compose(tj2))
    return rel.log()


def edge_residuals_and_jacobians(graph: PoseGraph):
    """Residuals (E, dof) and Jacobians (E, dof, dof) x2 at delta = 0."""
    tcls, dof = _group(graph.poses)
    zero = torch.zeros(dof, dtype=graph.poses.t.dtype,
                       device=graph.poses.t.device)

    def one(ti_r, ti_t, tj_r, tj_t, z_r, z_t):
        def f(di, dj):
            return edge_residual(tcls, ti_r, ti_t, tj_r, tj_t, z_r, z_t,
                                 di, dj)
        r = f(zero, zero)
        ji = torch.func.jacfwd(f, argnums=0)(zero, zero)
        jj = torch.func.jacfwd(f, argnums=1)(zero, zero)
        return r, ji, jj

    ei, ej = graph.edge_i, graph.edge_j
    return torch.func.vmap(one)(
        graph.poses.rot[ei], graph.poses.t[ei], graph.poses.rot[ej],
        graph.poses.t[ej], graph.meas.rot, graph.meas.t)


def _edge_weights(r: Tensor, info: Tensor, mask: Tensor, huber_k,
                  kernel: str = "huber") -> Tensor:
    """Robust IRLS weight per edge on the info-metric squared norm:
    ``huber.drho`` (reference src/huber.rs) or Cauchy 1/(1 + e2/k^2)."""
    e2 = torch.einsum("ek,ekl,el->e", r, info, r)
    if huber_k is None:
        w = torch.ones_like(e2)
    elif kernel == "cauchy":
        w = 1.0 / (1.0 + e2 / (huber_k * huber_k))
    else:
        w = huber.drho(e2, huber_k)
    return w * mask.to(r.dtype)


def graph_error(graph: PoseGraph, huber_k=None) -> Tensor:
    r, _, _ = edge_residuals_and_jacobians(graph)
    e2 = torch.einsum("ek,ekl,el->e", r, graph.info, r)
    if huber_k is not None:
        e2 = huber.rho(e2, huber_k)
    return torch.sum(e2 * graph.edge_mask.to(r.dtype))


def _block_index(rows: Tensor, cols: Tensor, dof: int):
    """Index tensors addressing the (E, dof, dof) blocks h[rows[e], a,
    cols[e], b] of a (P, dof, P, dof) tensor."""
    e = rows.shape[0]
    k = torch.arange(dof, device=rows.device)
    return (rows[:, None, None].expand(e, dof, dof),
            k[None, :, None].expand(e, dof, dof),
            cols[:, None, None].expand(e, dof, dof),
            k[None, None, :].expand(e, dof, dof))


def _assemble_dense(graph: PoseGraph, r, ji, jj, w):
    p = graph.poses.t.shape[0]
    dof = r.shape[-1]
    wi = w[:, None, None]
    info = graph.info
    a_ii = wi * torch.einsum("eki,ekl,elj->eij", ji, info, ji)
    a_jj = wi * torch.einsum("eki,ekl,elj->eij", jj, info, jj)
    a_ij = wi * torch.einsum("eki,ekl,elj->eij", ji, info, jj)
    b_i = w[:, None] * torch.einsum("eki,ekl,el->ei", ji, info, r)
    b_j = w[:, None] * torch.einsum("eki,ekl,el->ei", jj, info, r)

    ei, ej = graph.edge_i, graph.edge_j
    h = torch.zeros((p, dof, p, dof), dtype=r.dtype, device=r.device)
    h.index_put_(_block_index(ei, ei, dof), a_ii, accumulate=True)
    h.index_put_(_block_index(ej, ej, dof), a_jj, accumulate=True)
    h.index_put_(_block_index(ei, ej, dof), a_ij, accumulate=True)
    h.index_put_(_block_index(ej, ei, dof), a_ij.transpose(-1, -2),
                 accumulate=True)
    b = torch.zeros((p, dof), dtype=r.dtype, device=r.device)
    b.index_add_(0, ei, b_i)
    b.index_add_(0, ej, b_j)
    return h.reshape(dof * p, dof * p), b.reshape(dof * p)


def _apply_h(graph: PoseGraph, ji, jj, w, x: Tensor) -> Tensor:
    """Matrix-free H @ x, edge-wise."""
    p = graph.poses.t.shape[0]
    dof = ji.shape[-1]
    xp = x.reshape(p, dof)
    jx = (torch.einsum("ekj,ej->ek", ji, xp[graph.edge_i])
          + torch.einsum("ekj,ej->ek", jj, xp[graph.edge_j]))
    y = w[:, None] * torch.einsum("ekl,el->ek", graph.info, jx)
    out = torch.zeros((p, dof), dtype=x.dtype, device=x.device)
    out.index_add_(0, graph.edge_i, torch.einsum("ekj,ek->ej", ji, y))
    out.index_add_(0, graph.edge_j, torch.einsum("ekj,ek->ej", jj, y))
    return out.reshape(dof * p)


def _apply_b(graph: PoseGraph, r, ji, jj, w) -> Tensor:
    p = graph.poses.t.shape[0]
    dof = r.shape[-1]
    y = w[:, None] * torch.einsum("ekl,el->ek", graph.info, r)
    b = torch.zeros((p, dof), dtype=r.dtype, device=r.device)
    b.index_add_(0, graph.edge_i, torch.einsum("ekj,ek->ej", ji, y))
    b.index_add_(0, graph.edge_j, torch.einsum("ekj,ek->ej", jj, y))
    return b.reshape(dof * p)


def _block_jacobi_inv(graph: PoseGraph, ji, jj, w, gauge=None) -> Tensor:
    p = graph.poses.t.shape[0]
    dof = ji.shape[-1]
    wi = w[:, None, None]
    a_ii = wi * torch.einsum("eki,ekl,elj->eij", ji, graph.info, ji)
    a_jj = wi * torch.einsum("eki,ekl,elj->eij", jj, graph.info, jj)
    diag = torch.zeros((p, dof, dof), dtype=w.dtype, device=w.device)
    diag.index_add_(0, graph.edge_i, a_ii)
    diag.index_add_(0, graph.edge_j, a_jj)
    if gauge is not None:
        # The gauge prior belongs in the preconditioner: without it the
        # preconditioned pose-0 modes have eigenvalues ~1e8/|H_00| and CG
        # stalls on them.
        diag = diag + torch.diag_embed(gauge.reshape(p, dof))
    diag = diag + 1e-8 * torch.eye(dof, dtype=w.dtype, device=w.device)
    return torch.linalg.inv(diag)  # (P, dof, dof)


def _gauge_prior(p: int, dof: int, dtype, device, weight: float = 1e8):
    """Strong prior pinning pose 0 (gauge freedom)."""
    d = torch.zeros((dof * p,), dtype=dtype, device=device)
    d[:dof] = weight
    return d


def _pcg(matvec, b: Tensor, precond, maxiter: int,
         tol: float = 1e-5) -> Tensor:
    """Preconditioned CG from x0 = 0 with ``jax.scipy.sparse.linalg.cg``'s
    rule: iterate while ||r||² > tol² ||b||² and k < maxiter.  All
    ``maxiter`` steps run; a converged state is carried unchanged."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = torch.dot(r, z)
    atol2 = tol * tol * torch.dot(b, b)
    for _ in range(maxiter):
        active = torch.dot(r, r) > atol2
        ap = matvec(p)
        alpha = gamma / torch.dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        gamma_new = torch.dot(r_new, z_new)
        p_new = z_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def optimize(graph: PoseGraph, iters: int = 20, solve: str = "dense",
             huber_k=None, cg_iters: int = 50, delta_tol: float = 1e-10,
             kernel: str = "huber") -> PoseGraph:
    """Gauss-Newton on the pose graph; returns the graph with updated
    poses."""
    if solve not in ("dense", "cg"):
        raise ValueError(f"solve must be 'dense' or 'cg', got {solve!r}")
    tcls, dof = _group(graph.poses)
    p = graph.poses.t.shape[0]
    dtype, dev = graph.poses.t.dtype, graph.poses.t.device
    gauge = _gauge_prior(p, dof, dtype, dev)
    eye = torch.eye(dof * p, dtype=dtype, device=dev)
    g = graph
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        r, ji, jj = edge_residuals_and_jacobians(g)
        w = _edge_weights(r, g.info, g.edge_mask, huber_k, kernel)
        if solve == "dense":
            h, b = _assemble_dense(g, r, ji, jj, w)
            h = h + torch.diag(gauge) + 1e-10 * eye
            delta = -torch.linalg.solve(h, b)
        else:
            b = _apply_b(g, r, ji, jj, w)
            minv = _block_jacobi_inv(g, ji, jj, w, gauge)

            def hx(x, g=g, ji=ji, jj=jj, w=w):
                return _apply_h(g, ji, jj, w, x) + gauge * x

            def prec(x, minv=minv):
                return torch.einsum("pij,pj->pi", minv,
                                    x.reshape(p, dof)).reshape(dof * p)

            delta = _pcg(hx, -b, prec, cg_iters)
        delta = torch.where(done, torch.zeros_like(delta), delta)
        stepped = tcls.from_twist(delta.reshape(p, dof))
        g = g._replace(poses=stepped.compose(g.poses))
        done = done | (torch.sum(delta * delta) < delta_tol)
    return g


def odometry_chain_graph(transforms, info_scale: float = 1.0,
                         extra_edges=None, dtype=torch.float64) -> PoseGraph:
    """A pose graph from a chain of relative odometry transforms.

    transforms: batched (P-1,) relative motions, measurement z_k = T_k^-1
    T_{k+1} (``RigidTransform2`` or ``RigidTransform3``); the chain is
    integrated for the initial guess.  extra_edges: list of (i, j,
    transform, info dof x dof) loop closures.  The graph lives on the
    transforms' device."""
    tcls = type(transforms)
    dev = transforms.t.device
    dof = 3 if transforms.t.shape[-1] == 2 else 6
    n_rel = transforms.t.shape[0]
    p = n_rel + 1
    ident = tcls.identity(dtype=dtype, device=dev)
    rots, ts = [ident.rot], [ident.t]
    for k in range(n_rel):
        prev = tcls(rots[-1], ts[-1])
        nxt = prev.compose(tcls(transforms.rot[k], transforms.t[k]))
        rots.append(nxt.rot)
        ts.append(nxt.t)
    poses = tcls(torch.stack(rots), torch.stack(ts))

    ei = list(range(n_rel))
    ej = list(range(1, p))
    z_rot = [transforms.rot[k] for k in range(n_rel)]
    z_t = [transforms.t[k] for k in range(n_rel)]
    infos = [info_scale * torch.eye(dof, dtype=dtype, device=dev)] * n_rel
    for (i, j, z, info) in extra_edges or ():
        ei.append(i)
        ej.append(j)
        z_rot.append(z.rot.to(device=dev, dtype=dtype))
        z_t.append(z.t.to(device=dev, dtype=dtype))
        infos.append(torch.as_tensor(info, dtype=dtype, device=dev))
    return PoseGraph(
        poses=poses,
        edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
        edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
        meas=tcls(torch.stack(z_rot), torch.stack(z_t)),
        info=torch.stack(infos),
        edge_mask=torch.ones(len(ei), dtype=torch.bool, device=dev),
    )
