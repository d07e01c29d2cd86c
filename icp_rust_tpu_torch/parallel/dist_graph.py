"""Distributed pose-graph Gauss-Newton: the edges sharded over a mesh axis
(JAX package ``parallel/dist_graph.py``).

Poses are replicated (3 or 6 DoF each); each rank of ``edge_axis`` holds
its contiguous block of the edges, padded with masked edges to a multiple
of the axis size.  Every contraction over edges is a local edge-wise
product followed by an all-reduce: the gradient b, the block-Jacobi
diagonal and each H @ x inside ``pose_graph._pcg``.  The CG then runs
replicated on identical data, and so do its exit at convergence (a host
read of a replicated value) and the ``done`` exit, so the ranks stay in
step with no other synchronisation.  SE(2) and SE(3) graphs shard
the same way.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.parallel.collectives import psum
from icp_rust_tpu_torch.parallel.mesh import axis, block, check_mesh, \
    mesh_device


def _pad_edges(graph: pg.PoseGraph, multiple: int) -> pg.PoseGraph:
    """Append masked identity edges (0, 1) up to a multiple of
    ``multiple`` edges."""
    e = graph.edge_i.shape[0]
    pad = -(-e // multiple) * multiple - e
    if pad == 0:
        return graph
    tcls, dof = pg._group(graph.poses)
    dim = graph.poses.t.shape[-1]
    dtype, dev = graph.poses.t.dtype, graph.poses.t.device

    def cat(x, fill):
        return torch.cat([x, fill.to(device=dev)])

    eye = torch.eye(dim, dtype=dtype).expand(pad, dim, dim)
    return pg.PoseGraph(
        poses=graph.poses,
        edge_i=cat(graph.edge_i, torch.zeros(pad, dtype=graph.edge_i.dtype)),
        edge_j=cat(graph.edge_j, torch.ones(pad, dtype=graph.edge_j.dtype)),
        meas=tcls(cat(graph.meas.rot, eye),
                  cat(graph.meas.t, torch.zeros((pad, dim), dtype=dtype))),
        info=cat(graph.info, torch.eye(dof, dtype=dtype).expand(pad, dof,
                                                                 dof)),
        edge_mask=cat(graph.edge_mask, torch.zeros(pad, dtype=torch.bool)),
    )


def _local_diag(g: pg.PoseGraph, ji, jj, w, p: int) -> Tensor:
    """This rank's edges' share of the block-Jacobi diagonal (P, dof,
    dof)."""
    dof = ji.shape[-1]
    wi = w[:, None, None]
    a_ii = wi * torch.einsum("eki,ekl,elj->eij", ji, g.info, ji)
    a_jj = wi * torch.einsum("eki,ekl,elj->eij", jj, g.info, jj)
    diag = torch.zeros((p, dof, dof), dtype=w.dtype, device=w.device)
    diag.index_add_(0, g.edge_i, a_ii)
    diag.index_add_(0, g.edge_j, a_jj)
    return diag


def optimize_distributed(graph: pg.PoseGraph, mesh, iters: int = 20,
                         cg_iters: int = 50, huber_k: float | None = None,
                         kernel: str = "huber", edge_axis: str = "dp",
                         delta_tol: float = 1e-10) -> pg.PoseGraph:
    """Edge-sharded GN + PCG over ``mesh``, on the mesh's device; every
    rank passes the whole graph and gets it back with the optimized poses.
    The result matches ``pose_graph.optimize(..., solve="cg")`` to
    floating-point roundoff (the sums are taken in another order)."""
    ax = axis(check_mesh(mesh), edge_axis)
    dev = mesh_device(mesh)
    out = pg.graph_to(graph, dev)
    graph = _pad_edges(out, ax.size)
    tcls, dof = pg._group(graph.poses)
    p = graph.poses.t.shape[0]
    dtype = graph.poses.t.dtype
    gauge = pg._gauge_prior(p, dof, dtype, dev)
    eye = 1e-8 * torch.eye(dof, dtype=dtype, device=dev)

    def local(x):
        return block(x, ax, 0)

    g = pg.PoseGraph(
        poses=graph.poses, edge_i=local(graph.edge_i),
        edge_j=local(graph.edge_j),
        meas=tcls(local(graph.meas.rot), local(graph.meas.t)),
        info=local(graph.info), edge_mask=local(graph.edge_mask))
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        # Once done, every later step is zeroed: stop (``done`` is
        # replicated, so the ranks agree).
        if bool(done):
            break
        r, ji, jj = pg.edge_residuals_and_jacobians(g)
        w = pg._edge_weights(r, g.info, g.edge_mask, huber_k, kernel)
        b = psum(pg._apply_b(g, r, ji, jj, w), ax.group)
        # The gauge prior belongs in the preconditioner too (see
        # pose_graph._block_jacobi_inv); it is the same on every rank.
        minv = torch.linalg.inv(psum(_local_diag(g, ji, jj, w, p), ax.group)
                                + torch.diag_embed(gauge.reshape(p, dof))
                                + eye)

        def hx(x, g=g, ji=ji, jj=jj, w=w):
            return psum(pg._apply_h(g, ji, jj, w, x), ax.group) + gauge * x

        def prec(x, minv=minv):
            return torch.einsum("pij,pj->pi", minv,
                                x.reshape(p, dof)).reshape(dof * p)

        # Every step all-reduces H @ x anyway, so the CG stops at its
        # converged step; ``active`` is replicated, so the ranks agree.
        delta = pg._pcg(hx, -b, prec, cg_iters, exit_early=True)
        stepped = tcls.from_twist(delta.reshape(p, dof))
        g = g._replace(poses=stepped.compose(g.poses))
        done = done | (torch.sum(delta * delta) < delta_tol)
    return out._replace(poses=g.poses)
