"""Chain-elimination Schur-complement solver for odometry pose graphs
(JAX package ``models/graph_schur.py``).

SLAM graphs built from odometry are a long chain (poses 0..P-1, edges
(k, k+1)) plus a handful of loop-closure edges.  Per Gauss-Newton
iteration the normal equations H delta = -b are solved exactly by
variable elimination:

1. **Skeleton** = pose 0 + every loop-closure endpoint + pose P-1 (+ a
   node every ``seg_cap`` poses).  The interior chain poses between
   consecutive skeleton nodes form independent segments whose H-blocks
   are block-tridiagonal.
2. **Forward elimination** (block Thomas) of each segment folds its
   blocks onto the two bounding skeleton nodes: a loop over the segment
   positions, each step a batch of dof x dof solves across all segments
   at once (the JAX package's ``lax.scan`` ``vmap``-ed across segments).
3. The reduced **skeleton system** (|S| x |S| blocks) is solved densely
   with pose 0 fixed (its rows and columns deleted).
4. **Back-substitution**, a reverse loop over the positions, recovers the
   interior updates.

The eliminated system is the exact Schur complement of the full normal
equations: the per-iteration delta equals the dense solve's to roundoff,
and the fixed point is ``pose_graph.optimize(solve="dense")``'s.  A pose
chain's normal equations have condition ~O(P^2), so use float64 graphs
(the SLAM pipelines build float64 graphs).  The segment layout depends
on the values of the edge lists and is computed on the host once per
graph (``_structure``).  ``run_slam2d``/``run_slam3d`` use the dense
solve, as in the JAX package.

With a ``mesh`` the segments shard over its ``seg_axis``: each rank
eliminates its contiguous block of segments (padded with empty ones to a
multiple of the axis size), the skeleton system's ``hs``/``bs`` and the
back-substituted ``delta`` are all-reduced, and the small skeleton solve
runs replicated: the distributed Schur-complement reduction.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.ops.collectives import psum
from icp_rust_tpu_torch.utils.profiling import annotate


def _structure(graph: pg.PoseGraph, seg_cap: int = 64):
    """Host-side segment layout as index arrays (everything downstream is
    gathers and scatters over all segments at once).

    Requires the odometry-chain convention of ``pg.odometry_chain_graph``:
    edge k < P-1 is (k, k+1); later edges are loop closures.

    ``seg_cap`` bounds segment length by inserting EXTRA skeleton nodes
    every seg_cap poses (nested dissection): the elimination stays exact
    under any ordering, but a long float32 chain loses digits to the
    chain system's O(L^2) conditioning, while segments of at most 64
    poses are float32-safe, and shorter segments are fewer loop steps."""
    p = int(graph.poses.t.shape[0])
    ei = graph.edge_i.cpu().numpy()
    ej = graph.edge_j.cpu().numpy()
    n_chain = p - 1
    if not (np.all(ei[:n_chain] == np.arange(n_chain))
            and np.all(ej[:n_chain] == np.arange(1, p))):
        raise ValueError(
            "graph_schur requires odometry_chain_graph layout "
            "(edges 0..P-2 = the chain)"
        )
    loop_edges = np.arange(n_chain, len(ei))
    base = sorted({0, p - 1} | set(ei[loop_edges].tolist())
                  | set(ej[loop_edges].tolist()))
    skel = set(base)
    for a, b in zip(base[:-1], base[1:]):
        skel.update(range(a + seg_cap, b, seg_cap))
    skel = sorted(skel)
    sidx = {q: i for i, q in enumerate(skel)}
    nseg = len(skel) - 1
    seg_a = np.asarray(skel[:-1], np.int32)
    seg_b = np.asarray(skel[1:], np.int32)
    n_int = seg_b - seg_a - 1
    max_len = int(n_int.max()) if nseg else 0
    ll = max(max_len, 1)
    t_idx = np.arange(ll)[None, :]
    valid = t_idx < n_int[:, None]                      # (nseg, L)
    seg_pose = np.where(valid, seg_a[:, None] + 1 + t_idx, 1)
    u_mask = t_idx < (n_int[:, None] - 1)
    seg_last_edge = np.where(n_int > 0, seg_a + n_int, seg_a)  # edge idx
    inner_pose = np.where(u_mask, seg_pose, p)          # p = slack row
    last_pose = np.where(n_int > 0, seg_a + n_int, p)
    return {
        "p": p, "skel": np.asarray(skel, np.int32),
        "ia": np.asarray([sidx[a] for a in seg_a], np.int32),
        "ib": np.asarray([sidx[b] for b in seg_b], np.int32),
        "seg_a": seg_a, "seg_last_edge": seg_last_edge,
        "has_int": n_int > 0, "n_int": n_int,
        "seg_pose": seg_pose.astype(np.int32), "valid": valid,
        "u_mask": u_mask, "inner_pose": inner_pose.astype(np.int32),
        "last_pose": last_pose.astype(np.int32),
        "max_len": max_len, "nseg": nseg,
        "loop_e": loop_edges.astype(np.int32),
        "loop_ia": np.asarray([sidx[int(ei[e])] for e in loop_edges],
                              np.int32),
        "loop_ib": np.asarray([sidx[int(ej[e])] for e in loop_edges],
                              np.int32),
    }


def _edge_blocks(graph: pg.PoseGraph, r, ji, jj, w):
    """Weighted per-edge H/b blocks (as in ``pose_graph._assemble_dense``)."""
    wi = w[:, None, None]
    info = graph.info
    a_ii = wi * torch.einsum("eki,ekl,elj->eij", ji, info, ji)
    a_jj = wi * torch.einsum("eki,ekl,elj->eij", jj, info, jj)
    a_ij = wi * torch.einsum("eki,ekl,elj->eij", ji, info, jj)
    b_i = w[:, None] * torch.einsum("eki,ekl,el->ei", ji, info, r)
    b_j = w[:, None] * torch.einsum("eki,ekl,el->ei", jj, info, r)
    return a_ii, a_jj, a_ij, b_i, b_j


def _mv(m, v):
    """Batched matrix-vector product (..., n, k) @ (..., k)."""
    return (m @ v[..., None])[..., 0]


def _where(mask, a, b):
    """``torch.where`` with a per-segment mask broadcast over a's
    trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


# Per-segment layout arrays and what a padded (empty) segment holds:
# nothing it contributes survives (valid, has and segv are False, its
# writes go to the slack row p).
_SEG_FIELDS = ("seg_pose", "valid", "u_mask", "seg_a", "seg_last_edge",
               "has_int", "ia", "ib", "inner_pose", "last_pose", "segv")


def _segments(st, shard=None):
    """The segment arrays, all of them or, with ``shard`` (rank, size),
    this rank's contiguous block after padding to a multiple of size."""
    seg = {k: st[k] for k in _SEG_FIELDS if k != "segv"}
    seg["segv"] = np.ones(st["nseg"], bool)
    if shard is None:
        return seg
    rank, size = shard
    pad = -(-st["nseg"] // size) * size - st["nseg"]
    fill = {"seg_pose": 1, "inner_pose": st["p"], "last_pose": st["p"]}
    out = {}
    for k, x in seg.items():
        x = np.concatenate([x, np.full((pad, *x.shape[1:]), fill.get(k, 0),
                                       x.dtype)])
        k_loc = x.shape[0] // size
        out[k] = x[rank * k_loc:(rank + 1) * k_loc]
    return out


def _solve_delta(graph: pg.PoseGraph, r, ji, jj, w, st, seg=None,
                 group=None) -> torch.Tensor:
    """Exact H delta = -b via chain elimination; returns delta (P, dof).
    ``seg``: the segments this call eliminates (``_segments``; default
    all); with a ``group`` each rank holds its block of them and the
    skeleton system and delta are all-reduced over the group."""
    dof = r.shape[-1]
    dev, dtype = r.device, r.dtype
    a_ii, a_jj, a_ij, b_i, b_j = _edge_blocks(graph, r, ji, jj, w)
    p, ns = st["p"], len(st["skel"])
    seg = _segments(st) if seg is None else seg

    def idx(name):
        src = seg if name in seg else st
        return torch.as_tensor(src[name], device=dev, dtype=torch.int64)

    def flag(name):
        return torch.as_tensor(seg[name], device=dev)

    eye = torch.eye(dof, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    sp, valid, u_mask = idx("seg_pose"), flag("valid"), flag("u_mask")
    seg_a, seg_e, has = idx("seg_a"), idx("seg_last_edge"), flag("has_int")
    ia, ib, segv = idx("ia"), idx("ib"), flag("segv")

    # Interior pose k has diagonal D = a_jj[k-1] + a_ii[k]; coupling to
    # pose k+1 is U = a_ij[k].  All (nseg, L, ...) by gathers.
    d_blk = torch.where(valid[..., None, None], a_jj[sp - 1] + a_ii[sp], eye)
    rhs = torch.where(valid[..., None], -(b_j[sp - 1] + b_i[sp]), zero)
    u_blk = torch.where(u_mask[..., None, None], a_ij[sp], zero)
    lcpl = _where(has, a_ij[seg_a].transpose(-1, -2), zero)
    rcpl = _where(has, a_ij[seg_e], zero)

    # Forward Thomas over every segment at once, position by position: the
    # carry is the propagated pivot, coupling to L, rhs and L's fill-in; a
    # masked position passes the carry through (the previous pivot, not
    # its identity padding).
    nseg, length = sp.shape
    dprev, cprev, bprev = d_blk[:, 0], lcpl, rhs[:, 0]
    hll = torch.zeros((nseg, dof, dof), dtype=dtype, device=dev)
    bl = torch.zeros((nseg, dof), dtype=dtype, device=dev)
    steps = []
    for k in range(1, length):
        d_k, u_k, b_k, v = d_blk[:, k], u_blk[:, k - 1], rhs[:, k], \
            valid[:, k]
        pinv = torch.linalg.inv(dprev)
        pu, pc, pb = pinv @ u_k, pinv @ cprev, _mv(pinv, bprev)
        ct, ut = cprev.transpose(-1, -2), u_k.transpose(-1, -2)
        hll_n, bl_n = hll - ct @ pc, bl - _mv(ct, pb)
        d_next, c_next, b_next = d_k - ut @ pu, -ut @ pc, b_k - _mv(ut, pb)
        dprev = _where(v, d_next, dprev)
        cprev = _where(v, c_next, cprev)
        bprev = _where(v, b_next, bprev)
        hll = _where(v, hll_n, hll)
        bl = _where(v, bl_n, bl)
        steps.append((pu, pc, pb, v))
    d_m, c_m, b_m = dprev, cprev, bprev
    pm_inv = torch.linalg.inv(d_m)

    # Skeleton assembly: eliminate each segment's last interior pose onto
    # (L, R); for an empty segment every eliminated quantity is zero and
    # the chain edge's own blocks flow through the same expressions.
    pc = pm_inv @ c_m
    pr = pm_inv @ rcpl
    pb = _mv(pm_inv, b_m)
    cmt, rt = c_m.transpose(-1, -2), rcpl.transpose(-1, -2)
    # A padded segment (segv False) contributes nothing.
    c_ll = _where(segv, a_ii[seg_a] + hll - cmt @ pc, zero)
    c_rr = _where(segv, a_jj[seg_e] - rt @ pr, zero)
    c_lr = _where(segv, _where(has, -cmt @ pr, a_ij[seg_a]), zero)
    c_rl = _where(segv, _where(has, -rt @ pc,
                               a_ij[seg_a].transpose(-1, -2)), zero)
    v_l = _where(segv, -b_i[seg_a] + bl - _mv(cmt, pb), zero)
    v_r = _where(segv, -b_j[seg_e] - _mv(rt, pb), zero)

    hs = torch.zeros((ns, dof, ns, dof), dtype=dtype, device=dev)
    bs = torch.zeros((ns, dof), dtype=dtype, device=dev)
    blocks = [(ia, ia, c_ll), (ib, ib, c_rr), (ia, ib, c_lr), (ib, ia, c_rl)]
    rows = [(ia, v_l), (ib, v_r)]
    for i, j, blk in blocks:
        hs.index_put_(pg._block_index(i, j, dof), blk, accumulate=True)
    for i, v in rows:
        bs.index_add_(0, i, v)
    hs, bs = psum(hs, group), psum(bs, group)
    if len(st["loop_e"]):
        # Loop-closure edges: both endpoints are skeleton nodes (the same
        # on every rank).
        le, lia, lib = idx("loop_e"), idx("loop_ia"), idx("loop_ib")
        for i, j, blk in [(lia, lia, a_ii[le]), (lib, lib, a_jj[le]),
                          (lia, lib, a_ij[le]),
                          (lib, lia, a_ij[le].transpose(-1, -2))]:
            hs.index_put_(pg._block_index(i, j, dof), blk, accumulate=True)
        bs.index_add_(0, lia, -b_i[le])
        bs.index_add_(0, lib, -b_j[le])
    # Hard gauge: delta_0 = 0 by deleting pose 0's rows and columns
    # (skel[0] is pose 0); a soft 1e8 prior would wreck the skeleton
    # system's conditioning.
    n = (ns - 1) * dof
    hs_flat = (hs.reshape(ns * dof, ns * dof)[dof:, dof:]
               + 1e-10 * torch.eye(n, dtype=dtype, device=dev))
    x_rest = torch.linalg.solve(hs_flat, bs.reshape(ns * dof)[dof:])
    x_s = torch.cat([torch.zeros(dof, dtype=dtype, device=dev),
                     x_rest]).reshape(ns, dof)

    # Back-substitution, every segment at once, last position first.
    xl, xr = x_s[ia], x_s[ib]
    x_next = _mv(pm_inv, b_m - _mv(c_m, xl) - _mv(rcpl, xr))
    x_last = x_next
    x_inner = [None] * len(steps)
    for k in range(len(steps) - 1, -1, -1):
        pu, pc, pb, v = steps[k]
        x_k = pb - _mv(pu, x_next) - _mv(pc, xl)
        x_inner[k] = _where(v, x_k, 0.0 * x_k)
        x_next = _where(v, x_k, x_next)

    # Row p is a slack target for the padded positions' writes.
    delta = torch.zeros((p + 1, dof), dtype=dtype, device=dev)
    if x_inner:
        inner = idx("inner_pose")[:, :-1]
        delta[inner.reshape(-1)] = torch.stack(x_inner, 1).reshape(-1, dof)
    delta[idx("last_pose")] = x_last
    delta = psum(delta, group)
    delta[idx("skel")] = x_s
    return delta[:p]


def optimize_schur(graph: pg.PoseGraph, iters: int = 20,
                   huber_k: float | None = None, kernel: str = "huber",
                   delta_tol: float = 1e-10, mesh=None,
                   seg_axis: str = "dp") -> pg.PoseGraph:
    """Gauss-Newton with the chain-elimination Schur solve per iteration,
    on the graph's device.

    The same fixed point as ``pose_graph.optimize(solve="dense")`` (the
    linear solves are exact); each iteration is one loop over segment
    positions plus a dense solve of the small loop-closure skeleton.  All
    ``iters`` steps run, the step zeroed once converged, as in
    ``pose_graph.optimize``.  The graph must have
    ``pose_graph.odometry_chain_graph``'s layout (ValueError otherwise).
    With a ``mesh`` (a ``DeviceMesh``; TypeError otherwise) the segments
    shard over ``seg_axis`` and the solve runs on the mesh's device; every
    rank passes the whole graph and gets the same result.

    Spans as ``pose_graph.optimize``'s, except that the per-edge blocks are
    assembled inside the elimination, so ``icp.graph_solve`` holds the
    assembly too and no ``icp.graph_assemble`` opens."""
    with annotate("icp.pose_graph"):
        st = _structure(graph)
        seg, group = None, None
        if mesh is not None:
            from icp_rust_tpu_torch.parallel.mesh import axis, check_mesh, \
                mesh_device

            ax = axis(check_mesh(mesh), seg_axis)
            graph = pg.graph_to(graph, mesh_device(mesh))
            seg, group = _segments(st, (ax.rank, ax.size)), ax.group
        tcls, _ = pg._group(graph.poses)
        g = graph
        done = torch.zeros((), dtype=torch.bool, device=graph.poses.t.device)
        for _ in range(iters):
            with annotate("icp.graph_linearize"):
                r, ji, jj = pg.edge_residuals_and_jacobians(g)
                w = pg._edge_weights(r, g.info, g.edge_mask, huber_k, kernel)
            with annotate("icp.graph_solve"):
                delta = _solve_delta(g, r, ji, jj, w, st, seg, group)
                pg.SOLVES["graph_solves"] += 1
                g, done = pg._retract(g, tcls, delta, done, delta_tol)
        return g
