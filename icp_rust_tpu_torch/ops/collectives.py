"""The three collectives the sharded solvers use, on ``torch.distributed``:
``psum`` (``lax.psum``), ``all_gather_tiled`` (``lax.all_gather(...,
tiled=True)``) and ``ring_shift`` (``lax.ppermute`` to the next rank of
the group).

The transport follows the group's backend (``P2P_THROUGH_HOST``, the one
place it is stated): NCCL moves card tensors on the card.  Gloo reduces
and gathers card tensors itself, but its ``send``/``recv`` read host
memory only, so under gloo ``ring_shift`` stages a card tensor through a
host buffer; the searches and solves still run on the card.  A bool
tensor goes over the wire as uint8.

``group=None`` means an unsharded axis: ``psum`` and ``all_gather_tiled``
return ``x`` itself, so the solvers under ``ops/`` and ``models/`` call
them unconditionally.  ``CALLS`` counts this process's collectives by
name (one for each collective issued).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# Per backend: does point-to-point traffic of card tensors go through host
# buffers?
P2P_THROUGH_HOST = {"gloo": True, "nccl": False}

CALLS: collections.Counter = collections.Counter()


def transport(group) -> str:
    """One line saying how this group moves card tensors."""
    backend = dist.get_backend(group)
    ring = "through host buffers" if P2P_THROUGH_HOST[backend] \
        else "on the card"
    return (f"{backend}: all_reduce and all_gather on the tensors' device, "
            f"ring send/recv {ring}")


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, on every rank."""
    if group is None:
        return x
    CALLS["psum"] += 1
    out = _wire(x).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_tiled(x: torch.Tensor, group=None,
                     dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order, on
    every rank."""
    if group is None:
        return x
    CALLS["all_gather"] += 1
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` to the next rank of the group and return what the
    previous rank sent (group ranks, wrapping around)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    CALLS["ring_shift"] += 1
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    wire = _wire(x)
    if wire.is_cuda and P2P_THROUGH_HOST[dist.get_backend(group)]:
        wire = wire.cpu()
    got = torch.empty_like(wire)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, nxt, group),
            dist.P2POp(dist.irecv, got, prv, group)]):
        req.wait()
    got = got.to(x.device)
    return got.to(torch.bool) if x.dtype == torch.bool else got
