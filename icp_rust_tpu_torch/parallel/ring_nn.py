"""Ring-pass exact 1-NN over a destination cloud sharded across the ranks
of a group (JAX package ``parallel/ring_nn.py``).

Each rank holds its queries and one shard of the destination.  In n steps
every rank searches the resident shard, folds the result into a running
(best distance, best global index) carry and, between steps, passes the
shard to the next rank (``collectives.ring_shift``): after n - 1 shifts
every rank has seen the whole cloud while holding 1/n of it at a time.
After i shifts the resident shard is the one that started on rank
(my - i) mod n.  The fold is lexicographic on (distance, global index),
so ties go to the lowest global index, as in one search over the whole
cloud.  ``ring_nearest_neighbor_matched`` carries each shard's payload
rows with it and folds the winner's row into the carry, so the
destination is never gathered.

The per-shard search (``backend``): "cuda" runs the port's sweeps
(``nn_sweep_cuda.search``, routed as the TPU's ``nn_pallas`` /
``nn_pallas_matched``: kernel 6 for one cloud of at least 3 db tiles,
else kernel 4 with a payload and kernel 5 without), "torch" the plain
``nn_torch`` and a gather; "auto" takes "cuda" for card tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from icp_rust_tpu_torch.ops import nn_sweep_cuda
from icp_rust_tpu_torch.ops.nn import NNResult, gather_rows, nn_torch
from icp_rust_tpu_torch.parallel.collectives import ring_shift


def _resolve_backend(backend: str, query: Tensor) -> str:
    if backend != "auto":
        return backend
    return "cuda" if query.is_cuda else "torch"


def _shard_nn(query, db, dbm, payload, backend: str, tile: int):
    """(NNResult, payload rows of the winners or None) in the resident
    shard.  The card's sweeps stage the db in 128-point chunks, so there
    the tile rounds up to a multiple of 128 (the split of the work, not
    the result)."""
    if backend == "cuda":
        idx, d2, pay = nn_sweep_cuda.search(query, db, dbm, payload,
                                            db_tile=-(-tile // 128) * 128)
        return NNResult(index=idx, dist_sq=d2), pay
    res = nn_torch(query, db, dbm, tile=tile)
    return res, None if payload is None else gather_rows(payload,
                                                          res.index)


def _ring(query, db_shard, db_shard_mask, payload, group, tile: int,
          backend: str, matched: bool):
    """The ring shared by both entry points; returns (NNResult, the
    winners' payload rows or None).  Without a ``payload`` the matched
    ring's rows are the db points, which ride the ring anyway."""
    backend = _resolve_backend(backend, query)
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    m_local = db_shard.shape[-2]
    best_d = torch.full(query.shape[:-1], float("inf"), dtype=query.dtype,
                        device=query.device)
    best_i = torch.zeros(query.shape[:-1], dtype=torch.int32,
                         device=query.device)
    best_p = None
    if matched:
        like = db_shard if payload is None else payload
        best_p = torch.zeros((*query.shape[:-1], like.shape[-1]),
                             dtype=like.dtype, device=query.device)
    db, dbm, pay = db_shard, db_shard_mask, payload
    for i in range(n):
        rows = (db if pay is None else pay) if matched else None
        res, got = _shard_nn(query, db, dbm, rows, backend, tile)
        gidx = res.index + ((my - i) % n) * m_local
        better = (res.dist_sq < best_d) | ((res.dist_sq == best_d)
                                           & (gidx < best_i))
        best_d = torch.where(better, res.dist_sq, best_d)
        best_i = torch.where(better, gidx, best_i)
        if matched:
            best_p = torch.where(better[..., None], got, best_p)
        if i < n - 1:
            db, dbm = ring_shift(db, group), ring_shift(dbm, group)
            if pay is not None:
                pay = ring_shift(pay, group)
    return NNResult(index=best_i, dist_sq=best_d), best_p


def ring_nearest_neighbor(query: Tensor, db_shard: Tensor,
                          db_shard_mask: Tensor, group, tile: int = 2048,
                          backend: str = "auto") -> NNResult:
    """query (..., Q, D): this rank's queries; db_shard (..., M_local, D):
    its destination shard, with its mask.  Returns indices into the
    unsharded destination (the shards concatenated in group-rank order)
    and the squared distances."""
    return _ring(query, db_shard, db_shard_mask, None, group, tile,
                 backend, matched=False)[0]


def ring_nearest_neighbor_matched(query: Tensor, db_shard: Tensor,
                                  db_shard_mask: Tensor, group,
                                  tile: int = 2048, backend: str = "auto",
                                  payload: Tensor | None = None):
    """The ring that also carries the winner's ``payload`` row (..., M_local,
    P), by default the db point itself.  Returns (NNResult, matched (...,
    Q, P))."""
    return _ring(query, db_shard, db_shard_mask, payload, group, tile,
                 backend, matched=True)
