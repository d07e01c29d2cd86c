"""Exact 1-nearest-neighbor correspondence search.

Replacement for the reference's KdTree dependency (exact 1-NN, used at
src/lib.rs:99,121,141,164).  Distances use direct squared differences,
not the |s|^2+|d|^2-2 s.d identity, whose cancellation would corrupt the
argmin in f32.  Tie-break: the lowest database index.

Backends (config.nn_backend):
- ``"torch"``: ``nn_torch``, a tiled sweep over the db with a running
  (best distance, best index) carry, on any device;
- ``"cuda"``: the hand-written kernels, their plain versions on a CPU
  tensor.  Matched searches: the survivor-list kernel of
  ``ops/nn_cuda.py`` over a Morton-sorted, packed db for one seeded query
  cloud; for a batch of queries (B, Q, D) against dbs of at most 4096
  points the pair-grid kernels of ``ops/nn_pairs_cuda.py``
  (``use_pairs_nn``); the sweeps of ``ops/nn_sweep_cuda.py`` for the rest
  (kernel 4 for a batch or a db of fewer than 3 tiles, kernel 6 unseeded
  or with a wide payload).  ``nearest_neighbor``: kernel 6 for one cloud
  of 3 tiles or more, kernel 5 otherwise;
- ``"auto"``: ``"cuda"`` for float32, ``"torch"`` for float64 (the f64
  reference path is the plain one, as on the TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import nn_cuda, nn_pairs_cuda, nn_sweep_cuda


class NNResult(NamedTuple):
    index: Tensor    # (..., Q) int32: argmin into the database axis
    dist_sq: Tensor  # (..., Q) squared distance (+inf where db fully masked)


def nn_torch(query: Tensor, db: Tensor, db_mask: Tensor | None = None,
             tile: int = 2048) -> NNResult:
    """Tiled brute-force exact 1-NN (the ``nn_xla`` counterpart).

    query: (..., Q, D); db: (..., M, D), or a shared (M, D); db_mask:
    (..., M) or None.  Within a tile the first minimum wins; across tiles
    the carry update is a strict '<', so the lowest index wins ties
    overall."""
    q_n, d = query.shape[-2:]
    m = db.shape[-2]
    if db_mask is None:
        db_mask = torch.ones(db.shape[:-1], dtype=torch.bool,
                             device=db.device)
    batch = torch.broadcast_shapes(query.shape[:-2], db.shape[:-2],
                                   db_mask.shape[:-1])
    tile = min(tile, max(m, 1))
    best_d = torch.full((*batch, q_n), float("inf"), dtype=query.dtype,
                        device=query.device)
    best_i = torch.zeros((*batch, q_n), dtype=torch.int32,
                         device=query.device)
    inf = torch.tensor(float("inf"), dtype=query.dtype, device=query.device)
    for start in range(0, m, tile):
        tdb = db[..., start:start + tile, :]
        dist = torch.zeros((*batch, q_n, tdb.shape[-2]), dtype=query.dtype,
                           device=query.device)
        for k in range(d):
            diff = query[..., :, k, None] - tdb[..., None, :, k]
            dist = dist + diff * diff
        dist = torch.where(db_mask[..., None, start:start + tile], dist, inf)
        local_d, local_i = torch.min(dist, dim=-1)
        better = local_d < best_d
        best_d = torch.where(better, local_d, best_d)
        best_i = torch.where(better, (local_i + start).to(torch.int32),
                             best_i)
    return NNResult(index=best_i, dist_sq=best_d)


def azimuth_order(points: Tensor, mask: Tensor | None = None) -> Tensor:
    """Permutation sorting points by azimuth atan2(y, x), masked last."""
    az = torch.atan2(points[..., 1], points[..., 0])
    if mask is not None:
        az = torch.where(mask, az, torch.full_like(az, float("inf")))
    return torch.argsort(az, dim=-1, stable=True).to(torch.int32)


def _spread_bits10(v: Tensor) -> Tensor:
    """abcdefghij -> a0b0c0d0e0f0g0h0i0j (Morton component), int32."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_order(points: Tensor, mask: Tensor | None = None) -> Tensor:
    """Permutation sorting points along a 2D Morton (Z-order) curve on
    (x, y), masked points last (stable, so their order is deterministic).
    Z-order buckets are compact 2D patches, which is what makes the
    survivor lists short."""
    x, y = points[..., 0], points[..., 1]

    def _q10(v):
        lo = torch.amin(v, dim=-1, keepdim=True)
        hi = torch.amax(v, dim=-1, keepdim=True)
        t = (v - lo) / torch.clamp(hi - lo, min=1e-30)
        return torch.clamp((t * 1023.0).to(torch.int32), 0, 1023)

    code = _spread_bits10(_q10(x)) | (_spread_bits10(_q10(y)) << 1)
    if mask is not None:
        code = torch.where(mask, code,
                           torch.full_like(code, torch.iinfo(torch.int32).max))
    return torch.argsort(code, dim=-1, stable=True).to(torch.int32)


def spatial_order(points: Tensor, mask: Tensor | None = None,
                  method: str = "morton") -> Tensor:
    """Dispatch to the configured spatial pre-sort (config.nn_sort)."""
    if method == "azimuth":
        return azimuth_order(points, mask)
    if method == "morton":
        return morton_order(points, mask)
    raise ValueError(f"unknown spatial sort method: {method!r}")


def use_cuda_nn(query: Tensor, db: Tensor, backend: str = "auto") -> bool:
    """Resolve the NN backend (mirrors ``use_pallas_nn``): the kernel path
    for "cuda", and for "auto" on float32."""
    if backend == "cuda":
        return True
    return backend == "auto" and query.dtype == torch.float32


def use_pairs_nn(query: Tensor, db: Tensor, backend: str = "auto") -> bool:
    """The pair-grid dispatch (mirrors ``use_pairs_nn``): a batched query
    (B, Q, D) on the kernel route against dbs of at most
    ``nn_pairs_cuda.PAIRS_MAX_DB`` points.  Shared by
    ``nearest_neighbor_matched`` and the drivers' pre-sort policy, so the
    two always agree."""
    return (query.ndim == 3 and db.shape[-2] <= nn_pairs_cuda.PAIRS_MAX_DB
            and use_cuda_nn(query, db, backend))


def _gather_rows(payload: Tensor, index: Tensor) -> Tensor:
    """payload[..., index, :] per batch lane; a shared (M, P) payload is
    broadcast to the index's batch."""
    idx = index.to(torch.int64)
    if idx.ndim == 1:
        return payload[idx]
    payload = payload.expand(*idx.shape[:-1], *payload.shape[-2:])
    return torch.take_along_dim(payload, idx[..., None], dim=-2)


def build_db_pack(query: Tensor, db: Tensor, db_mask=None, payload=None,
                  backend: str = "auto", tile: int = 2048):
    """Per-frame NN index build, the KdTree::new analogue (reference
    src/lib.rs:97-102): the packed db of ``nn_cuda.pack_db`` when the
    seeded survivor-list kernel serves (query, db), else None (a batch, a
    db of fewer than 3 tiles or a payload wider than 8 - D)."""
    if (query.ndim != 2 or not use_cuda_nn(query, db, backend)
            or use_pairs_nn(query, db, backend)):
        return None
    p = payload.shape[-1] if payload is not None else db.shape[-1]
    if db.shape[-1] + p > 8 or -(-db.shape[-2] // tile) < 3:
        return None
    return nn_cuda.pack_db(db, db_mask, payload, db_tile=tile)


def nearest_neighbor(query: Tensor, db: Tensor, db_mask=None,
                     backend: str = "auto", tile: int = 2048,
                     q_tile: int = 512) -> NNResult:
    """Exact 1-NN without payload (``ops/nn.nearest_neighbor``): on the
    kernel route kernel 6 for one cloud whose db spans 3 tiles or more,
    kernel 5 otherwise (``nn_sweep_cuda.search``); a batched query against
    dbs of at most 4096 points takes the plain sweep on "auto", where the
    TPU takes ``nn_xla`` (batched small)."""
    batched_small = query.ndim > 2 and db.shape[-2] <= 4096
    if backend == "cuda" or (use_cuda_nn(query, db, backend)
                             and not batched_small):
        idx, dist, _ = nn_sweep_cuda.search(query, db, db_mask, None, q_tile,
                                            tile)
        return NNResult(index=idx, dist_sq=dist)
    return nn_torch(query, db, db_mask, tile=tile)


def nearest_neighbor_matched(query: Tensor, db: Tensor, db_mask=None,
                             payload=None, backend: str = "auto",
                             tile: int = 2048, q_tile: int = 256,
                             q_bound: Tensor | None = None, db_pack=None,
                             warm: bool | None = None):
    """1-NN that also returns the winner's payload (default: the matched
    db point).  Returns (NNResult, matched (Q, P)).

    On the kernel route ``q_bound`` (..., Q) is an upper bound on each
    query's NN distance² (+inf where unknown) and ``warm`` selects the
    seeded search's cold/warm branch (None decides from the bounds);
    results are bit-identical whatever they are, as long as the bounds are
    valid.  Routes, as ``nn_pallas_matched`` takes them on the TPU: a
    batched query (B, Q, D) against dbs of at most 4096 points takes the
    pair-grid kernels (``use_pairs_nn``); any other batch and any db of
    fewer than 3 tiles the plain sweep (kernel 4); a seeded single cloud
    with D + P <= 8 the survivor-list kernel; an unseeded or wide one the
    zig-zag kernel (kernel 6)."""
    if payload is None:
        payload = db
    if not use_cuda_nn(query, db, backend):
        res = nn_torch(query, db, db_mask, tile=tile)
        return res, _gather_rows(payload, res.index)
    if use_pairs_nn(query, db, backend):
        idx, dist, matched = nn_pairs_cuda.nn_pairs_matched(
            query, db, db_mask, payload, q_bound=q_bound, warm=warm)
        return NNResult(index=idx, dist_sq=dist), matched
    dbf_cm = None if db_pack is None else db_pack.dbf_cm
    seeded = (query.ndim == 2 and q_bound is not None
              and query.shape[-1] + payload.shape[-1] <= 8
              and -(-db.shape[-2] // tile) >= 3)
    if not seeded:
        idx, dist, pay = nn_sweep_cuda.search(query, db, db_mask, payload,
                                              q_tile, tile, q_bound, dbf_cm)
        return NNResult(index=idx, dist_sq=dist), pay
    q_n, d_dim = query.shape
    if db_pack is None:
        db_pack = nn_cuda.pack_db(db, db_mask, payload, db_tile=tile)
    q_pad = -(-q_n // q_tile) * q_tile
    query_p = torch.zeros((q_pad, d_dim), dtype=query.dtype,
                          device=query.device)
    query_p[:q_n] = query
    # Padded queries get -inf: their (discarded) results may then prune
    # everything.
    qb_p = torch.full((q_pad,), float("-inf"), dtype=query.dtype,
                      device=query.device)
    qb_p[:q_n] = q_bound.to(query.dtype)
    dist, idx, pay = nn_cuda.nn_seeded(query_p, db_pack, qb_p, d_dim,
                                       q_tile, warm=warm)
    dist = nn_cuda._trim_sentinel(dist)
    return NNResult(index=idx[:q_n], dist_sq=dist[:q_n]), pay[:q_n]
