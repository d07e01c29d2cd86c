"""Survivor-list exact 1-NN: the hand-written kernel ``csrc/nn_list.cu``,
its wrapper, its plain PyTorch version, and the torch code around it.

Counterpart of icp_rust_tpu/ops/nn_pallas.py's seeded path
(``_nn_seeded_2d`` -> ``_nn_list_kernel``).  Per query tile of ``q_tile``
queries the kernel walks only the 128-point db chunks whose box lower
bound does not exceed the tile's upper bound on its queries' NN distance²
(ascending chunk order, strict '<'), or every chunk when more than
``cap`` survive.  Exactness: a chunk is left out only if no point in it
can be in any of the tile's queries' final tie sets, so the result is
bit-identical to the unpruned sweep, lowest index winning ties.

The TPU kernel kept its lists in scalar-prefetch SMEM and so capped them
at 48 chunks; ``nn_seeded`` lists every survivor (``cap = n_chunks``), so
no tile falls back to the full sweep.  The kernel cuts each tile's walk
into work items of ``ITEM_CHUNKS`` consecutive entries, one block each,
and merges a tile's partials in item order (``work_items`` is its
schedule; ``csrc/nn_list.cu``).

The db preparation (``pack_db``), the cold-iteration bound
(``_center_bound``) and the survivor-list build are plain torch code
here, copied op for op from the JAX package with its one-sided margins
(lower bounds deflated by 1-16eps, bounds inflated by 1+8eps and
1+32eps): a bound that is too loose only costs speed, one that is too
tight would break exactness.

The JAX package's TPU-specific chunk-sublane db layout is not needed: the
kernel reads the coordinate-major ``dbf_cm`` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import cuda_build

# Coordinate written into masked/padded db points.  In f32 the squared
# distance to any real query overflows to +inf on its own; _trim_sentinel
# makes the same contract hold in f64, where (3e19)^2 is finite.
_SENTINEL = 3e19
_CHUNK = 128
_LIST_GROUPS = 4
# Chunks per work item of the nn_list kernel: the longest block's walk.
ITEM_CHUNKS = 4
# Per device, the kernel's per-tile tickets: zero between launches (the
# merging block resets its tile's), so no call clears them.  Calls on one
# device share them, as they share its stream.
_TICKETS: dict = {}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _trim_sentinel(dist_sq: Tensor) -> Tensor:
    lim = torch.tensor(_SENTINEL, dtype=dist_sq.dtype,
                       device=dist_sq.device) ** 2 / 4
    return torch.where(dist_sq >= lim, torch.full_like(dist_sq, float("inf")),
                       dist_sq)


def _dbf_cm_matched(db: Tensor, db_mask, payload: Tensor, m_pad: int):
    """Sentinel-padded coordinate-major [db; payload] rows
    (..., F_total, m_pad) of db (..., M, D) and payload (..., M, P).
    Payload rows are not sentinel-masked: masked points never win."""
    if db_mask is not None:
        db = torch.where(db_mask[..., None], db,
                         torch.tensor(_SENTINEL, dtype=db.dtype,
                                      device=db.device))
    *batch, m, d = db.shape
    out = torch.zeros((*batch, d + payload.shape[-1], m_pad), dtype=db.dtype,
                      device=db.device)
    out[..., :d, :] = _SENTINEL
    out[..., :d, :m] = db.transpose(-1, -2)
    out[..., d:, :m] = payload.transpose(-1, -2)
    return out


def _tile_boxes(cm: Tensor, tile: int) -> Tensor:
    """Per-tile coordinate bounds of a sentinel-padded coordinate-major
    cloud (d, M) -> (M//tile, 8): cols 0..3 lo (+inf for an all-sentinel
    tile), cols 4..7 hi (-inf likewise); unused dims are 0."""
    d, m = cm.shape
    t = cm.reshape(d, m // tile, tile)
    valid = t[0] < _SENTINEL / 2
    inf = torch.tensor(float("inf"), dtype=cm.dtype, device=cm.device)
    lo = torch.amin(torch.where(valid[None], t, inf), dim=-1)   # (d, n)
    hi = torch.amax(torch.where(valid[None], t, -inf), dim=-1)  # (d, n)
    out = torch.zeros((m // tile, 8), dtype=cm.dtype, device=cm.device)
    out[:, :d] = lo.T
    out[:, 4:4 + d] = hi.T
    return out


class PackedDB(NamedTuple):
    """Loop-invariant NN db preparation, the KdTree-build analogue
    (reference src/lib.rs:97-102 builds its tree once per frame).

    dbf_cm (F_total, m_pad): sentinel-padded coordinate-major db+payload;
    cbox (n_chunks, 8): per-128-point-chunk coordinate bounds."""

    dbf_cm: Tensor
    cbox: Tensor


def pack_db(db: Tensor, db_mask=None, payload=None,
            db_tile: int = 2048) -> PackedDB:
    """Build the loop-invariant NN index over ``db`` (see PackedDB);
    ``payload`` defaults to the db points themselves."""
    if payload is None:
        payload = db
    m_pad = _round_up(db.shape[-2], db_tile)
    dbf_cm = _dbf_cm_matched(db, db_mask, payload, m_pad)
    return PackedDB(dbf_cm=dbf_cm,
                    cbox=_tile_boxes(dbf_cm[:db.shape[-1]], _CHUNK))


def _center_bound(query_p: Tensor, cbox: Tensor, d_dim: int) -> Tensor:
    """Cold-iteration upper bound on each query's NN distance² from the
    chunk boxes alone: dist(q, p) <= dist(q, center) + half-diagonal for
    every point p of a chunk, and a chunk with only valid points holds a
    legal candidate.  Chunks with sentinel lanes have ~1e30 half-diagonals
    and exclude themselves; all-padding chunks are forced to +inf."""
    lo = cbox[None, :, :d_dim]
    hi = cbox[None, :, 4:4 + d_dim]
    empty = lo > hi
    zero = torch.zeros((), dtype=cbox.dtype, device=cbox.device)
    lo = torch.where(empty, zero, lo)
    hi = torch.where(empty, zero, hi)
    center = 0.5 * (lo + hi)
    half_diag = 0.5 * torch.sqrt(torch.sum((hi - lo) * (hi - lo), dim=-1))
    d2 = torch.sum((query_p[:, None, :d_dim] - center) ** 2, dim=-1)
    eps = torch.finfo(d2.dtype).eps
    b = (torch.sqrt(d2) * (1.0 + 8.0 * eps) + half_diag) ** 2
    b = torch.where(torch.any(empty, dim=-1),
                    torch.full_like(b, float("inf")), b)
    return torch.amin(b, dim=1) * (1.0 + 32.0 * eps)


def _survivor_lists(query_p: Tensor, cbox: Tensor, q_bound: Tensor,
                    d_dim: int, q_tile: int, cap: int):
    """Per query tile, the ascending ids of the chunks whose (deflated)
    box lower bound is <= the tile's bound, tested per group of
    q_tile/4 consecutive queries and unioned; tails padded with the first
    listed chunk.  Returns (lists (n_q, cap) int32, cnt (n_q,) int32)."""
    n_q = query_p.shape[0] // q_tile
    n_chunks = cbox.shape[0]
    grp = _LIST_GROUPS if q_tile % _LIST_GROUPS == 0 else 1
    qg = query_p.reshape(n_q * grp, q_tile // grp, d_dim)
    qlo = torch.amin(qg, dim=1)
    qhi = torch.amax(qg, dim=1)
    a = cbox[None, :, :d_dim] - qhi[:, None, :]
    b = qlo[:, None, :] - cbox[None, :, 4:4 + d_dim]
    g = torch.clamp(torch.maximum(a, b), min=0.0)
    lb = torch.sum(g * g, dim=-1)
    lb = lb * (1.0 - 16.0 * torch.finfo(lb.dtype).eps)
    qbt = torch.amax(q_bound.reshape(n_q * grp, q_tile // grp), dim=1)
    ok = torch.any((lb <= qbt[:, None]).reshape(n_q, grp, n_chunks), dim=1)
    cnt = torch.sum(ok, dim=1).to(torch.int32)
    ids = torch.arange(n_chunks, dtype=torch.int32, device=cbox.device)
    key = torch.where(ok, ids[None, :], torch.full_like(ids, n_chunks))
    srt = torch.sort(key, dim=1).values[:, :cap]
    pos = torch.arange(cap, dtype=torch.int32, device=cbox.device)[None, :]
    lists = torch.where(pos < cnt[:, None], srt, srt[:, :1])
    return lists.to(torch.int32).contiguous(), cnt.contiguous()


def nn_list_plain(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                  cnt: Tensor, d_dim: int, q_tile: int, cap: int):
    """Plain PyTorch version of the nn_list kernel: per query tile, the
    exact 1-NN over the listed chunks' points (all chunks when cnt > cap),
    lowest index winning ties; (+inf, 0, 0) when nothing is valid.
    Returns (dist (Qp,), idx (Qp,) int32, pay (Qp, F))."""
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    n_chunks = dbf_cm.shape[1] // _CHUNK
    dev, dt = query_p.device, query_p.dtype
    dist = torch.full((qp,), float("inf"), dtype=dt, device=dev)
    idx = torch.zeros((qp,), dtype=torch.int32, device=dev)
    pay = torch.zeros((qp, f_dim), dtype=dt, device=dev)
    lane = torch.arange(_CHUNK, dtype=torch.int64, device=dev)
    cnt_h = cnt.cpu().tolist()
    for i, c in enumerate(cnt_h):
        if c > cap:
            ids = torch.arange(n_chunks, dtype=torch.int64, device=dev)
        elif c == 0:
            continue
        else:
            ids = lists[i, :c].to(torch.int64)
        pidx = (ids[:, None] * _CHUNK + lane[None, :]).reshape(-1)
        pts = dbf_cm[:, pidx]
        q = query_p[i * q_tile:(i + 1) * q_tile]
        d = None
        for k in range(d_dim):
            diff = q[:, k:k + 1] - pts[k][None, :]
            sq = diff * diff
            d = sq if d is None else d + sq
        best, arg = torch.min(d, dim=1)
        hit = best != float("inf")
        win = pidx[arg]
        sl = slice(i * q_tile, (i + 1) * q_tile)
        dist[sl] = best
        idx[sl] = torch.where(hit, win, torch.zeros_like(win)).to(torch.int32)
        pay[sl] = torch.where(hit[:, None], pts[d_dim:, arg].T,
                              torch.zeros((), dtype=dt, device=dev))
    return dist, idx, pay


def work_items(cnt: Tensor, cap: int, n_chunks: int,
               item: int = ITEM_CHUNKS) -> Tensor:
    """The nn_list kernel's schedule: each tile's walk (its first cnt list
    entries, or every chunk when cnt > cap) cut into items of at most
    ``item`` consecutive entries.  Returns (tile, begin, end) int64 rows,
    by tile, then by begin; a tile with an empty walk has none."""
    walk = torch.where(cnt > cap, n_chunks, cnt).to(torch.int64).cpu()
    n_items = (walk + item - 1) // item
    tile = torch.repeat_interleave(torch.arange(walk.shape[0]), n_items)
    first = torch.cumsum(n_items, 0) - n_items
    begin = (torch.arange(tile.shape[0]) - first[tile]) * item
    end = torch.minimum(walk[tile], begin + item)
    return torch.stack([tile, begin, end], dim=1)


def walk_stats(cnt: Tensor, cap: int, n_chunks: int,
               item: int = ITEM_CHUNKS) -> dict:
    """What one nn_list call walks (a host read; for reports): chunk-walks
    over all tiles, work items, the longest block's chunks, tiles on the
    full sweep, and the blocks the grid launches."""
    items = work_items(cnt, cap, n_chunks, item)
    span = items[:, 2] - items[:, 1]
    return dict(chunk_walks=int(span.sum()), items=int(items.shape[0]),
                longest=int(span.max()) if items.shape[0] else 0,
                full_sweeps=int((cnt > cap).sum()),
                blocks=cnt.shape[0] * -(-max(n_chunks, cap) // item))


def _nn_list_args(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                  cnt: Tensor, d_dim: int, q_tile: int, cap: int,
                  item: int = ITEM_CHUNKS):
    """Check the CUDA inputs of the nn_list kernel and allocate its
    outputs and scratch.  Returns (the launcher's arguments, (dist, idx,
    pay), the scratch, which the caller holds until the launch is
    enqueued)."""
    for name, x, dt in (("query", query_p, torch.float32),
                        ("dbf_cm", dbf_cm, torch.float32),
                        ("lists", lists, torch.int32),
                        ("cnt", cnt, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"nn_list: {name} must be {dt}, got {x.dtype}")
        if x.device != query_p.device or not x.is_contiguous():
            raise ValueError(f"nn_list: {name} must be contiguous on "
                             f"{query_p.device}")
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    m_pad = dbf_cm.shape[1]
    if (qp % q_tile or q_tile % 32 or q_tile > 1024 or m_pad % _CHUNK
            or query_p.shape[1] != d_dim or lists.shape[1] != cap
            or dbf_cm.data_ptr() % 16):
        raise ValueError("nn_list: bad shapes (or dbf_cm not 16-byte "
                         "aligned)")
    dev = query_p.device
    n_tiles = qp // q_tile
    grid_y = -(-max(m_pad // _CHUNK, cap) // item)
    tickets = _TICKETS.get(dev)
    if tickets is None or tickets.shape[0] < n_tiles:
        tickets = _TICKETS[dev] = torch.zeros(max(n_tiles, 1024),
                                              dtype=torch.int32, device=dev)
    part = torch.empty(n_tiles * grid_y * (2 + f_dim) * q_tile,
                       dtype=torch.float32, device=dev)
    dist = torch.empty((qp,), dtype=torch.float32, device=dev)
    idx = torch.empty((qp,), dtype=torch.int32, device=dev)
    pay = torch.empty((qp, f_dim), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (query_p.data_ptr(), dbf_cm.data_ptr(), lists.data_ptr(),
            cnt.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            pay.data_ptr() if f_dim else None, part.data_ptr(),
            tickets.data_ptr(), n_tiles, q_tile, d_dim, f_dim, m_pad, cap,
            item, stream)
    return args, (dist, idx, pay), part


def nn_list(query_p: Tensor, dbf_cm: Tensor, lists: Tensor, cnt: Tensor,
            d_dim: int, q_tile: int, cap: int):
    """Survivor-list 1-NN: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  query_p (Qp, D) with Qp a multiple of q_tile;
    dbf_cm (D + F, m_pad); lists (Qp/q_tile, cap) int32; cnt (Qp/q_tile,)
    int32.  Returns (dist, idx, pay) before sentinel trimming."""
    if query_p.device.type == "cpu":
        return nn_list_plain(query_p, dbf_cm, lists, cnt, d_dim, q_tile,
                             cap)
    if query_p.device.type != "cuda":
        raise ValueError(f"nn_list: unsupported device {query_p.device}")
    args, out, _part = _nn_list_args(query_p, dbf_cm, lists, cnt, d_dim,
                                     q_tile, cap)
    status = cuda_build.launcher("nn_list")(*args)
    cuda_build.LAUNCHES["nn_list"] += 1
    cuda_build.check(status, "nn_list")
    return out


def nn_seeded(query_p: Tensor, pack: PackedDB, q_bound: Tensor, d_dim: int,
              q_tile: int, warm: bool | None = None):
    """Warmth-dispatched survivor-list NN (``_nn_seeded_2d``): finite
    seeds take the list built from ``q_bound``; iteration 1 (+inf bounds)
    takes one built from the chunk-center bound.  ``warm`` selects the
    branch statically (None decides from the bounds); exactness never
    depends on it.  The lists hold every survivor (no cap)."""
    cap = pack.dbf_cm.shape[1] // _CHUNK
    if warm is None:
        warm = bool(torch.any(torch.isfinite(q_bound)))
    qb = q_bound if warm else _center_bound(query_p, pack.cbox, d_dim)
    lists, cnt = _survivor_lists(query_p, pack.cbox, qb, d_dim, q_tile, cap)
    return nn_list(query_p.contiguous(), pack.dbf_cm, lists, cnt, d_dim,
                   q_tile, cap)
