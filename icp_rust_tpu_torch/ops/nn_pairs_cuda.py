"""Pair-grid exact 1-NN for many small pairs: the hand-written kernels
``csrc/nn_pairs.cu`` (static sweep) and ``csrc/nn_pairs_list.cu``
(survivor lists), their wrappers, their plain PyTorch versions, and the
torch code around them.

Counterpart of icp_rust_tpu/ops/nn_pallas.py's pair-grid path
(``nn_pallas_matched_pairs`` -> ``_nn_pairs_kernel`` on the cold ICP
iteration, ``_nn_pairs_list_kernel`` on every warm one).  B queries
(B, Nq, D) against B dbs (B, M, D), per (pair, 256-query subtile),
walking the pair's 128-point chunks in ascending order with a strict '<':
the lowest index wins ties.  Dbs of at most ``PAIRS_MAX_DB`` points take
both kernels; larger ones the static sweep alone, on the warm searches of
a batched ICP call over Morton-sorted dbs (``ops/nn.route``), where the
seeds prune most chunks.

Pruning is seed-only and exact: chunk c is skipped for a subtile when the
(deflated) box-to-box lower bound exceeds the subtile's upper bound on
its queries' NN distance², which the ICP outer loop seeds from the
previous iteration (dist_new <= dist_prev + |dq|).  A skipped chunk holds
no point of any query's tie set, so results are bit-identical to the
unpruned sweep.

- Static sweep (kernel 8): the prune test per (subtile, chunk) runs in
  the kernel, from per-chunk boxes, per-subtile query boxes and
  per-subtile bounds; on the cold iteration every bound is +inf and every
  chunk is walked.  The kernel is kernels 4 and 5's block body
  (``csrc/nn_items.cuh``) with the test: each pair's chunks cut into work
  items of ``pairs_item_chunks`` chunks, one block each, ``PAIRS_Q``
  queries a thread, the items merged lexicographically, a chunk that
  fails every test of the block's subtiles neither staged nor swept
  (``pairs_items`` emulates the schedule on tensors).
- Survivor lists (kernel 9, dbs of at most ``PAIRS_MAX_DB`` points: its
  scratch is sized for every list full): the test runs here in torch per
  ``LIST_GRP``-query group and is unioned per subtile; the list holds the
  surviving chunk ids in ascending order, with capacity n_chunks rounded
  up to even, so no list can overflow.  The kernel cuts each subtile's
  walk into work items of a few list entries, one block each, with
  several queries a thread, repeats the test per group of LIST_WARP
  queries (a warp's) on each listed chunk, and merges a subtile's
  partials lexicographically (``list_schedule`` sizes the items,
  ``pairs_list_items`` emulates the schedule on tensors).

The margins are the JAX package's (lower bounds deflated by 1 - 16 eps),
and the query boxes span the zero-padded query rows as its boxes do: a
wider box only costs speed.  Padded pairs and queries carry -inf bounds
and walk nothing.  A query with no valid db point gets (+inf after the
trim, 0, 0).

The plain versions are the masked full sweep of each pair, with the
chunks a subtile does not walk set to +inf, vectorised over pairs, in
blocks of rows of at most ``_PLAIN_PAIRS`` (query, db point) distances.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import cuda_build
from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL, _round_up, \
    _trim_sentinel
from icp_rust_tpu_torch.ops.nn_sweep_cuda import MATCHED_THREADS, _tickets

PAIRS_MAX_DB = 4096
Q_SUB = 256
LIST_GRP = 64
# db points a chunk, the kernels' unit of staging and pruning (the drivers
# sort a batched db from 3 chunks up, ``ops/nn.route``).
CHUNK = 128
_DIMS = (2, 3)
# Payload widths: the driver's xy or xyz matched points (2, 3) and the
# point-to-plane payload [n, c = n . q] (4), whose sentinel c on invalid
# rows comes back as it went in.
_PAYLOADS = (2, 3, 4)
# nn_pairs_list's schedule: list entries a work item and queries a thread
# (csrc/nn_pairs_list.cu), the wrapper's by ``list_schedule``: 2 and 2
# measured best or within 1 % of the best schedule over the batched
# path's and SLAM 2D's calls on an H100 (PERF.md).  Which block walks
# which chunks follows from them, never the result.
LIST_ITEM = 2
LIST_Q = 2
_LIST_QS = (1, 2, 4)
# nn_pairs' schedule: queries a thread and the blocks a launch aims for
# (at least, where the db has the chunks), which sizes its work items
# (``pairs_item_chunks``): at the batched path's cold call (627 query
# groups of 6 chunks) the whole db an item and 2 queries a thread
# measured best on an H100 (PERF.md).  An item holds at most
# PAIRS_ITEM_MAX chunks: at batched p2l's warm searches over 28,800-point
# dbs (95 pairs; the seeds prune ~95 % of the chunks) items of 64 chunks
# measured 3.3 % faster than 16, 113 or the whole db's 225; dbs of at
# most PAIRS_MAX_DB points (32 chunks) never reach it.  Like kernel 9's
# they set which block walks which chunks, never the result.
PAIRS_Q = 2
PAIRS_BLOCKS = 512
PAIRS_ITEM_MAX = 64
_PAIRS_QS = (1, 2, 4)
# With the queries' bounds and the chunk boxes, nn_pairs_list repeats the
# prune test per group of LIST_WARP queries (a warp's, in every schedule)
# and such a group skips a listed chunk that fails it.
LIST_WARP = 32
# The plain versions' distances held at once (float32: 64 MB): a larger
# sweep runs in blocks of rows, so that the static sweep over dbs of
# 28,800 points (95 pairs: 7.9e10 distances) stays within tens of MB.
_PLAIN_PAIRS = 1 << 24


def pack_pairs(db: Tensor, db_mask, payload: Tensor) -> Tensor:
    """Per-pair sentinel-padded coordinate-major [db; payload] rows
    (B, D + F, m_pad), m_pad a multiple of 128.  Payload rows are not
    sentinel-masked: masked points never win."""
    b, m, d = db.shape
    if db_mask is not None:
        sentinel = torch.tensor(_SENTINEL, dtype=db.dtype, device=db.device)
        db = torch.where(db_mask[..., None], db, sentinel)
    m_pad = _round_up(m, CHUNK)
    out = torch.zeros((b, d + payload.shape[-1], m_pad), dtype=db.dtype,
                      device=db.device)
    out[:, :d] = _SENTINEL
    out[:, :d, :m] = db.transpose(1, 2)
    out[:, d:, :m] = payload.transpose(1, 2)
    return out


def _chunk_boxes(dbf_cm: Tensor, d_dim: int) -> Tensor:
    """Per-pair, per-128-point-chunk coordinate bounds (B, n_chunks, 8):
    cols 0..3 lo (+inf for an all-sentinel chunk), cols 4..7 hi (-inf
    likewise); unused dims are 0."""
    b, _, m_pad = dbf_cm.shape
    nc = m_pad // CHUNK
    t = dbf_cm[:, :d_dim].reshape(b, d_dim, nc, CHUNK)
    invalid = (t[:, 0] >= _SENTINEL / 2)[:, None]
    lo = torch.amin(t.masked_fill(invalid, float("inf")), dim=-1)
    hi = torch.amax(t.masked_fill(invalid, float("-inf")), dim=-1)
    out = torch.zeros((b, nc, 8), dtype=dbf_cm.dtype, device=dbf_cm.device)
    out[..., :d_dim] = lo.transpose(1, 2)
    out[..., 4:4 + d_dim] = hi.transpose(1, 2)
    return out


def _query_boxes(query_p: Tensor, grp: int) -> Tensor:
    """Per-pair bounds of each group of ``grp`` consecutive (padded)
    queries (B, Qp // grp, 8), laid out as the chunk boxes."""
    b, qp, d = query_p.shape
    g = query_p.reshape(b, qp // grp, grp, d)
    out = torch.zeros((b, qp // grp, 8), dtype=query_p.dtype,
                      device=query_p.device)
    out[..., :d] = torch.amin(g, dim=2)
    out[..., 4:4 + d] = torch.amax(g, dim=2)
    return out


def _group_bounds(q_bound: Tensor, grp: int) -> Tensor:
    """Max of the per-query bounds over each group of ``grp`` queries."""
    return torch.amax(q_bound.reshape(q_bound.shape[0], -1, grp), dim=-1)


def _box_lower_bound(qbox: Tensor, cbox: Tensor, d_dim: int) -> Tensor:
    """(B, R, n_chunks) squared box-to-box distance from query-group boxes
    (B, R, 8) to chunk boxes (B, n_chunks, 8), summed over the dims in
    order and deflated by 1 - 16 eps, the kernel's op sequence."""
    lb = torch.zeros((qbox.shape[0], qbox.shape[1], cbox.shape[1]),
                     dtype=qbox.dtype, device=qbox.device)
    for k in range(d_dim):
        a = cbox[:, None, :, k] - qbox[:, :, None, 4 + k]
        b = qbox[:, :, None, k] - cbox[:, None, :, 4 + k]
        gap = torch.clamp(torch.maximum(a, b), min=0.0)
        lb = lb + gap * gap
    return lb * (1.0 - 16.0 * torch.finfo(lb.dtype).eps)


def _survivor_lists(query_p: Tensor, cbox: Tensor, q_bound: Tensor,
                    d_dim: int, q_sub: int, list_grp: int):
    """Per (pair, subtile), the ascending ids of the chunks whose lower
    bound is <= the bound of any of the subtile's ``list_grp``-query
    groups; tails padded with the first listed id.  Returns (lists
    (B, n_qt, cap) int32, cnt (B, n_qt) int32), cap = n_chunks rounded up
    to even."""
    b, qp, _ = query_p.shape
    nc = cbox.shape[1]
    n_qt = qp // q_sub
    cap = _round_up(nc, 2)
    lb = _box_lower_bound(_query_boxes(query_p, list_grp), cbox, d_dim)
    ok = lb <= _group_bounds(q_bound, list_grp)[..., None]
    ok = torch.any(ok.reshape(b, n_qt, q_sub // list_grp, nc), dim=2)
    cnt = torch.sum(ok, dim=-1).to(torch.int32)
    ids = torch.arange(nc, dtype=torch.int32, device=cbox.device)
    key = torch.where(ok, ids, torch.full_like(ids, nc))
    srt = torch.sort(key, dim=-1).values
    if cap > nc:
        srt = torch.cat([srt, torch.full((b, n_qt, cap - nc), nc,
                                         dtype=srt.dtype,
                                         device=srt.device)], dim=-1)
    pos = torch.arange(cap, dtype=torch.int32, device=cbox.device)
    lists = torch.where(pos < cnt[..., None], srt, srt[..., :1])
    return lists.to(torch.int32).contiguous(), cnt.contiguous()


def _masked_sweep(query_p: Tensor, dbf_cm: Tensor, walk: Tensor,
                  d_dim: int, q_sub: int):
    """Exact 1-NN of each pair's queries over the chunks its row of q_sub
    queries walks (walk (B, Qp / q_sub, n_chunks) bool), the others set to
    +inf; the lowest index wins ties; (+inf, 0, 0) where nothing valid was
    walked.  Above ``_PLAIN_PAIRS`` distances, in blocks of rows: each row
    is swept alone, so the blocks change no result."""
    b, qp, _ = query_p.shape
    m_pad = dbf_cm.shape[2]
    if b * qp * m_pad <= _PLAIN_PAIRS:
        return _masked_rows(query_p, dbf_cm, walk, d_dim, q_sub)
    n_rows = b * (qp // q_sub)
    q_rows = query_p.reshape(n_rows, q_sub, -1)
    w_rows = walk.reshape(n_rows, 1, -1)
    pair = torch.arange(n_rows, device=query_p.device) // (qp // q_sub)
    step = max(1, _PLAIN_PAIRS // (q_sub * m_pad))
    parts = [_masked_rows(q_rows[r:r + step], dbf_cm[pair[r:r + step]],
                          w_rows[r:r + step], d_dim, q_sub)
             for r in range(0, n_rows, step)]
    dist, idx, pay = (torch.cat(x) for x in zip(*parts))
    return dist.reshape(b, qp), idx.reshape(b, qp), pay.reshape(b, qp, -1)


def _masked_rows(query_p: Tensor, dbf_cm: Tensor, walk: Tensor,
                 d_dim: int, q_sub: int):
    """``_masked_sweep`` in one piece."""
    b, qp, _ = query_p.shape
    f_dim = dbf_cm.shape[1] - d_dim
    m_pad = dbf_cm.shape[2]
    dist = None
    for k in range(d_dim):
        diff = query_p[:, :, k, None] - dbf_cm[:, None, k, :]
        sq = diff * diff
        dist = sq if dist is None else dist + sq
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    dist = torch.where(walk[:, :, None, :, None],
                       dist.reshape(b, qp // q_sub, q_sub, -1, CHUNK), inf)
    best, arg = torch.min(dist.reshape(b, qp, m_pad), dim=-1)
    hit = best != inf
    idx = torch.where(hit, arg, torch.zeros_like(arg))
    pay = torch.take_along_dim(dbf_cm[:, d_dim:], arg[:, None, :], dim=2)
    pay = torch.where(hit[:, None, :], pay, torch.zeros((), dtype=pay.dtype,
                                                        device=pay.device))
    return best, idx.to(torch.int32), pay.transpose(1, 2).reshape(b, qp,
                                                                  f_dim)


def nn_pairs_plain(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor,
                   cbox: Tensor, qbound: Tensor, d_dim: int,
                   q_sub: int = Q_SUB):
    """Plain PyTorch version of the nn_pairs kernel: each subtile walks
    the chunks whose lower bound is <= its bound."""
    walk = _box_lower_bound(qbox, cbox, d_dim) <= qbound[..., None]
    return _masked_sweep(query_p, dbf_cm, walk, d_dim, q_sub)


def pairs_item_chunks(b: int, qp: int, m_pad: int,
                      q_per_thread: int = PAIRS_Q) -> int:
    """nn_pairs' work item in 128-point chunks for B pairs of qp queries
    against m_pad db points: the largest of at most PAIRS_ITEM_MAX that
    still gives at least PAIRS_BLOCKS blocks (the whole db where the query
    groups alone do and it holds at most PAIRS_ITEM_MAX chunks), one chunk
    where none does."""
    groups = b * -(-qp // (MATCHED_THREADS * q_per_thread))
    n_ch = m_pad // CHUNK
    for item in range(min(n_ch, PAIRS_ITEM_MAX), 1, -1):
        if groups * -(-n_ch // item) >= PAIRS_BLOCKS:
            return item
    return 1


def pairs_items(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor, cbox: Tensor,
                qbound: Tensor, d_dim: int, q_sub: int = Q_SUB,
                item: int | None = None, q_per_thread: int = PAIRS_Q):
    """nn_pairs' schedule on tensors: each pair's chunks cut into work
    items of ``item`` chunks (default ``pairs_item_chunks``), each item
    swept ascending over the chunks its queries' subtile walks (the first
    minimum; (+inf, 0) where none is finite), the items merged
    lexicographically on (distance, index), the payload read at the
    winner.  Returns (dist, idx int32, pay, the work items that stage at
    least one chunk for groups of 128 x ``q_per_thread`` queries)."""
    b, qp, _ = query_p.shape
    nc = dbf_cm.shape[2] // CHUNK
    if item is None:
        item = pairs_item_chunks(b, qp, dbf_cm.shape[2], q_per_thread)
    walk = _box_lower_bound(qbox, cbox, d_dim) <= qbound[..., None]
    dev, dt = query_p.device, query_p.dtype
    best = torch.full((b, qp), float("inf"), dtype=dt, device=dev)
    bi = torch.zeros((b, qp), dtype=torch.int64, device=dev)
    chunk = torch.arange(nc, device=dev)
    for k in range(0, nc, item):
        mine = (chunk >= k) & (chunk < k + item)
        ld, li, _ = _masked_sweep(query_p, dbf_cm, walk & mine, d_dim, q_sub)
        li = li.to(torch.int64)
        better = (ld < best) | ((ld == best) & (li < bi))
        best = torch.where(better, ld, best)
        bi = torch.where(better, li, bi)
    pay = torch.take_along_dim(dbf_cm[:, d_dim:], bi[:, None, :], dim=2)
    pay = torch.where(torch.isinf(best)[:, None, :], torch.zeros_like(pay),
                      pay).transpose(1, 2)
    g = MATCHED_THREADS * q_per_thread
    rows = walk.repeat_interleave(q_sub, dim=1)  # (B, Qp, n_chunks)
    n_items = 0
    for q0 in range(0, qp, g):
        grp = rows[:, q0:q0 + g].any(dim=1)  # (B, n_chunks)
        for k in range(0, nc, item):
            n_items += int(grp[:, k:k + item].any(dim=1).sum())
    return best, bi.to(torch.int32), pay.contiguous(), n_items


def _list_walk(query_p: Tensor, dbf_cm: Tensor, lists: Tensor, cnt: Tensor,
               d_dim: int, q_sub: int, q_bound, cbox, first: int = 0,
               last=None):
    """Which chunks each row of queries walks: list entries [first, last)
    of each subtile's first ``cnt``; with ``q_bound`` (B, Qp) and
    ``cbox`` also the prune test per group of LIST_WARP queries.  Returns
    (walk (B, rows, n_chunks) bool, queries a row)."""
    nc = dbf_cm.shape[2] // CHUNK
    pos = torch.arange(lists.shape[-1], device=lists.device)
    mine = (pos < cnt[..., None]) & (pos >= first)
    if last is not None:
        mine = mine & (pos < last)
    ids = torch.where(mine, lists.to(torch.int64), torch.full_like(pos, nc))
    walk = torch.zeros((*lists.shape[:2], nc + 1), dtype=torch.bool,
                       device=lists.device)
    walk.scatter_(2, ids, torch.ones_like(ids, dtype=torch.bool))
    walk = walk[..., :nc]
    if q_bound is None or cbox is None:
        return walk, q_sub
    lb = _box_lower_bound(_query_boxes(query_p, LIST_WARP), cbox, d_dim)
    ok = lb <= _group_bounds(q_bound, LIST_WARP)[..., None]
    return walk.repeat_interleave(q_sub // LIST_WARP, dim=1) & ok, LIST_WARP


def nn_pairs_list_plain(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                        cnt: Tensor, d_dim: int, q_sub: int = Q_SUB,
                        q_bound: Tensor | None = None,
                        cbox: Tensor | None = None):
    """Plain PyTorch version of the nn_pairs_list kernel: each subtile
    walks the first ``cnt`` chunks of its list; with the queries' bounds
    ``q_bound`` (B, Qp) and the chunk boxes ``cbox`` a group of LIST_WARP
    queries skips the listed chunks that fail its own prune test."""
    walk, rows = _list_walk(query_p, dbf_cm, lists, cnt, d_dim, q_sub,
                            q_bound, cbox)
    return _masked_sweep(query_p, dbf_cm, walk, d_dim, rows)


def _check_launch(name: str, query_p: Tensor, dbf_cm: Tensor, d_dim: int,
                  q_sub: int, tables) -> None:
    if query_p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {query_p.device}")
    for tname, x, dt in (("query", query_p, torch.float32),
                         ("dbf_cm", dbf_cm, torch.float32), *tables):
        if x.dtype != dt:
            raise TypeError(f"{name}: {tname} must be {dt}, got {x.dtype}")
        if x.device != query_p.device or not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous on "
                             f"{query_p.device}")
    b, qp, d = query_p.shape
    f_dim = dbf_cm.shape[1] - d_dim
    if (d != d_dim or d_dim not in _DIMS or f_dim not in _PAYLOADS
            or dbf_cm.shape[0] != b or dbf_cm.shape[2] % CHUNK
            or q_sub % 64 or q_sub > 1024 or qp % q_sub):
        raise ValueError(f"{name}: bad shapes (D in {_DIMS}, F in "
                         f"{_PAYLOADS}, Qp a multiple of q_sub, M a multiple "
                         "of 128)")


def _outputs(query_p: Tensor, dbf_cm: Tensor, d_dim: int):
    b, qp, _ = query_p.shape
    dev = query_p.device
    return (torch.empty((b, qp), dtype=torch.float32, device=dev),
            torch.empty((b, qp), dtype=torch.int32, device=dev),
            torch.empty((b, qp, dbf_cm.shape[1] - d_dim),
                        dtype=torch.float32, device=dev))


def nn_pairs(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor, cbox: Tensor,
             qbound: Tensor, d_dim: int, q_sub: int = Q_SUB):
    """Static-sweep pair-grid 1-NN: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  query_p (B, Qp, D), Qp a multiple of q_sub;
    dbf_cm (B, D + F, m_pad); qbox (B, Qp / q_sub, 8); cbox
    (B, m_pad / 128, 8); qbound (B, Qp / q_sub).  Returns (dist (B, Qp),
    idx (B, Qp) int32, pay (B, Qp, F)) before sentinel trimming."""
    if query_p.device.type == "cpu":
        return nn_pairs_plain(query_p, dbf_cm, qbox, cbox, qbound, d_dim,
                              q_sub)
    args, out, _keep = _nn_pairs_args(query_p, dbf_cm, qbox, cbox, qbound,
                                      d_dim, q_sub)
    status = cuda_build.launcher("nn_pairs")(*args)
    cuda_build.LAUNCHES["nn_pairs"] += 1
    cuda_build.check(status, "nn_pairs")
    return out


def _nn_pairs_args(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor,
                   cbox: Tensor, qbound: Tensor, d_dim: int,
                   q_sub: int = Q_SUB, item=None, q_per_thread=None):
    """Check the CUDA inputs of the nn_pairs kernel and allocate its
    outputs and scratch; ``item`` (chunks a work item) and
    ``q_per_thread`` default to ``pairs_item_chunks`` and PAIRS_Q.
    Returns (the launcher's arguments, (dist, idx, pay), the scratch,
    which the caller holds until the launch is enqueued)."""
    _check_launch("nn_pairs", query_p, dbf_cm, d_dim, q_sub,
                  (("qbox", qbox, torch.float32),
                   ("cbox", cbox, torch.float32),
                   ("qbound", qbound, torch.float32)))
    b, qp, _ = query_p.shape
    m_pad = dbf_cm.shape[2]
    if (qbox.shape != (b, qp // q_sub, 8) or qbound.shape != (b, qp // q_sub)
            or cbox.shape != (b, m_pad // CHUNK, 8)):
        raise ValueError("nn_pairs: bad box or bound shapes")
    q = PAIRS_Q if q_per_thread is None else q_per_thread
    item = pairs_item_chunks(b, qp, m_pad, q) if item is None else item
    if (q not in _PAIRS_QS or item < 1 or q_sub % MATCHED_THREADS
            or dbf_cm.data_ptr() % 16):
        raise ValueError(f"nn_pairs: bad schedule (items of {item} chunks, "
                         f"{q} queries a thread of {_PAIRS_QS}), q_sub "
                         f"{q_sub} not a multiple of {MATCHED_THREADS} or "
                         "dbf_cm not 16-byte aligned")
    g = MATCHED_THREADS * q
    n_groups = -(-qp // g)
    n_items = -(-(m_pad // CHUNK) // item)
    dev = query_p.device
    tickets = _tickets(dev, b * n_groups, "nn_pairs")
    part = torch.empty(b * n_groups * n_items * 2 * g if n_items > 1 else 1,
                       dtype=torch.float32, device=dev)
    dist, idx, pay = _outputs(query_p, dbf_cm, d_dim)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (query_p.data_ptr(), dbf_cm.data_ptr(), qbox.data_ptr(),
            cbox.data_ptr(), qbound.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), pay.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), b, qp, q_sub, d_dim,
            dbf_cm.shape[1] - d_dim, m_pad, item, q, stream)
    return args, (dist, idx, pay), part


def nn_pairs_list(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                  cnt: Tensor, d_dim: int, q_sub: int = Q_SUB,
                  q_bound: Tensor | None = None, cbox: Tensor | None = None):
    """Survivor-list pair-grid 1-NN: the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  lists (B, Qp / q_sub, cap) int32, cnt
    (B, Qp / q_sub) int32 from ``_survivor_lists``; with the queries'
    bounds ``q_bound`` (B, Qp) and the chunk boxes ``cbox`` (B, m_pad /
    128, 8) that built them, each group of LIST_WARP queries also skips
    the listed chunks that fail its own test (the result is the same for
    valid bounds).  The rest as ``nn_pairs``."""
    if query_p.device.type == "cpu":
        return nn_pairs_list_plain(query_p, dbf_cm, lists, cnt, d_dim, q_sub,
                                   q_bound, cbox)
    args, out, _part = _nn_pairs_list_args(query_p, dbf_cm, lists, cnt,
                                           d_dim, q_sub, q_bound, cbox)
    status = cuda_build.launcher("nn_pairs_list")(*args)
    cuda_build.LAUNCHES["nn_pairs_list"] += 1
    cuda_build.check(status, "nn_pairs_list")
    return out


def list_schedule(q_sub: int, cap: int):
    """nn_pairs_list's schedule for subtiles of q_sub queries and lists of
    cap entries: (list entries a work item, queries a thread).  LIST_Q
    queries a thread where the block keeps at least a warp, LIST_ITEM
    entries an item."""
    q = LIST_Q
    while q > 1 and q_sub // q < 32:
        q //= 2
    return min(LIST_ITEM, cap), q


def _nn_pairs_list_args(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                        cnt: Tensor, d_dim: int, q_sub: int = Q_SUB,
                        q_bound: Tensor | None = None,
                        cbox: Tensor | None = None, item=None,
                        q_per_thread=None):
    """Check the CUDA inputs of nn_pairs_list and allocate its outputs and
    scratch; ``item`` and ``q_per_thread`` default to ``list_schedule``'s.
    Returns (the launcher's arguments, (dist, idx, pay), the scratch,
    which the caller holds until the launch is enqueued)."""
    grouped = q_bound is not None and cbox is not None
    tables = [("lists", lists, torch.int32), ("cnt", cnt, torch.int32)]
    if grouped:
        tables += [("q_bound", q_bound, torch.float32),
                   ("cbox", cbox, torch.float32)]
    _check_launch("nn_pairs_list", query_p, dbf_cm, d_dim, q_sub, tables)
    b, qp, _ = query_p.shape
    cap = lists.shape[-1]
    if (lists.ndim != 3 or lists.shape[:2] != (b, qp // q_sub)
            or cnt.shape != (b, qp // q_sub) or cap < 1):
        raise ValueError("nn_pairs_list: bad list shapes")
    if grouped and (q_bound.shape != (b, qp) or cbox.data_ptr() % 16
                    or cbox.shape != (b, dbf_cm.shape[2] // CHUNK, 8)):
        raise ValueError("nn_pairs_list: q_bound must be (B, Qp) and cbox "
                         "(B, m_pad / 128, 8), 16-byte aligned")
    d_item, d_q = list_schedule(q_sub, cap)
    item = d_item if item is None else item
    q = d_q if q_per_thread is None else q_per_thread
    if (q not in _LIST_QS or q_sub // q < 32 or item < 1
            or dbf_cm.data_ptr() % 16):
        raise ValueError(f"nn_pairs_list: bad schedule (items of {item} "
                         f"entries, {q} queries a thread of {_LIST_QS}, at "
                         "least 32 threads) or dbf_cm not 16-byte aligned")
    dev = query_p.device
    rows = b * (qp // q_sub)
    tickets = _tickets(dev, rows, "nn_pairs_list")
    part = torch.empty(rows * -(-cap // item) * 2 * q_sub,
                       dtype=torch.float32, device=dev)
    dist, idx, pay = _outputs(query_p, dbf_cm, d_dim)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (query_p.data_ptr(), dbf_cm.data_ptr(), lists.data_ptr(),
            cnt.data_ptr(), q_bound.data_ptr() if grouped else None,
            cbox.data_ptr() if grouped else None, dist.data_ptr(),
            idx.data_ptr(), pay.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), b, qp, q_sub, d_dim, dbf_cm.shape[1] - d_dim,
            dbf_cm.shape[2], cap, item, q, stream)
    return args, (dist, idx, pay), part


def pairs_list_items(query_p: Tensor, dbf_cm: Tensor, lists: Tensor,
                     cnt: Tensor, d_dim: int, q_sub: int = Q_SUB,
                     q_bound: Tensor | None = None,
                     cbox: Tensor | None = None, item: int = LIST_ITEM):
    """nn_pairs_list's schedule on tensors: each subtile's walk (its first
    cnt list entries) cut into items of ``item`` entries, each item swept
    ascending (the first minimum of its points, with the per-group test
    of ``q_bound`` and ``cbox`` when given; (+inf, 0) where none is
    finite), the items merged lexicographically on (distance, index), the
    payload read at the winner.  Returns (dist, idx int32, pay, the work
    items that walk at least one chunk)."""
    b, qp, _ = query_p.shape
    dev, dt = query_p.device, query_p.dtype
    best = torch.full((b, qp), float("inf"), dtype=dt, device=dev)
    bi = torch.zeros((b, qp), dtype=torch.int64, device=dev)
    for k in range(0, lists.shape[-1], item):
        walk, rows = _list_walk(query_p, dbf_cm, lists, cnt, d_dim, q_sub,
                                q_bound, cbox, k, k + item)
        ld, li, _ = _masked_sweep(query_p, dbf_cm, walk, d_dim, rows)
        li = li.to(torch.int64)
        better = (ld < best) | ((ld == best) & (li < bi))
        best = torch.where(better, ld, best)
        bi = torch.where(better, li, bi)
    pay = torch.take_along_dim(dbf_cm[:, d_dim:], bi[:, None, :], dim=2)
    pay = torch.where(torch.isinf(best)[:, None, :], torch.zeros_like(pay),
                      pay).transpose(1, 2)
    n_items = int((-(-cnt.to(torch.int64) // item)).sum())
    return best, bi.to(torch.int32), pay.contiguous(), n_items


def group_walks(query_p: Tensor, dbf_cm: Tensor, lists: Tensor, cnt: Tensor,
                d_dim: int, q_sub: int = Q_SUB,
                q_bound: Tensor | None = None,
                cbox: Tensor | None = None) -> int:
    """The (query, db point) pairs one nn_pairs_list call sweeps: 128 a
    walked (query, chunk), after the per-group test when it is on."""
    walk, rows = _list_walk(query_p, dbf_cm, lists, cnt, d_dim, q_sub,
                            q_bound, cbox)
    return int(walk.sum()) * rows * CHUNK


def prepare(query: Tensor, db: Tensor, db_mask=None, payload=None,
            q_bound: Tensor | None = None, q_sub: int = Q_SUB):
    """The kernels' inputs for query (B, Nq, D) against db (B, M, D) or a
    shared (M, D): (query_p (B, Qp, D) zero-padded to a multiple of q_sub,
    dbf_cm (B, D + F, m_pad), chunk boxes (B, m_pad / 128, 8), bounds
    (B, Qp)).  Missing bounds are +inf; padded queries carry -inf, so
    their subtiles prune every chunk."""
    b, n_q, d_dim = query.shape
    if payload is None:
        payload = db
    db = db.expand(b, *db.shape[-2:])
    payload = payload.expand(b, *payload.shape[-2:])
    if db_mask is not None:
        db_mask = db_mask.expand(b, db_mask.shape[-1])
    dbf_cm = pack_pairs(db, db_mask, payload)
    q_pad = _round_up(n_q, q_sub)
    query_p = torch.zeros((b, q_pad, d_dim), dtype=query.dtype,
                          device=query.device)
    query_p[:, :n_q] = query
    qb = torch.full((b, q_pad), float("-inf"), dtype=query.dtype,
                    device=query.device)
    qb[:, :n_q] = (float("inf") if q_bound is None
                   else q_bound.to(query.dtype))
    return query_p, dbf_cm, _chunk_boxes(dbf_cm, d_dim), qb


def nn_pairs_matched(query: Tensor, db: Tensor, db_mask=None, payload=None,
                     q_bound: Tensor | None = None, q_sub: int = Q_SUB,
                     list_grp: int = LIST_GRP, warm: bool | None = None):
    """Batched exact 1-NN with matched payload: query (B, Nq, D) against
    db (B, M, D) or a shared (M, D).  Returns (index (B, Nq) int32,
    dist_sq (B, Nq), matched (B, Nq, F)).

    Warmth dispatch: ``warm`` None decides from the bounds (all +-inf ->
    the static sweep, any finite bound -> the survivor lists), a bool
    selects the branch statically, and no bound means the static sweep
    with +inf bounds.  Above PAIRS_MAX_DB points every search takes the
    static sweep, a warm one with its subtiles' bounds.  The results are
    bit-identical whichever runs, as long as the bounds are valid."""
    n_q, d_dim = query.shape[1:]
    query_p, dbf_cm, cbox, qb = prepare(query, db, db_mask, payload,
                                        q_bound, q_sub)
    if q_bound is None:
        warm = False
    elif warm is None:
        warm = bool(torch.any(torch.isfinite(qb)))
    if warm and db.shape[-2] <= PAIRS_MAX_DB:
        lists, cnt = _survivor_lists(query_p, cbox, qb, d_dim, q_sub,
                                     min(list_grp, q_sub))
        dist, idx, pay = nn_pairs_list(query_p, dbf_cm, lists, cnt, d_dim,
                                       q_sub, qb, cbox)
    else:
        dist, idx, pay = nn_pairs(query_p, dbf_cm,
                                  _query_boxes(query_p, q_sub), cbox,
                                  _group_bounds(qb, q_sub), d_dim, q_sub)
    return (idx[:, :n_q], _trim_sentinel(dist[:, :n_q]), pay[:, :n_q])
