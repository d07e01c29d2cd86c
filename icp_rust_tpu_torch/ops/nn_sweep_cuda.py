"""Exact 1-NN sweeps without survivor lists: the hand-written kernels
``csrc/nn_sweep.cu`` (no payload), ``csrc/nn_matched.cu`` (with the
winner's payload) and ``csrc/nn_pruned.cu`` (zig-zag order with exact
tile pruning, optional payload), their wrappers, their plain PyTorch
versions, and the torch code around them.

Counterparts of icp_rust_tpu/ops/nn_pallas.py's ``_nn_kernel`` (kernel 5,
``nn_pallas`` on dbs of fewer than 3 tiles and on batched calls),
``_nn_matched_kernel`` (kernel 4, ``nn_pallas_matched`` likewise) and
``_nn_pruned_kernel`` (kernel 6, ``nn_pallas`` on a single cloud of 3
tiles or more, and ``nn_pallas_matched`` unseeded or with a wide payload).
``search`` is the routing of those two functions minus the seeded
survivor-list branch, which ``ops/nn.py`` takes first.

Both sweeps read the coordinate-major db of ``_dbf_cm_matched`` (D
sentinel-filled coordinate rows, then F payload rows) and run one block
body (``csrc/nn_items.cuh``): the sweep is split over blocks, a block
holds ``MATCHED_Q`` queries a thread (groups of ``MATCHED_THREADS`` x Q
queries) and sweeps one work item, a contiguous ascending range of
128-point db chunks, with a strict '<' on a (distance, index) carry; the
items, ``matched_item_chunks`` chunks each (sized from the shapes
alone), are merged lexicographically on (distance, index) by the group's
last block (a ticket per (pair, group) in ``_TICKETS``), so the lowest
index wins ties.  Kernel 4's merging block reads the winner's payload
from the packed db; kernel 5 has none.  ``matched_items`` emulates that
schedule on tensors (kernel 5's with F = 0).  A leading batch axis is one
more grid axis of both.

Kernel 6 visits the db tiles of its query tile ``i`` diagonal first:
tiles s..n-1 ascending, then s-1..0 descending, s = i q_tile // db_tile.
That order is cut into work items of ``ITEM_TILES`` consecutive tiles,
one block each, and a block holds ``QUERIES_PER_THREAD`` queries a thread
(``_block_shape``: the block's group of queries lies inside one query
tile).  A tile (after tile 0 of the order) is skipped when the squared
distance between the query tile's box and the db tile's box, deflated by
1 - 16 eps, is above the block's threshold min(max of its queries'
current bests in its item, qb_tile[i]).  A skipped tile holds no point of
any of the block's queries' tie sets, so each item's best is the
lexicographic (distance, index) minimum over the tiles it may hold a
winner in, and the items' lexicographic merge is the unpruned sweep's
result, bit for bit.  The winner's payload is read from the packed db
after the merge.  The plain version ``nn_pruned_plain`` walks the
whole order per block of ``SUB`` queries, as the TPU kernel walks it per
query tile; ``pruned_items`` emulates the kernel's items and counts their
sweeps.

With no valid db point a query gets (+inf, 0, 0): sentinel distances
overflow to +inf in float32 and never win a strict compare.  ``search``
trims distances at or above sentinel²/4 to +inf, which makes float64 (a
CPU-only type here) follow the same contract.  Distances are summed
(dx² + dy²) + dz² with every rounding explicit (kernels built with
--fmad=false; kernel 5's leading 0 + dx² is dx² for every square), the
plain versions' order, so kernel and plain version agree bitwise.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import cuda_build
from icp_rust_tpu_torch.ops.nn_cuda import _dbf_cm_matched, _round_up, \
    _tile_boxes, _trim_sentinel

SUB = 128
_STAGE = 128
# Kernel 6: db tiles per work item (one block each) and queries per
# thread, both measured on an H100 (PERF.md).  They set which tiles each
# block may prune, never the result, so they are constants, not knobs.
ITEM_TILES = 2
QUERIES_PER_THREAD = 4
_PRUNED_Q = (2, 4, 8)
# Kernels 4 and 5: threads a block, queries a thread, and the blocks a
# launch aims for (at least, where the db has the chunks), which sizes its
# work items; measured on an H100 (PERF.md).  Like kernel 6's they set
# which block sweeps what, never the result.
MATCHED_THREADS = 128
MATCHED_Q = 2
MATCHED_BLOCKS = 8192
# Tickets of kernels 4, 5, 6, 8 and 9's query groups, one buffer per
# (device, kernel), zero between launches (each launch resets its own).
_TICKETS: dict = {}
# (D, payload width) of the kernel instances, what the callers pass: the
# unmatched sweeps; the matched xy of icp2d (2D) and icp3d_planar (3D), the
# matched 3D point (the default payload) and the p2l [n, c] rows.
SWEEP_INSTANCES = ((2, 0), (3, 0))
MATCHED_INSTANCES = ((2, 2), (3, 2), (3, 3), (3, 4))
PRUNED_INSTANCES = SWEEP_INSTANCES + MATCHED_INSTANCES


def _query_boxes(query_p: Tensor, tile: int) -> Tensor:
    """(Qp // tile, 8) per-query-tile bounds: cols 0..3 lo, 4..7 hi, unused
    dims 0.  The zero-padded query rows are included, as on the TPU: they
    only widen the box, which is conservative."""
    q, d = query_p.shape
    t = query_p.reshape(q // tile, tile, d)
    out = torch.zeros((q // tile, 8), dtype=query_p.dtype,
                      device=query_p.device)
    out[:, :d] = torch.amin(t, dim=1)
    out[:, 4:4 + d] = torch.amax(t, dim=1)
    return out


def _qb_tile(qb_p: Tensor, q_tile: int) -> Tensor:
    """Per query tile, the max of its queries' NN upper bounds."""
    return torch.amax(qb_p.reshape(-1, q_tile), dim=1)


def _tile_dist(query: Tensor, tile_cm: Tensor, d_dim: int) -> Tensor:
    """Squared distances (..., Q, T) of queries (..., Q, D) to the points
    of a coordinate-major tile (..., D + F, T), summed in the kernels'
    order."""
    dist = None
    for k in range(d_dim):
        diff = query[..., :, k, None] - tile_cm[..., None, k, :]
        sq = diff * diff
        dist = sq if dist is None else dist + sq
    return dist


def _payload_of(tile_cm: Tensor, d_dim: int, arg: Tensor) -> Tensor:
    """The payload rows (..., Q, F) of the tile's points ``arg`` (..., Q)."""
    pay = torch.take_along_dim(tile_cm[..., d_dim:, :], arg[..., None, :],
                               dim=-1)
    return pay.transpose(-1, -2)


def nn_matched_plain(query_p: Tensor, dbf_cm: Tensor, d_dim: int,
                     tile: int = 1024):
    """Plain PyTorch version of kernels 4 and 5: the ascending sweep of
    query_p (..., Qp, D) over dbf_cm (..., D + F, m_pad), ``tile`` points
    at a time, the first minimum of a tile and a strict '<' across tiles.
    Returns (dist (..., Qp), idx (..., Qp) int32, pay (..., Qp, F))."""
    *batch, qp, _ = query_p.shape
    f_dim = dbf_cm.shape[-2] - d_dim
    dev, dt = query_p.device, query_p.dtype
    best = torch.full((*batch, qp), float("inf"), dtype=dt, device=dev)
    bi = torch.zeros((*batch, qp), dtype=torch.int64, device=dev)
    pay = torch.zeros((*batch, qp, f_dim), dtype=dt, device=dev)
    for s in range(0, dbf_cm.shape[-1], tile):
        t = dbf_cm[..., s:s + tile]
        ld, li = torch.min(_tile_dist(query_p, t, d_dim), dim=-1)
        better = ld < best
        best = torch.where(better, ld, best)
        bi = torch.where(better, li + s, bi)
        if f_dim:
            pay = torch.where(better[..., None], _payload_of(t, d_dim, li),
                              pay)
    return best, bi.to(torch.int32), pay


def nn_sweep_plain(query_p: Tensor, db_cm: Tensor, tile: int = 1024):
    """Plain PyTorch version of kernel 5: (dist, idx) of
    ``nn_matched_plain`` with no payload rows."""
    dist, idx, _ = nn_matched_plain(query_p, db_cm, db_cm.shape[-2], tile)
    return dist, idx


def matched_item_chunks(b: int, qp: int, m_pad: int,
                        q_per_thread: int = MATCHED_Q) -> int:
    """Kernels 4 and 5's work item in 128-point db chunks for B pairs of qp
    queries against m_pad db points: the fewest work items that give at
    least MATCHED_BLOCKS blocks (one, the whole db, where the query groups
    alone do), and at least one chunk an item."""
    n_groups = -(-qp // (MATCHED_THREADS * q_per_thread))
    n_ch = m_pad // _STAGE
    n_items = min(n_ch, max(1, -(-MATCHED_BLOCKS // (b * n_groups))))
    return -(-n_ch // n_items)


def matched_items(query_p: Tensor, dbf_cm: Tensor, d_dim: int,
                  item_chunks: int):
    """Kernels 4 and 5's schedule on tensors: the db cut into work items of
    ``item_chunks`` 128-point chunks, each swept ascending (the first
    minimum of the item), the items merged lexicographically on
    (distance, index), the payload read at the winner.  query_p (...,
    Qp, D), dbf_cm (..., D + F, m_pad).  Returns (dist, idx int32, pay,
    number of items)."""
    *batch, qp, _ = query_p.shape
    dev, dt = query_p.device, query_p.dtype
    m_pad = dbf_cm.shape[-1]
    step = item_chunks * _STAGE
    best = torch.full((*batch, qp), float("inf"), dtype=dt, device=dev)
    bi = torch.zeros((*batch, qp), dtype=torch.int64, device=dev)
    for s in range(0, m_pad, step):
        ld, li = torch.min(_tile_dist(query_p, dbf_cm[..., s:s + step],
                                      d_dim), dim=-1)
        # An item with no valid point keeps the kernel's (+inf, 0).
        li = torch.where(torch.isinf(ld), -s, li) + s
        better = (ld < best) | ((ld == best) & (li < bi))
        best = torch.where(better, ld, best)
        bi = torch.where(better, li, bi)
    pay = torch.take_along_dim(dbf_cm[..., d_dim:, :], bi[..., None, :],
                               dim=-1).transpose(-1, -2)
    pay = torch.where(torch.isinf(best)[..., None], torch.zeros_like(pay),
                      pay)
    return best, bi.to(torch.int32), pay, -(-m_pad // step)


def _box_lb(qbox_rows: Tensor, bbox: Tensor, d_dim: int) -> Tensor:
    """Squared distances (rows, n_db) between query-tile boxes and db-tile
    boxes, dims summed in order and deflated by 1 - 16 eps, as the kernel
    forms its prune test."""
    lb = torch.zeros((qbox_rows.shape[0], bbox.shape[0]),
                     dtype=qbox_rows.dtype, device=qbox_rows.device)
    for k in range(d_dim):
        a = bbox[None, :, k] - qbox_rows[:, None, 4 + k]
        b = qbox_rows[:, None, k] - bbox[None, :, 4 + k]
        gap = torch.clamp(torch.maximum(a, b), min=0.0)
        lb = lb + gap * gap
    return lb * (1.0 - 16.0 * torch.finfo(qbox_rows.dtype).eps)


def _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim: int,
                  q_tile: int, db_tile: int):
    """Kernel 6's visit order, prune test and lexicographic carry over the
    whole order, vectorised over blocks of SUB queries.  Returns (dist,
    idx, pay, tiles walked)."""
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    n_db = dbf_cm.shape[1] // db_tile
    n_blk = qp // SUB
    dev, dt = query_p.device, query_p.dtype
    blk_qt = torch.arange(n_blk, device=dev) * SUB // q_tile
    start = blk_qt * q_tile // db_tile
    tiles = dbf_cm.reshape(d_dim + f_dim, n_db, db_tile)
    q_b = query_p.reshape(n_blk, SUB, d_dim)
    lb = _box_lb(qbox[blk_qt], bbox, d_dim)
    qbt = qb_tile[blk_qt]
    maxd = qbt
    best = torch.full((n_blk, SUB), float("inf"), dtype=dt, device=dev)
    bi = torch.zeros((n_blk, SUB), dtype=torch.int64, device=dev)
    pay = torch.zeros((n_blk, SUB, f_dim), dtype=dt, device=dev)
    rows = torch.arange(n_blk, device=dev)
    walked = 0
    for j in range(n_db):
        actual = torch.where(j >= n_db - start, n_db - 1 - j, start + j)
        run = (lb[rows, actual] <= maxd) | (j == 0)
        t = tiles[:, actual].transpose(0, 1)  # (n_blk, D + F, db_tile)
        ld, li = torch.min(_tile_dist(q_b, t, d_dim), dim=-1)
        gi = li + actual[:, None] * db_tile
        better = run[:, None] & ((ld < best) | ((ld == best) & (gi < bi)))
        best = torch.where(better, ld, best)
        bi = torch.where(better, gi, bi)
        if f_dim:
            pay = torch.where(better[..., None], _payload_of(t, d_dim, li),
                              pay)
        maxd = torch.where(run, torch.minimum(torch.amax(best, dim=1), qbt),
                           maxd)
        walked += int(run.sum())
    return (best.reshape(qp), bi.reshape(qp).to(torch.int32),
            pay.reshape(qp, f_dim), walked)


def nn_pruned_plain(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor,
                    bbox: Tensor, qb_tile: Tensor, d_dim: int, q_tile: int,
                    db_tile: int):
    """Plain PyTorch version of kernel 6: the zig-zag order with its prune
    test and lexicographic carry, per block of SUB queries.  Returns
    (dist, idx, pay)."""
    return _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim,
                         q_tile, db_tile)[:3]


def tiles_walked(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim: int,
                 q_tile: int, db_tile: int) -> int:
    """The (block of SUB queries, db tile) sweeps of the plain version on
    these inputs: how much its prune test skips."""
    return _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim,
                         q_tile, db_tile)[3]


def _block_shape(q_tile: int, q_per_thread: int):
    """Kernel 6's block: (threads, queries a thread).  The largest of 128,
    64 and 32 threads whose group of threads x Q queries divides q_tile
    (a multiple of SUB), Q halved first where even 32 threads' group does
    not."""
    if q_per_thread not in _PRUNED_Q:
        raise ValueError(f"nn_pruned: queries per thread must be one of "
                         f"{_PRUNED_Q}, got {q_per_thread}")
    q = q_per_thread
    while q_tile % (32 * q):
        q //= 2
    threads = 128
    while q_tile % (threads * q):
        threads //= 2
    return threads, q


def pruned_items(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim: int,
                 q_tile: int, db_tile: int, item_tiles: int = ITEM_TILES,
                 q_per_thread: int = QUERIES_PER_THREAD):
    """Kernel 6's schedule on tensors: per group of threads x Q queries
    (``_block_shape``), the zig-zag order cut into items of
    ``item_tiles``, each item with its own carry and threshold, a tile
    swept into a fresh carry merged lexicographically, the items merged
    lexicographically, the payload read at the winner.  Returns (dist,
    idx, pay, sweeps): sweeps[k] counts the (group, db tile) sweeps of
    item k over all groups."""
    threads, q = _block_shape(q_tile, q_per_thread)
    g = threads * q
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    n_db = dbf_cm.shape[1] // db_tile
    n_grp = qp // g
    dev, dt = query_p.device, query_p.dtype
    grp_qt = torch.arange(n_grp, device=dev) * g // q_tile
    start = grp_qt * q_tile // db_tile
    tiles = dbf_cm[:d_dim].reshape(d_dim, n_db, db_tile)
    q_g = query_p.reshape(n_grp, g, d_dim)
    lb = _box_lb(qbox[grp_qt], bbox, d_dim)
    qbt = qb_tile[grp_qt]
    rows = torch.arange(n_grp, device=dev)
    inf = torch.full((n_grp, g), float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((n_grp, g), dtype=torch.int64, device=dev)
    best, bi, sweeps = inf, zero, []
    for k in range(0, n_db, item_tiles):
        ib, ii, maxd, count = inf, zero, qbt, 0
        for j in range(k, min(n_db, k + item_tiles)):
            actual = torch.where(j >= n_db - start, n_db - 1 - j, start + j)
            run = (lb[rows, actual] <= maxd) | (j == 0)
            t = tiles[:, actual].transpose(0, 1)  # (n_grp, D, db_tile)
            ld, li = torch.min(_tile_dist(q_g, t, d_dim), dim=-1)
            gi = li + actual[:, None] * db_tile
            better = run[:, None] & ((ld < ib) | ((ld == ib) & (gi < ii)))
            ib = torch.where(better, ld, ib)
            ii = torch.where(better, gi, ii)
            maxd = torch.where(run, torch.minimum(torch.amax(ib, dim=1), qbt),
                               maxd)
            count += int(run.sum())
        better = (ib < best) | ((ib == best) & (ii < bi))
        best = torch.where(better, ib, best)
        bi = torch.where(better, ii, bi)
        sweeps.append(count)
    best, bi = best.reshape(qp), bi.reshape(qp)
    pay = dbf_cm[d_dim:, bi].T
    pay = torch.where(torch.isinf(best)[:, None], torch.zeros_like(pay), pay)
    return best, bi.to(torch.int32), pay, sweeps


def _nn_pruned_args(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor,
                    bbox: Tensor, qb_tile: Tensor, d_dim: int, q_tile: int,
                    db_tile: int, item_tiles: int = ITEM_TILES,
                    q_per_thread: int = QUERIES_PER_THREAD):
    """Check the CUDA inputs of kernel 6 and allocate its outputs and
    scratch.  Returns (the launcher's arguments, (dist, idx, pay), the
    scratch, which the caller holds until the launch is enqueued)."""
    qp = query_p.shape[0]
    m_pad = dbf_cm.shape[1]
    f_dim = dbf_cm.shape[0] - d_dim
    _check("nn_pruned", query_p, (("query", query_p, torch.float32),
                                  ("dbf_cm", dbf_cm, torch.float32),
                                  ("qbox", qbox, torch.float32),
                                  ("bbox", bbox, torch.float32),
                                  ("qb_tile", qb_tile, torch.float32)),
           d_dim, f_dim, PRUNED_INSTANCES)
    if dbf_cm.data_ptr() % 16 or item_tiles < 1:
        raise ValueError("nn_pruned: dbf_cm must be 16-byte aligned and "
                         "work items hold at least one tile")
    threads, q = _block_shape(q_tile, q_per_thread)
    n_grp = qp // (threads * q)
    n_items = -(-(m_pad // db_tile) // item_tiles)
    dev = query_p.device
    tickets = _tickets(dev, n_grp, "nn_pruned")
    part = torch.empty(qp * n_items * 2, dtype=torch.float32, device=dev)
    dist = torch.empty((qp,), dtype=torch.float32, device=dev)
    idx = torch.empty((qp,), dtype=torch.int32, device=dev)
    pay = torch.empty((qp, f_dim), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (query_p.data_ptr(), dbf_cm.data_ptr(), qbox.data_ptr(),
            bbox.data_ptr(), qb_tile.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), pay.data_ptr() if f_dim else None,
            part.data_ptr(), tickets.data_ptr(), qp, q_tile, db_tile, d_dim,
            f_dim, m_pad, item_tiles, threads, q, stream)
    return args, (dist, idx, pay), part


def _tickets(dev, n: int, name: str) -> Tensor:
    """At least n zeroed ticket ints of kernel ``name`` on ``dev``, kept
    between launches: each kernel its own, so that no two kernels' groups
    share a ticket."""
    tickets = _TICKETS.get((dev, name))
    if tickets is None or tickets.shape[0] < n:
        tickets = _TICKETS[(dev, name)] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev)
    return tickets


def _check(name: str, query_p: Tensor, tables, d_dim: int, f_dim: int,
           instances) -> None:
    if (d_dim, f_dim) not in instances:
        raise ValueError(f"{name}: no kernel instance for D = {d_dim} and "
                         f"payload width {f_dim} (instances (D, width): "
                         f"{instances})")
    if query_p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {query_p.device}")
    for tname, x, dt in tables:
        if x.dtype != dt:
            raise TypeError(f"{name}: {tname} must be {dt}, got {x.dtype}")
        if x.device != query_p.device or not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous on "
                             f"{query_p.device}")


def _batched(query_p: Tensor, dbf_cm: Tensor, d_dim: int):
    """Flatten the batch dims into one grid axis: (B, Qp, D) queries and
    (B, D + F, m_pad) dbs, contiguous; a shared db is broadcast."""
    *batch, qp, d = query_p.shape
    if d != d_dim or dbf_cm.shape[-1] % _STAGE or qp % SUB:
        raise ValueError(f"bad shapes: query {tuple(query_p.shape)}, db "
                         f"{tuple(dbf_cm.shape)} (Qp a multiple of {SUB}, "
                         f"m_pad of {_STAGE})")
    dbf_cm = dbf_cm.expand(*batch, *dbf_cm.shape[-2:])
    return (batch, query_p.reshape(-1, qp, d).contiguous(),
            dbf_cm.reshape(-1, *dbf_cm.shape[-2:]).contiguous())


def nn_sweep(query_p: Tensor, db_cm: Tensor):
    """Kernel 5 on a CUDA tensor, its plain version on a CPU tensor.
    query_p (..., Qp, D), Qp a multiple of SUB; db_cm (..., D, m_pad).
    Returns (dist, idx) before sentinel trimming."""
    if query_p.device.type == "cpu":
        return nn_sweep_plain(query_p, db_cm)
    args, out, _keep = _nn_sweep_args(query_p, db_cm)
    status = cuda_build.launcher("nn_sweep")(*args)
    cuda_build.LAUNCHES["nn_sweep"] += 1
    cuda_build.check(status, "nn_sweep")
    return out


def nn_matched(query_p: Tensor, dbf_cm: Tensor, d_dim: int):
    """Kernel 4 on a CUDA tensor, its plain version on a CPU tensor.
    query_p (..., Qp, D); dbf_cm (..., D + F, m_pad).  Returns (dist, idx,
    pay (..., Qp, F)) before sentinel trimming."""
    if query_p.device.type == "cpu":
        return nn_matched_plain(query_p, dbf_cm, d_dim)
    args, out, _keep = _nn_matched_args(query_p, dbf_cm, d_dim)
    status = cuda_build.launcher("nn_matched")(*args)
    cuda_build.LAUNCHES["nn_matched"] += 1
    cuda_build.check(status, "nn_matched")
    return out


def _nn_sweep_args(query_p: Tensor, db_cm: Tensor, item_chunks=None,
                   q_per_thread: int = MATCHED_Q):
    """Kernel 5's launch, as ``_nn_matched_args`` with no payload rows:
    (the launcher's arguments, (dist, idx), what the caller holds)."""
    return _items_args("nn_sweep", query_p, db_cm, db_cm.shape[-2],
                       item_chunks, q_per_thread)


def _nn_matched_args(query_p: Tensor, dbf_cm: Tensor, d_dim: int,
                     item_chunks=None, q_per_thread: int = MATCHED_Q):
    """Kernel 4's launch: (the launcher's arguments, (dist, idx, pay),
    what the caller holds); see ``_items_args``."""
    return _items_args("nn_matched", query_p, dbf_cm, d_dim, item_chunks,
                       q_per_thread)


def _items_args(name: str, query_p: Tensor, dbf_cm: Tensor, d_dim: int,
                item_chunks, q_per_thread: int):
    """Check the CUDA inputs of kernel 4 (``name`` "nn_matched") or 5
    ("nn_sweep", no payload) and allocate their outputs and scratch.
    ``item_chunks``: chunks a work item, by default
    ``matched_item_chunks``.  Returns (the launcher's arguments, the
    outputs with the batch dims of query_p: (dist, idx, pay) for kernel 4,
    (dist, idx) for kernel 5; the flattened inputs and the scratch, which
    the caller holds until the launch is enqueued)."""
    f_dim = dbf_cm.shape[-2] - d_dim
    _check(name, query_p, (("query", query_p, torch.float32),
                           ("dbf_cm", dbf_cm, torch.float32)),
           d_dim, f_dim,
           MATCHED_INSTANCES if name == "nn_matched" else SWEEP_INSTANCES)
    if q_per_thread not in _PRUNED_Q:
        raise ValueError(f"{name}: queries per thread must be one of "
                         f"{_PRUNED_Q}, got {q_per_thread}")
    batch, q3, db3 = _batched(query_p, dbf_cm, d_dim)
    b, qp, _ = q3.shape
    m_pad = db3.shape[2]
    if item_chunks is None:
        item_chunks = matched_item_chunks(b, qp, m_pad, q_per_thread)
    if db3.data_ptr() % 16 or item_chunks < 1:
        raise ValueError(f"{name}: dbf_cm must be 16-byte aligned and "
                         "work items hold at least one chunk")
    g = MATCHED_THREADS * q_per_thread
    n_groups = -(-qp // g)
    n_items = -(-(m_pad // _STAGE) // item_chunks)
    dev = q3.device
    tickets = _tickets(dev, b * n_groups, name)
    part = torch.empty(b * n_groups * n_items * 2 * g if n_items > 1 else 1,
                       dtype=torch.float32, device=dev)
    dist = torch.empty((b, qp), dtype=torch.float32, device=dev)
    idx = torch.empty((b, qp), dtype=torch.int32, device=dev)
    out = (dist.reshape(*batch, qp), idx.reshape(*batch, qp))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q3.data_ptr(), db3.data_ptr(), dist.data_ptr(), idx.data_ptr())
    if name == "nn_matched":
        pay = torch.empty((b, qp, f_dim), dtype=torch.float32, device=dev)
        out += (pay.reshape(*batch, qp, f_dim),)
        args += (pay.data_ptr(),)
    args += (part.data_ptr(), tickets.data_ptr(), b, qp, d_dim)
    if name == "nn_matched":
        args += (f_dim,)
    args += (m_pad, item_chunks, q_per_thread, stream)
    return args, out, (q3, db3, part)


def nn_pruned(query_p: Tensor, dbf_cm: Tensor, qbox: Tensor, bbox: Tensor,
              qb_tile: Tensor, d_dim: int, q_tile: int, db_tile: int):
    """Kernel 6 on a CUDA tensor, its plain version on a CPU tensor.
    query_p (Qp, D), Qp a multiple of q_tile, q_tile of SUB; dbf_cm
    (D + F, m_pad), m_pad a multiple of db_tile, db_tile of 128; qbox
    (Qp / q_tile, 8); bbox (m_pad / db_tile, 8); qb_tile (Qp / q_tile,).
    Returns (dist, idx, pay (Qp, F)) before sentinel trimming."""
    qp = query_p.shape[0]
    m_pad = dbf_cm.shape[1]
    if (query_p.ndim != 2 or query_p.shape[1] != d_dim or qp % q_tile
            or q_tile % SUB or db_tile % _STAGE or m_pad % db_tile
            or qbox.shape != (qp // q_tile, 8)
            or bbox.shape != (m_pad // db_tile, 8)
            or qb_tile.shape != (qp // q_tile,)):
        raise ValueError("nn_pruned: bad shapes")
    if query_p.device.type == "cpu":
        return nn_pruned_plain(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim,
                               q_tile, db_tile)
    args, out, _part = _nn_pruned_args(query_p, dbf_cm, qbox, bbox, qb_tile,
                                       d_dim, q_tile, db_tile)
    status = cuda_build.launcher("nn_pruned")(*args)
    cuda_build.LAUNCHES["nn_pruned"] += 1
    cuda_build.check(status, "nn_pruned")
    return out


def prepare_pruned(query: Tensor, db: Tensor, db_mask=None, payload=None,
                   q_tile: int = 512, db_tile: int = 2048, q_bound=None,
                   dbf_cm=None):
    """Kernel 6's inputs for one cloud, as ``_nn_pruned_2d`` builds them:
    (query_p, dbf_cm, qbox, bbox, qb_tile).  Missing bounds are +inf;
    padded queries carry -inf."""
    q, d_dim = query.shape
    q_pad = _round_up(q, q_tile)
    query_p = torch.zeros((q_pad, d_dim), dtype=query.dtype,
                          device=query.device)
    query_p[:q] = query
    if dbf_cm is None:
        pay = db[..., :0] if payload is None else payload
        dbf_cm = _dbf_cm_matched(db, db_mask, pay,
                                 _round_up(db.shape[-2], db_tile))
    if q_bound is None:
        qb_p = torch.full((q_pad,), float("inf"), dtype=query.dtype,
                          device=query.device)
    else:
        qb_p = torch.full((q_pad,), float("-inf"), dtype=query.dtype,
                          device=query.device)
        qb_p[:q] = q_bound.to(query.dtype)
    return (query_p, dbf_cm, _query_boxes(query_p, q_tile),
            _tile_boxes(dbf_cm[:d_dim], db_tile), _qb_tile(qb_p, q_tile))


def search(query: Tensor, db: Tensor, db_mask=None, payload=None,
           q_tile: int = 512, db_tile: int = 2048, q_bound=None,
           dbf_cm=None):
    """Exact 1-NN of query (..., Q, D) in db (..., M, D) through kernels 4,
    5 and 6, routed as ``nn_pallas.nn_pallas`` / ``nn_pallas_matched``
    route compiled calls: a single cloud whose db spans 3 tiles or more
    takes kernel 6, any other call the plain sweep (kernel 5 without a
    payload, kernel 4 with one).  ``dbf_cm`` reuses a packed db.  Returns
    (idx (..., Q) int32, dist (..., Q), pay (..., Q, F) or None)."""
    if q_tile % SUB or db_tile % _STAGE:
        raise ValueError(f"q_tile must be a multiple of {SUB} and db_tile "
                         f"of {_STAGE}, got {q_tile}, {db_tile}")
    *batch, q, d_dim = query.shape
    m_pad = _round_up(db.shape[-2], db_tile)
    if not batch and m_pad // db_tile >= 3:
        args = prepare_pruned(query, db, db_mask, payload, q_tile, db_tile,
                              q_bound, dbf_cm)
        dist, idx, pay = nn_pruned(*args, d_dim, q_tile, db_tile)
    else:
        q_pad = _round_up(q, q_tile)
        query_p = torch.zeros((*batch, q_pad, d_dim), dtype=query.dtype,
                              device=query.device)
        query_p[..., :q, :] = query
        if dbf_cm is None:
            pay = db[..., :0] if payload is None else payload
            dbf_cm = _dbf_cm_matched(db, db_mask, pay, m_pad)
        dbf_cm = dbf_cm.expand(*batch, *dbf_cm.shape[-2:])
        if payload is None:
            (dist, idx), pay = nn_sweep(query_p, dbf_cm), None
        else:
            dist, idx, pay = nn_matched(query_p, dbf_cm, d_dim)
    dist = _trim_sentinel(dist)
    pay = None if payload is None else pay[..., :q, :]
    return idx[..., :q], dist[..., :q], pay
