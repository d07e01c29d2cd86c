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

All three kernels take queries ``SUB`` at a time, one block per group and
one thread per query, and stage the coordinate-major db
(``_dbf_cm_matched``: D sentinel-filled coordinate rows, then F payload
rows) through shared memory 128 points at a time.

- Kernels 4 and 5 sweep every point in ascending order with a strict '<'
  on a scalar (distance, index, payload) carry: the lowest index wins
  ties.  A leading batch axis is one more grid axis.
- Kernel 6 visits the db tiles of its query tile ``i`` diagonal first:
  tiles s..n-1 ascending, then s-1..0 descending, s = i q_tile // db_tile.
  Its carry update is lexicographic on (distance, index), so the lowest
  index wins ties in any visit order.  A tile (after tile 0 of the order)
  is skipped when the squared distance between the query tile's box and
  the db tile's box, deflated by 1 - 16 eps, is above the block's
  threshold min(max of its queries' current bests, qb_tile[i]).  A skipped
  tile holds no point of any of the block's queries' tie sets, so the
  result is the unpruned sweep's, bit for bit.  The threshold is taken
  over the block's ``SUB`` queries, not over the whole query tile as on
  the TPU: it is smaller or equal, and exact for the same reason.

With no valid db point a query gets (+inf, 0, 0): sentinel distances
overflow to +inf in float32 and never win a strict compare.  ``search``
trims distances at or above sentinel²/4 to +inf, which makes float64 (a
CPU-only type here) follow the same contract.  Distances are summed
((0 + dx²) + dy²) + dz² with every rounding explicit (kernels built with
--fmad=false), the plain versions' order, so kernel and plain version
agree bitwise.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import cuda_build
from icp_rust_tpu_torch.ops.nn_cuda import _dbf_cm_matched, _round_up, \
    _tile_boxes, _trim_sentinel

SUB = 128
_STAGE = 128
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


def _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim: int,
                  q_tile: int, db_tile: int):
    """Kernel 6's visit order, prune test and carry update, vectorised over
    its blocks of SUB queries.  Returns (dist, idx, pay, tiles walked)."""
    qp = query_p.shape[0]
    f_dim = dbf_cm.shape[0] - d_dim
    n_db = dbf_cm.shape[1] // db_tile
    n_blk = qp // SUB
    dev, dt = query_p.device, query_p.dtype
    blk_qt = torch.arange(n_blk, device=dev) * SUB // q_tile
    start = blk_qt * q_tile // db_tile
    tiles = dbf_cm.reshape(d_dim + f_dim, n_db, db_tile)
    q_b = query_p.reshape(n_blk, SUB, d_dim)
    lb = torch.zeros((n_blk, n_db), dtype=dt, device=dev)
    for k in range(d_dim):
        a = bbox[None, :, k] - qbox[blk_qt][:, None, 4 + k]
        b = qbox[blk_qt][:, None, k] - bbox[None, :, 4 + k]
        gap = torch.clamp(torch.maximum(a, b), min=0.0)
        lb = lb + gap * gap
    lb = lb * (1.0 - 16.0 * torch.finfo(dt).eps)
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
    """Plain PyTorch version of kernel 6, in its visit order, with its prune
    test and lexicographic carry.  Returns (dist, idx, pay)."""
    return _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim,
                         q_tile, db_tile)[:3]


def tiles_walked(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim: int,
                 q_tile: int, db_tile: int) -> int:
    """The (block, db tile) sweeps kernel 6 makes on these inputs: its
    prune decisions follow the carries, which are bitwise the plain
    version's."""
    return _pruned_sweep(query_p, dbf_cm, qbox, bbox, qb_tile, d_dim,
                         q_tile, db_tile)[3]


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
    d_dim = db_cm.shape[-2]
    _check("nn_sweep", query_p, (("query", query_p, torch.float32),
                                 ("db_cm", db_cm, torch.float32)),
           d_dim, 0, SWEEP_INSTANCES)
    batch, q3, db3 = _batched(query_p, db_cm, d_dim)
    b, qp, _ = q3.shape
    dist = torch.empty((b, qp), dtype=torch.float32, device=q3.device)
    idx = torch.empty((b, qp), dtype=torch.int32, device=q3.device)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    status = cuda_build.launcher("nn_sweep")(
        q3.data_ptr(), db3.data_ptr(), dist.data_ptr(), idx.data_ptr(), b,
        qp, d_dim, db3.shape[2], stream)
    cuda_build.LAUNCHES["nn_sweep"] += 1
    cuda_build.check(status, "nn_sweep")
    return dist.reshape(*batch, qp), idx.reshape(*batch, qp)


def nn_matched(query_p: Tensor, dbf_cm: Tensor, d_dim: int):
    """Kernel 4 on a CUDA tensor, its plain version on a CPU tensor.
    query_p (..., Qp, D); dbf_cm (..., D + F, m_pad).  Returns (dist, idx,
    pay (..., Qp, F)) before sentinel trimming."""
    if query_p.device.type == "cpu":
        return nn_matched_plain(query_p, dbf_cm, d_dim)
    f_dim = dbf_cm.shape[-2] - d_dim
    _check("nn_matched", query_p, (("query", query_p, torch.float32),
                                   ("dbf_cm", dbf_cm, torch.float32)),
           d_dim, f_dim, MATCHED_INSTANCES)
    batch, q3, db3 = _batched(query_p, dbf_cm, d_dim)
    b, qp, _ = q3.shape
    dev = q3.device
    dist = torch.empty((b, qp), dtype=torch.float32, device=dev)
    idx = torch.empty((b, qp), dtype=torch.int32, device=dev)
    pay = torch.empty((b, qp, f_dim), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = cuda_build.launcher("nn_matched")(
        q3.data_ptr(), db3.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        pay.data_ptr(), b, qp, d_dim, f_dim, db3.shape[2], stream)
    cuda_build.LAUNCHES["nn_matched"] += 1
    cuda_build.check(status, "nn_matched")
    return (dist.reshape(*batch, qp), idx.reshape(*batch, qp),
            pay.reshape(*batch, qp, f_dim))


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
    f_dim = dbf_cm.shape[0] - d_dim
    _check("nn_pruned", query_p, (("query", query_p, torch.float32),
                                  ("dbf_cm", dbf_cm, torch.float32),
                                  ("qbox", qbox, torch.float32),
                                  ("bbox", bbox, torch.float32),
                                  ("qb_tile", qb_tile, torch.float32)),
           d_dim, f_dim, PRUNED_INSTANCES)
    dev = query_p.device
    dist = torch.empty((qp,), dtype=torch.float32, device=dev)
    idx = torch.empty((qp,), dtype=torch.int32, device=dev)
    pay = torch.empty((qp, f_dim), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = cuda_build.launcher("nn_pruned")(
        query_p.data_ptr(), dbf_cm.data_ptr(), qbox.data_ptr(),
        bbox.data_ptr(), qb_tile.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        pay.data_ptr() if f_dim else None, qp, q_tile, db_tile, d_dim, f_dim,
        m_pad, stream)
    cuda_build.LAUNCHES["nn_pruned"] += 1
    cuda_build.check(status, "nn_pruned")
    return dist, idx, pay


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
