"""Exact 1-nearest-neighbor correspondence search.

Replacement for the reference's KdTree dependency (exact 1-NN, used at
src/lib.rs:99,121,141,164).  Tie-break: the lowest database index.

Distance methods (config.nn_method):
- ``"direct"``: per-coordinate squared differences, no cancellation beyond
  the inputs' rounding: the parity-exact choice, and the only one the
  kernels compute;
- ``"mxu"``: |q|^2 + |d|^2 - 2 q.d with the cross term a float32
  ``torch.matmul`` (the JAX package's HIGHEST-precision MXU matmul; TF32
  stays refused, ``config.resolve_device``).  Its ~|p|^2 eps absolute
  error can flip the argmin between near-tied neighbours, and a distance
  may come out slightly negative (not clamped, as in JAX).

Backends (config.nn_backend): ``"torch"`` is ``nn_torch``, a tiled sweep
over the db with a running (best distance, best index) carry, on any
device; ``"cuda"`` the hand-written kernels, their plain versions on a CPU
tensor; ``"auto"`` the kernels for float32 with ``"direct"`` and
``nn_torch`` for float64 or ``"mxu"`` (the f64 reference path is the
plain one, as on the TPU; the kernels compute direct distances only).  An
explicit ``"cuda"`` takes the kernels whatever the method, as the JAX
package's ``"pallas"`` does.  ``route`` is the one place that picks a
kernel (its docstring holds the table); ``NNIndex`` runs the pick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import NN_METHODS, ICPConfig
from icp_rust_tpu_torch.ops import nn_cuda, nn_pairs_cuda, nn_sweep_cuda


class NNResult(NamedTuple):
    index: Tensor    # (..., Q) int32: argmin into the database axis
    dist_sq: Tensor  # (..., Q) squared distance (+inf where db fully masked)


def nn_torch(query: Tensor, db: Tensor, db_mask: Tensor | None = None,
             tile: int = 2048, method: str = "direct") -> NNResult:
    """Tiled brute-force exact 1-NN (the ``nn_xla`` counterpart).

    query: (..., Q, D); db: (..., M, D), or a shared (M, D); db_mask:
    (..., M) or None.  ``method``: "direct" or "mxu" (module docstring).
    Within a tile the first minimum wins; across tiles the carry update is
    a strict '<', so the lowest index wins ties overall."""
    if method not in NN_METHODS:
        raise ValueError(f"nn method must be one of {NN_METHODS}, got "
                         f"{method!r}")
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
    if method == "mxu":
        q_sq = torch.sum(query * query, dim=-1)  # (..., Q)
    for start in range(0, m, tile):
        tdb = db[..., start:start + tile, :]
        if method == "mxu":
            db_sq = torch.sum(tdb * tdb, dim=-1)  # (..., tile)
            cross = torch.matmul(query, tdb.transpose(-1, -2))
            dist = q_sq[..., :, None] + db_sq[..., None, :] - 2.0 * cross
        else:
            dist = torch.zeros((*batch, q_n, tdb.shape[-2]),
                               dtype=query.dtype, device=query.device)
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


class NNRoute(NamedTuple):
    """Which search serves a (query, db) pair, decided once per driver
    call (``route``).  ``kind``: "torch" (``nn_torch`` and a gather),
    "pairs" (the pair-grid kernels 8 and 9), "list" (the survivor-list
    kernel 1 over a packed db) or "sweep" (kernels 4-6,
    ``nn_sweep_cuda.search``); ``pruned_warm``: a warm search with bounds
    takes kernel 8's seed prune instead; ``sort``: the drivers' spatial
    pre-sort, "morton", "azimuth" or None."""

    kind: str
    pruned_warm: bool
    sort: str | None

    @property
    def pack(self) -> bool:
        """Whether the db is packed once for kernel 1."""
        return self.kind == "list"


def route(query: Tensor, db: Tensor, payload_width: int,
          config: ICPConfig, matched: bool = True) -> NNRoute:
    """The NN route of query (..., Q, D) against db (..., M, D) with a
    payload of ``payload_width`` lanes, from shapes, dtype and
    ``config``'s ``nn_backend``, ``nn_method``, ``nn_dst_tile`` and
    ``nn_sort`` alone (the TPU's ``nn_pallas_matched`` routes likewise).
    "Kernels" is ``"cuda"``, or ``"auto"`` with float32 and ``"direct"``;
    "M >= 3 tiles" is M >= 3 nn_dst_tile, "spans 3 tiles" ceil(M / tile)
    >= 3:

    =============================================  ===========  ==========
    matched search                                 kind         auto sort
    =============================================  ===========  ==========
    not kernels                                    torch        None
    batched (B, Q, D), M <= PAIRS_MAX_DB           pairs        Morton if
                                                                M >= 3
                                                                chunks
    batched, M > PAIRS_MAX_DB and M >= 3 tiles     sweep,       Morton
                                                   pruned_warm
    one cloud, D + P <= 8, db spans 3 tiles        list         Morton if
                                                                M >= 3
                                                                tiles
    anything else on the kernels                   sweep        Morton if
                                                                M >= 3
                                                                tiles
    =============================================  ===========  ==========

    ``pruned_warm``: warm searches with bounds take kernel 8's exact seed
    prune (4-6 % of a sorted db's chunks walked on 95 VLP-16 pairs); the
    cold one keeps kernel 4, 5 % faster with nothing to prune (H100).
    "list" without bounds sweeps its packed db (kernel 6).  An explicit
    ``nn_sort`` overrides the auto sort, which permutes reduction order
    only.  Unmatched: "sweep" (kernel 5 or 6) on the kernels, but "torch"
    for "auto" on a batched db of at most PAIRS_MAX_DB points, where the
    TPU takes ``nn_xla``."""
    m, tile = db.shape[-2], config.nn_dst_tile
    kernels = config.nn_backend == "cuda" or (
        config.nn_backend == "auto" and config.nn_method == "direct"
        and query.dtype == torch.float32)
    batched = query.ndim == 3
    pairs = kernels and batched and m <= nn_pairs_cuda.PAIRS_MAX_DB
    if config.nn_sort != "auto":
        sort = config.nn_sort if config.nn_sort in ("azimuth", "morton") \
            else None
    elif pairs:
        sort = "morton" if m >= 3 * nn_pairs_cuda.CHUNK else None
    else:
        sort = "morton" if kernels and m >= 3 * tile else None
    if not matched:
        small = query.ndim > 2 and m <= nn_pairs_cuda.PAIRS_MAX_DB
        sweep = config.nn_backend == "cuda" or (kernels and not small)
        return NNRoute("sweep" if sweep else "torch", False, sort)
    if not kernels:
        kind = "torch"
    elif pairs:
        kind = "pairs"
    elif (query.ndim == 2 and query.shape[-1] + payload_width <= 8
          and -(-m // tile) >= 3):
        kind = "list"
    else:
        kind = "sweep"
    pruned = (kernels and batched and m > nn_pairs_cuda.PAIRS_MAX_DB
              and m >= 3 * tile)
    return NNRoute(kind, pruned, sort)


def gather_rows(payload: Tensor, index: Tensor) -> Tensor:
    """payload[..., index, :] per batch lane; a shared (M, P) payload is
    broadcast to the index's batch."""
    idx = index.to(torch.int64)
    if idx.ndim == 1:
        return payload[idx]
    payload = payload.expand(*idx.shape[:-1], *payload.shape[-2:])
    return torch.take_along_dim(payload, idx[..., None], dim=-2)


class NNIndex:
    """The db side of a route, built once per driver call (the
    KdTree::new analogue, reference src/lib.rs:97-102): the db, its mask,
    the payload (None: no payload rows) and, where the route packs, the
    packed db of ``nn_cuda.pack_db``."""

    def __init__(self, nn_route: NNRoute, db: Tensor, db_mask, payload,
                 config: ICPConfig):
        self.route, self.db, self.db_mask = nn_route, db, db_mask
        self.payload = payload
        self.tile, self.q_tile = config.nn_dst_tile, config.nn_query_tile
        self.method = config.nn_method
        self.packed = (nn_cuda.pack_db(db, db_mask, payload,
                                       db_tile=self.tile)
                       if nn_route.pack else None)

    def search(self, query: Tensor, q_bound: Tensor | None = None,
               warm: bool | None = None):
        """(NNResult, the winners' payload rows or None) of ``query``.
        ``q_bound`` (..., Q) is an upper bound on each query's NN
        distance² (+inf where unknown) and ``warm`` selects the seeded
        search's cold/warm branch (None decides from the bounds); results
        are bit-identical whatever they are, as long as the bounds are
        valid."""
        kind, pay = self.route.kind, self.payload
        if kind == "torch":
            res = nn_torch(query, self.db, self.db_mask, tile=self.tile,
                           method=self.method)
            return res, None if pay is None else gather_rows(pay, res.index)
        if kind == "pairs" or (self.route.pruned_warm and warm is True
                               and q_bound is not None):
            idx, dist, rows = nn_pairs_cuda.nn_pairs_matched(
                query, self.db, self.db_mask, pay, q_bound=q_bound,
                warm=warm)
            return NNResult(index=idx, dist_sq=dist), rows
        if kind == "sweep" or q_bound is None:
            dbf_cm = None if self.packed is None else self.packed.dbf_cm
            idx, dist, rows = nn_sweep_cuda.search(
                query, self.db, self.db_mask, pay, self.q_tile, self.tile,
                q_bound, dbf_cm)
            return NNResult(index=idx, dist_sq=dist), rows
        q_n, d_dim = query.shape
        q_pad = -(-q_n // self.q_tile) * self.q_tile
        query_p = torch.zeros((q_pad, d_dim), dtype=query.dtype,
                              device=query.device)
        query_p[:q_n] = query
        # Padded queries get -inf: their (discarded) results may then
        # prune everything.
        qb_p = torch.full((q_pad,), float("-inf"), dtype=query.dtype,
                          device=query.device)
        qb_p[:q_n] = q_bound.to(query.dtype)
        dist, idx, rows = nn_cuda.nn_seeded(query_p, self.packed, qb_p,
                                            d_dim, self.q_tile, warm=warm)
        dist = nn_cuda._trim_sentinel(dist)
        return NNResult(index=idx[:q_n], dist_sq=dist[:q_n]), rows[:q_n]


def nearest_neighbor(query: Tensor, db: Tensor, db_mask=None,
                     backend: str = "auto", tile: int = 2048,
                     q_tile: int = 512, method: str = "direct") -> NNResult:
    """Exact 1-NN without payload (``ops/nn.nearest_neighbor``), one
    search on ``route``'s unmatched route: on the kernels kernel 6 for one
    cloud whose db spans 3 tiles or more, kernel 5 otherwise
    (``nn_sweep_cuda.search``)."""
    cfg = ICPConfig(nn_backend=backend, nn_method=method, nn_dst_tile=tile,
                    nn_query_tile=q_tile)
    nn_route = route(query, db, 0, cfg, matched=False)
    return NNIndex(nn_route, db, db_mask, None, cfg).search(query)[0]


def nearest_neighbor_matched(query: Tensor, db: Tensor, db_mask=None,
                             payload=None, backend: str = "auto",
                             tile: int = 2048, q_tile: int = 256,
                             q_bound: Tensor | None = None,
                             warm: bool | None = None,
                             method: str = "direct"):
    """1-NN that also returns the winner's payload (default: the matched
    db point): one search on ``route``'s matched route
    (``NNIndex.search`` for ``q_bound`` and ``warm``).  Returns
    (NNResult, matched (..., Q, P))."""
    if payload is None:
        payload = db
    cfg = ICPConfig(nn_backend=backend, nn_method=method, nn_dst_tile=tile,
                    nn_query_tile=q_tile)
    nn_route = route(query, db, payload.shape[-1], cfg)
    return NNIndex(nn_route, db, db_mask, payload, cfg).search(
        query, q_bound, warm)
