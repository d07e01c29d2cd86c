"""Grid-hash 1-NN: exact nearest neighbour within a capped radius (JAX
package ``ops/gridhash.py``).

The reference's KdTree (src/lib.rs:99,141) is exact and uncapped; scan
matchers cap the correspondence distance anyway (a far match is an outlier
by construction), and the cap gives an O(N) search of fixed shapes:

- build: key every db point by its integer cell (cell edge = the search
  radius r), hash the cell to a table slot, sort the points by slot
  (stable) and record each slot's first row (counts and their cumsum);
- query: a query in cell c can only have an in-radius neighbour in the
  3^D cells around c, so the 3^D neighbour slots are unrolled, each
  slot's first ``bucket_cap`` rows gathered, and a masked argmin taken
  over the 3^D * bucket_cap candidates.

The returned neighbour is the true 1-NN whenever that 1-NN lies strictly
within r and its bucket kept it (a bucket past ``bucket_cap`` drops its
tail; ``overflow_frac`` reports the share of points that are dropped, for
the grid's own cap).  A query with nothing in radius gets (+inf, index
0).  Hash collisions only cost bucket capacity: a colliding cell's points
are extra candidates that lose the distance comparison.

Plain PyTorch on the db's device: the JAX module is XLA (no Pallas
kernel), sorts and gathers of fixed shape.  The hash is int32 with
wrapping multiplies, as ``jnp``'s, and every op is elementwise or a
stable sort, so a grid built on the card equals the CPU's bitwise.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops.nn import NNResult

# Large odd multipliers (Teschner et al. spatial hashing constants).
_PRIMES = (73856093, 19349663, 83492791)


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """Spatial hash over one point cloud, on its device."""

    points: Tensor         # (M, D) sorted by slot
    index: Tensor          # (M,) int32 original db index of each row
    starts: Tensor         # (T + 1,) int32 slot -> first row in points
    counts: Tensor         # (T,) int32 points per slot
    cell_size: Tensor      # () the search radius r
    overflow_frac: Tensor  # () share of valid points beyond bucket_cap in
                           # their slot (0.0 = fully exact)
    table_size: int = 1 << 14
    bucket_cap: int = 16   # candidates kept per slot at query time; the
                           # overflow is computed for this cap


def _hash_cells(cells: Tensor, table_size: int) -> Tensor:
    """cells (..., D) int32 -> (...,) slot in [0, table_size): wrapping
    int32 multiplies, xor, an arithmetic shift, abs (abs(INT_MIN) stays
    negative, as in jnp) and a floor modulo."""
    h = cells[..., 0] * _PRIMES[0]
    for k in range(1, cells.shape[-1]):
        h = h ^ (cells[..., k] * _PRIMES[k])
    h = h ^ (h >> 13)  # cheap avalanche: consecutive cells spread out
    return torch.remainder(torch.abs(h), table_size)


def _cells(points: Tensor, cell_size: Tensor) -> Tensor:
    return torch.floor(points / cell_size).to(torch.int32)


def build_grid(db: Tensor, db_mask: Tensor, cell_size,
               table_size: int = 1 << 14, bucket_cap: int = 16) -> HashGrid:
    """db (M, D), D <= 3; db_mask (M,).  cell_size = the query radius r."""
    m, d = db.shape
    if d > len(_PRIMES):
        raise ValueError(f"the grid hash takes D <= {len(_PRIMES)}, got {d}")
    dev = db.device
    cell_size = torch.as_tensor(cell_size, dtype=db.dtype, device=dev)
    slot = _hash_cells(_cells(db, cell_size), table_size)
    slot = torch.where(db_mask, slot, torch.full_like(slot, table_size))
    order = torch.argsort(slot, stable=True)
    counts = torch.bincount(slot, minlength=table_size + 1).to(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts[:-1], dim=0, dtype=torch.int32)])
    n_valid = torch.clamp(torch.sum(db_mask), min=1)
    overflow = (torch.sum(torch.clamp(counts[:-1] - bucket_cap, min=0))
                .to(db.dtype) / n_valid.to(db.dtype))
    return HashGrid(points=db[order], index=order.to(torch.int32),
                    starts=starts, counts=counts[:-1], cell_size=cell_size,
                    overflow_frac=overflow, table_size=table_size,
                    bucket_cap=bucket_cap)


def _neighbor_offsets(d: int, device) -> Tensor:
    """(3^D, D) int32 offsets in {-1, 0, 1}^D, in itertools order."""
    return torch.tensor(list(itertools.product((-1, 0, 1), repeat=d)),
                        dtype=torch.int32, device=device)


def nn_gridhash(query: Tensor, grid: HashGrid,
                bucket_cap: int | None = None) -> NNResult:
    """query (Q, D) -> NNResult, +inf dist_sq where nothing lies strictly
    within the radius (index 0 there, a safe gather value: mask the
    caller's weights with ``dist_sq < inf``).  ``bucket_cap`` defaults to
    the grid's, which its overflow fraction describes.  Ties go to the
    lowest original db index."""
    if bucket_cap is None:
        bucket_cap = grid.bucket_cap
    q, d = query.shape
    dev = query.device
    r = grid.cell_size
    offs = _neighbor_offsets(d, dev)  # (C, D), C = 3^D
    c = offs.shape[0]
    ncells = _cells(query, r)[:, None, :] + offs[None]  # (Q, C, D)
    slots = _hash_cells(ncells, grid.table_size).to(torch.int64)
    start = grid.starts[slots]  # (Q, C)
    cnt = grid.counts[slots]

    k_iota = torch.arange(bucket_cap, dtype=torch.int32, device=dev)
    rows = start[..., None] + k_iota  # (Q, C, K)
    valid = k_iota < cnt[..., None]
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    flat = rows.reshape(q, c * bucket_cap).to(torch.int64)
    cand = grid.points[flat]  # (Q, CK, D)
    # Squared distance summed over the dims in order, one rounding per op.
    d2 = None
    for k in range(d):
        diff = cand[..., k] - query[:, None, k]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    # Strict '<': the 3^D neighbourhood covers every point closer than r,
    # not one at exactly r.
    vmask = valid.reshape(q, c * bucket_cap) & (d2 < r * r)
    d2 = torch.where(vmask, d2, torch.full_like(d2, float("inf")))
    best = torch.amin(d2, dim=-1)
    big = torch.iinfo(torch.int32).max
    orig = grid.index[flat]
    idx = torch.amin(torch.where((d2 == best[:, None]) & vmask, orig,
                                 torch.full_like(orig, big)), dim=-1)
    found = torch.isfinite(best)
    return NNResult(index=torch.where(found, idx, torch.zeros_like(idx)),
                    dist_sq=best)
