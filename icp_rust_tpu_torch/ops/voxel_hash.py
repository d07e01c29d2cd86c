"""Persistent voxel hash map: the rolling map of ``models/submap`` (JAX
package ``ops/voxel_hash.py``).

An open-addressing table of fixed capacity (a power of two): per slot a
cell key (int32, EMPTY = int32 max), a point sum (D,) and a count.  Cells
are keyed on a fixed world-anchored 1024^D grid (the origin is chosen once,
from frame 0), so ids are stable across frames and insertion is
incremental.  Insertion resolves collisions by double hashing in a fixed
number of probe rounds; each round gathers the current keys, claims empty
slots with a scatter-min over competing cell ids, and lets the points
whose slot now holds their cell win.  Points that exhaust their probes
(or fall outside the cell box, or overflow a compaction stage) are counted
in ``dropped``.  A slot only ever accumulates points of its own cell, so a
centroid is exactly the mean of its voxel's points.

The table is the JAX package's, slot for slot:

- The hashes are uint32 products shifted right.  PyTorch lacks uint32
  arithmetic on most devices, so they run in int64 on values below 2^32,
  each product split so that no intermediate passes 2^49, masked back to
  32 bits (``_mul_u32``).
- The claim is ``scatter_reduce_(..., "amin")`` on int32: one result in any
  order.
- Every argsort is stable, as ``jnp.argsort(..., stable=True)`` is.
- Out-of-box points are clamped in float before the int cast (see
  ``ops/voxel.cell_coords``), so they are dropped, never aliased.

Determinism of the sums: every point of one cell probes the same slot
sequence, so all of a cell's points in one insert win in the same round at
the same slot, in their input order (compaction sorts stably by a per-cell
key).  The port therefore records each point's winning slot across the
rounds and adds the sums once at the end as a sorted segment sum over
[old slot value, its points in input order] (``_accumulate``): the JAX
package's scatter-add order on the CPU, bitwise, and the same on every run
on the card, where ``index_add_`` would sum with float atomics in an order
that changes from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops.voxel import cell_coords, segment_sums

_EMPTY = torch.iinfo(torch.int32).max
_CELLS_PER_AXIS = 1024  # 1024^3 = 2^30 fits int32 with room for _EMPTY
_U32 = 0xFFFFFFFF
_HASH_A = 2654435761
_HASH_B = 2246822519


class VoxelHashMap(NamedTuple):
    key: Tensor     # (capacity,) int32 cell id; _EMPTY where unoccupied
    psum: Tensor    # (capacity, D) running point sums
    cnt: Tensor     # (capacity,) occupancy counts
    origin: Tensor  # (D,) world position of cell (0, ..., 0)


def make_map(capacity: int, dim: int, origin: Tensor,
             dtype=torch.float32) -> VoxelHashMap:
    """Empty table on ``origin``'s device.  ``capacity`` must be a power of
    two."""
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    dev = origin.device
    return VoxelHashMap(
        key=torch.full((capacity,), _EMPTY, dtype=torch.int32, device=dev),
        psum=torch.zeros((capacity, dim), dtype=dtype, device=dev),
        cnt=torch.zeros((capacity,), dtype=dtype, device=dev),
        origin=origin.to(dtype),
    )


def origin_for(points: Tensor, mask: Tensor, voxel_size: float) -> Tensor:
    """World origin centring the 1024^D cell box on the cloud's mean:
    compute once (from frame 0) and reuse for every insert."""
    maskf = mask.to(points.dtype)[:, None]
    mean = torch.sum(points * maskf, dim=0) / torch.clamp(
        torch.sum(maskf), min=1.0)
    return mean - 0.5 * _CELLS_PER_AXIS * voxel_size


def _cell_ids(points: Tensor, mask: Tensor, origin: Tensor,
              voxel_size: float):
    """(cid int32, valid): out-of-box points are invalid, not clipped."""
    cells = cell_coords(points, origin, voxel_size)
    in_box = torch.all((cells >= 0) & (cells < _CELLS_PER_AXIS), dim=-1)
    cells = torch.clamp(cells, 0, _CELLS_PER_AXIS - 1)
    cid = cells[..., 0]
    for k in range(1, points.shape[-1]):
        cid = cid * _CELLS_PER_AXIS + cells[..., k]
    return cid, mask & in_box


def _mul_u32(a: Tensor, b: int) -> Tensor:
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a constant b < 2^32:
    uint32 multiplication with every intermediate below 2^49."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hashes(cid: Tensor, capacity: int):
    """Home slot and odd probe step of each cell id (int64): the top
    log2(capacity) bits of two multiplicative hashes."""
    shift = 32 - int(capacity).bit_length() + 1
    cidu = cid.to(torch.int64) & _U32
    h = _mul_u32(cidu, _HASH_A) >> shift
    # Odd step -> full cycle over the power-of-two table.
    stp = (_mul_u32(cidu, _HASH_B) >> shift) | 1
    return h, stp


def _scramble(cid: Tensor, salt: int) -> Tensor:
    """The salted per-cell sort key of a compaction stage (int64 in
    [0, 2^30))."""
    cu = cid.to(torch.int64) & _U32
    s = _mul_u32(torch.tensor(int(salt) & _U32, dtype=torch.int64,
                              device=cid.device), _HASH_A)
    scram = _mul_u32(cu ^ s, _HASH_B) >> 5
    return scram & 0x3FFFFFFF


def _accumulate(acc: Tensor, vals: Tensor, win: Tensor) -> Tensor:
    """acc (C, K) with each point's row of vals (N, K) added at its winning
    slot win (N,) (C where it won none), in the JAX package's scatter-add
    order: per slot, the old value, then its points in input order.

    The winners are sorted stably by slot; each touched slot becomes one
    segment [old value, its points] of a (2N + 1)-row array (segment k of
    the sorted run starting at row j puts its old value at j + k and its
    points right after), summed in row order."""
    capacity = acc.shape[0]
    n, dev = win.shape[0], win.device
    order = torch.argsort(win, stable=True)
    s_slot = win[order]
    s_vals = vals[order]
    valid = s_slot < capacity
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       s_slot[1:] != s_slot[:-1]]) & valid
    starts = torch.cumsum(first.to(torch.int64), dim=0)  # segments so far
    rows = torch.arange(n, device=dev)
    combined = torch.zeros((2 * n + 1, acc.shape[1]), dtype=acc.dtype,
                           device=dev)
    combined[rows + starts] = s_vals
    # The old values: one per segment; non-first rows write to the spare
    # last row, which the trailing segment absorbs.
    head = torch.where(first, rows + starts - 1, 2 * n)
    acc_ext = torch.cat([acc, torch.zeros_like(acc[:1])])
    combined[head] = acc_ext[torch.where(first, s_slot,
                                         torch.full_like(s_slot, capacity))]
    # Segment id per combined row: the points and old value of segment k
    # get k; the invalid tail and the spare row get n.
    seg = torch.full((2 * n + 1,), n, dtype=torch.int64, device=dev)
    seg[rows + starts] = torch.where(valid, starts - 1,
                                     torch.full_like(starts, n))
    seg[head] = torch.where(first, starts - 1, torch.full_like(starts, n))
    sums = segment_sums(combined, seg, n + 1)
    # Segment k's slot; untouched segment ids write the spare slot C.
    seg_slot = torch.full((n + 1,), capacity, dtype=torch.int64, device=dev)
    seg_slot[torch.where(first, starts - 1, torch.full_like(starts, n))] = \
        torch.where(first, s_slot, torch.full_like(s_slot, capacity))
    acc_ext[seg_slot] = sums
    return acc_ext[:capacity]


def insert(m: VoxelHashMap, points: Tensor, mask: Tensor, voxel_size: float,
           probes: int = 8, compact_to: int | None = None, salt: int = 0):
    """Accumulate ``points[mask]`` into their voxels.  Returns (updated map,
    dropped count as a 0-d int32 tensor): dropped = points whose cell could
    not claim a slot within ``probes`` rounds (table too full, or more than
    ``compact_to`` points still unresolved after round 1, or more than the
    second stage's width after round 3) plus points outside the fixed
    1024^D cell box around ``m.origin``.

    After round 1 the still-active rows are compacted to ``compact_to``
    (default max(7168, n_rows // 2)), and after round 3 to a quarter of
    that (at least 2048), each keeping the actives with the smallest
    salted per-cell hash, so the overflow is spread over space and rotates
    with ``salt`` (rolling-map callers pass the frame index)."""
    capacity = m.key.shape[0]
    dtype, dev = m.psum.dtype, m.key.device
    dim = points.shape[-1]
    n_rows = points.shape[0]

    cid, active = _cell_ids(points, mask, m.origin, voxel_size)
    n_out_of_box = (torch.sum(mask.to(torch.int32))
                    - torch.sum(active.to(torch.int32)))
    h, stp = _hashes(cid, capacity)
    rows = torch.arange(n_rows, device=dev)
    win = torch.full((n_rows,), capacity, dtype=torch.int64, device=dev)
    key = m.key.clone()
    empty = torch.tensor(_EMPTY, dtype=torch.int32, device=dev)

    def round_(slot, active, cid_r, orig):
        cur = key[slot]
        # Claim empty slots: min over competing cids (claims never touch
        # occupied slots; those points re-probe next round).
        claim = torch.where(active & (cur == _EMPTY), cid_r, empty)
        key.scatter_reduce_(0, slot, claim, reduce="amin")
        won = active & (key[slot] == cid_r)
        # orig is a set of distinct rows: a plain (deterministic) write.
        win[orig] = torch.where(won, slot, win[orig])
        return active & ~won

    slot, cid_r, orig = h, cid, rows
    active = round_(slot, active, cid_r, orig)
    slot = (slot + stp) & (capacity - 1)

    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if compact_to is None:
        compact_to = max(7168, n_rows // 2)

    def compact(keep, extra_salt, slot, stp, active, cid_r, orig):
        big = torch.iinfo(torch.int32).max
        sort_key = torch.where(active, _scramble(cid_r, salt + extra_salt),
                               torch.full_like(cid_r, big, dtype=torch.int64))
        idx = torch.argsort(sort_key, stable=True)[:keep]
        kept = active[idx]
        lost = (torch.sum(active.to(torch.int32))
                - torch.sum(kept.to(torch.int32)))
        return lost, slot[idx], stp[idx], kept, cid_r[idx], orig[idx]

    compact2 = max(2048, compact_to // 4)
    n_r2 = n_rows
    if probes > 1 and n_rows > compact_to:
        lost, slot, stp, active, cid_r, orig = compact(
            compact_to, 0, slot, stp, active, cid_r, orig)
        overflow = overflow + lost
        n_r2 = compact_to
    for r in range(probes - 1):
        # Second stage after probe round 3 (r == 2), only when at least
        # two narrower rounds remain to amortize the sort.
        if r == 2 and probes - 1 - r >= 2 and n_r2 > compact2:
            lost, slot, stp, active, cid_r, orig = compact(
                compact2, 1, slot, stp, active, cid_r, orig)
            overflow = overflow + lost
        active = round_(slot, active, cid_r, orig)
        slot = (slot + stp) & (capacity - 1)

    dropped = torch.sum(active.to(torch.int32)) + n_out_of_box + overflow
    vals = torch.cat([points.to(dtype),
                      torch.ones((n_rows, 1), dtype=dtype, device=dev)],
                     dim=-1)
    acc = _accumulate(torch.cat([m.psum, m.cnt[:, None]], dim=1), vals, win)
    return (m._replace(key=key, psum=acc[:, :dim], cnt=acc[:, dim]),
            dropped.to(torch.int32))


def centroids(m: VoxelHashMap):
    """(points (capacity, D), mask): voxel centroids in slot order."""
    occ = m.cnt > 0
    pts = m.psum / torch.clamp(m.cnt, min=1.0)[:, None]
    return torch.where(occ[:, None], pts, torch.zeros_like(pts)), occ
