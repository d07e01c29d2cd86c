"""Voxel-grid downsampling with fixed output capacity (JAX package
``ops/voxel.py``), used by the re-voxelize path of ``models/submap``.

Points are keyed by their integer cell coordinates (clipped to 1024 per
axis so the linear id fits int32), sorted by id (a stable sort, as
``jnp.argsort`` is), and reduced to per-voxel centroids.  The reduction is
a sorted segment sum (``torch.segment_reduce``), not a scatter-add: on the
card ``index_add_`` sums with float atomics in an order that changes from
run to run, while a segment sum adds each voxel's points in their sorted
order, which is also the order of the JAX package's scatter-add on the
CPU.  Everything is fixed-shape and masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

_MAX_CELLS_PER_AXIS = 1024


class VoxelResult(NamedTuple):
    points: Tensor   # (capacity, D) voxel centroids (zeros where invalid)
    mask: Tensor     # (capacity,) validity
    n_cells: Tensor  # () int: occupied voxel count BEFORE truncation; if
                     # > capacity, cells were dropped (in cell-id order)
                     # and callers should grow capacity


def cell_coords(points: Tensor, lo: Tensor, voxel_size: float) -> Tensor:
    """floor((points - lo) / voxel_size) as int32.  The quotient is clamped
    to [-1, 1024] in float first: a float beyond int32 has no defined
    conversion (CPU and CUDA differ), and every caller only tells cells in
    [0, 1024) apart from the rest.  A tensor divisor keeps the division a
    true one (a Python scalar may become a multiply by its reciprocal on
    the card)."""
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    q = torch.floor((points - lo) / vs)
    return torch.clamp(q, -1.0, float(_MAX_CELLS_PER_AXIS)).to(torch.int32)


def segment_sums(rows: Tensor, seg: Tensor, n_seg: int) -> Tensor:
    """Per-segment sums of ``rows`` (N, K) whose segment ids ``seg`` (N,)
    ascend, as (n_seg, K): each segment summed in row order, the same on
    every run and device."""
    lengths = torch.zeros(n_seg, dtype=torch.int64, device=rows.device)
    lengths.scatter_add_(0, seg.to(torch.int64),
                         torch.ones_like(seg, dtype=torch.int64))
    # The lengths are integer counts (order-free) that sum to N by
    # construction: ``unsafe`` skips the check, a device-to-host read.
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def voxel_downsample(points: Tensor, mask: Tensor, voxel_size: float,
                     capacity: int) -> VoxelResult:
    """points: (N, D); mask: (N,).  Returns up to ``capacity`` voxel
    centroids.  Voxels beyond capacity (in cell-id order) are dropped;
    callers size capacity generously."""
    n, d = points.shape
    dtype, dev = points.dtype, points.device
    big = torch.iinfo(torch.int32).max
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    lo = torch.amin(torch.where(mask[:, None], points, inf), dim=0)
    cells = torch.clamp(cell_coords(points, lo, voxel_size), 0,
                        _MAX_CELLS_PER_AXIS - 1)
    cell_id = cells[:, 0]
    for k in range(1, d):
        cell_id = cell_id * _MAX_CELLS_PER_AXIS + cells[:, k]
    cell_id = torch.where(mask, cell_id, torch.full_like(cell_id, big))

    order = torch.argsort(cell_id, stable=True)
    sid = cell_id[order]
    spts = points[order]
    svalid = sid != big

    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sid[1:] != sid[:-1]]) & svalid
    seg = torch.cumsum(first.to(torch.int32), dim=0) - 1
    # Invalid rows and voxels beyond capacity land in the overflow row.
    seg = torch.where(svalid, torch.clamp(seg, 0, capacity),
                      torch.full_like(seg, capacity))
    wf = svalid.to(dtype)[:, None]
    acc = segment_sums(torch.cat([spts * wf, wf], dim=-1), seg, capacity + 1)
    cnt = acc[:capacity, d]
    out_mask = cnt > 0
    centroids = acc[:capacity, :d] / torch.clamp(cnt[:, None], min=1.0)
    centroids = torch.where(out_mask[:, None], centroids,
                            torch.zeros_like(centroids))
    return VoxelResult(points=centroids, mask=out_mask,
                       n_cells=torch.sum(first.to(torch.int32)))
