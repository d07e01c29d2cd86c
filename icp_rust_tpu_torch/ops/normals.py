"""Surface normals and batched k-NN (JAX package ``ops/normals.py``).

The point-to-plane config (BASELINE.json configs[1]) needs the tangent
plane of every destination point:

- ``knn_torch``: exact k-NN by a tiled sweep over the db with a running
  (Q, k) carry, ascending by distance, lower db index first on ties;
- ``estimate_normals``: per-point k-neighbour covariance PCA;
- ``estimate_normals_voxel``: per-VOXEL covariance PCA, the path every
  published p2l number uses (one sorted segment-sum pass instead of an
  O(N^2) k-NN).  Batch axes run as one lane-keyed pass, every lane bitwise
  the unbatched call on it; ``PASSES`` counts the passes and their lanes.

Normals are the smallest-eigenvalue eigenvectors of the covariances
(``linalg.sym3x3_eigh_smallest``), oriented toward the sensor origin, and
flagged invalid where the neighbourhood is degenerate.

Determinism on the card: the voxel moments are a sorted segment sum.  A
scatter-add (``index_add_``) sums with float atomics there, in an order
that changes from run to run; ``torch.segment_reduce`` over the sorted
segments sums each segment in one fixed order, so a frame's normals, and
with them the trajectory, repeat bitwise.  Every sort is stable, as
``jnp.argsort`` is.  The voxel pass waits on the card nowhere: its
scalars are made there (``torch.full``) and it reads nothing back.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import linalg
from icp_rust_tpu_torch.ops.voxel import segment_sums

# Planarity gate on the mid/largest eigenvalue ratio.  The closed-form f32
# eigensolver's error floor is ~2e-4 relative to lam2, so the gate sits
# well above it; real planes have lam1/lam2 = O(1).
_PLANARITY_EPS = 2e-3
_CELLS = 1024  # voxel index box: cells per axis

# Voxel-normal passes and the lanes they ran, one pass an
# ``estimate_normals_voxel`` call whatever its batch; zeroed by
# ``reset_passes`` (held like ``models/pose_graph.SOLVES``).
PASSES = {"voxel_passes": 0, "voxel_lanes": 0}


def reset_passes() -> None:
    PASSES["voxel_passes"] = 0
    PASSES["voxel_lanes"] = 0


def knn_torch(query: Tensor, db: Tensor, k: int,
              db_mask: Tensor | None = None, tile: int = 2048):
    """Exact k-NN (the ``knn_xla`` counterpart): returns (dists_sq (..., Q,
    k), idx (..., Q, k) int32), ascending by distance.  Per db tile the
    carry and the tile's distances are concatenated and stably sorted, so
    ties keep the lower db index first, as ``lax.top_k`` does; with fewer
    than k valid points the tail is (+inf, 0)."""
    dtype = query.dtype
    d = query.shape[-1]
    m = db.shape[-2]
    if db_mask is None:
        db_mask = torch.ones(db.shape[:-1], dtype=torch.bool, device=db.device)
    tile = min(tile, max(m, 1))
    best_d = torch.full((*query.shape[:-1], k), float("inf"), dtype=dtype,
                        device=query.device)
    best_i = torch.zeros((*query.shape[:-1], k), dtype=torch.int32,
                         device=query.device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=query.device)
    for start in range(0, m, tile):
        tdb = db[..., start:start + tile, :]
        dist = torch.zeros((*query.shape[:-1], tdb.shape[-2]), dtype=dtype,
                           device=query.device)
        for kk in range(d):
            diff = query[..., :, kk, None] - tdb[..., None, :, kk]
            dist = dist + diff * diff
        dist = torch.where(db_mask[..., None, start:start + tile], dist, inf)
        idx = torch.arange(start, start + tdb.shape[-2], dtype=torch.int32,
                           device=query.device).expand(dist.shape)
        cat_d = torch.cat([best_d, dist], dim=-1)
        cat_i = torch.cat([best_i, idx], dim=-1)
        best_d, sel = torch.sort(cat_d, dim=-1, stable=True)
        best_d = best_d[..., :k]
        best_i = torch.take_along_dim(cat_i, sel[..., :k], dim=-1)
    return best_d, best_i


def estimate_normals(points: Tensor, mask: Tensor, k: int = 8,
                     tile: int = 2048, orient_to: Tensor | None = None):
    """Per-point unit normals from k-NN covariance PCA.

    points: (..., N, 3); mask: (..., N).  Returns (normals (..., N, 3),
    valid (..., N)): invalid where fewer than 3 true neighbours exist or
    the neighbourhood is degenerate.  Normals satisfy n . (orient_to - p)
    >= 0 (default orient_to = the sensor origin)."""
    dists, idx = knn_torch(points, points, k, mask, tile=tile)
    return _pca_normals_from_knn(points, mask, dists, idx, orient_to)


def _orient(normals: Tensor, points: Tensor, orient_to) -> Tensor:
    if orient_to is None:
        orient_to = torch.zeros(points.shape[-1], dtype=points.dtype,
                                device=points.device)
    # The dot as explicit adds in axis order: a reduction kernel may pick
    # its order by the tensor's shape, and this sign decides the normal.
    v = normals * (orient_to - points)
    dot = v[..., 0]
    for kk in range(1, v.shape[-1]):
        dot = dot + v[..., kk]
    sign = torch.sign(dot)[..., None]
    return normals * torch.where(sign == 0, torch.ones_like(sign), sign)


def _planar(evals: Tensor, eps: float) -> Tensor:
    tiny = torch.finfo(evals.dtype).tiny
    return evals[..., 1] > eps * torch.clamp(evals[..., 2], min=tiny)


def _pca_normals_from_knn(points, mask, dists, idx, orient_to):
    finite = torch.isfinite(dists)  # (..., N, k)
    *batch, n_pts, dim = points.shape
    k = idx.shape[-1]
    flat_idx = idx.reshape(*batch, n_pts * k).to(torch.int64)
    safe_idx = torch.where(finite.reshape(flat_idx.shape), flat_idx,
                           torch.zeros_like(flat_idx))
    nbrs = torch.take_along_dim(points, safe_idx[..., None], dim=-2).reshape(
        *batch, n_pts, k, dim)
    w = finite.to(points.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=-2), min=1.0)  # (..., N, 1)
    mean = torch.sum(nbrs * w, dim=-2) / cnt
    cent = (nbrs - mean[..., None, :]) * w
    cov = torch.einsum("...ki,...kj->...ij", cent, cent) / cnt[..., None]
    evals, n = linalg.sym3x3_eigh_smallest(cov)
    n = _orient(n, points, orient_to)
    # Degenerate (collinear / duplicate-point) neighbourhoods have no
    # well-defined plane: the same eigenvalue-ratio gate as the voxel path.
    valid = (mask & (torch.sum(finite, dim=-1) >= 3)
             & _planar(evals, _PLANARITY_EPS))
    return n, valid


def estimate_normals_voxel(points: Tensor, mask: Tensor, voxel_size: float,
                           capacity: int = 1 << 15,
                           orient_to: Tensor | None = None,
                           min_points: int = 3,
                           planarity_eps: float = _PLANARITY_EPS):
    """Per-point unit normals from per-VOXEL covariance PCA.

    Every point inherits the normal of its voxel.  points: (..., N, 3);
    mask: (..., N).  Returns (normals (..., N, 3), valid (..., N)); invalid
    where the voxel has fewer than ``min_points`` members, was dropped by
    ``capacity``, lies outside the 1024-cells-per-axis index box (points
    farther than 1024 * voxel_size from the cloud minimum: invalid, not
    clipped, so far-apart surfaces never blend into one border voxel), or
    is near-collinear (mid eigenvalue < planarity_eps * largest).

    Batch axes run as one lane-keyed pass (a 2-D cloud is a batch of
    one): each lane on its own grid at the same capacity, as the JAX
    package vmaps the function, and every lane bitwise the unbatched call
    on it.  Each call adds one pass and its lanes to ``PASSES``."""
    *batch, n_pts, dim = points.shape
    lanes = math.prod(batch)
    PASSES["voxel_passes"] += 1
    PASSES["voxel_lanes"] += lanes
    pts = points.reshape(lanes, n_pts, dim)
    msk = mask.reshape(lanes, n_pts)
    dtype, dev = points.dtype, points.device
    big = torch.iinfo(torch.int32).max
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    # A tensor divisor: a Python scalar would be multiplied by its
    # reciprocal on the card, and a cell boundary could move by an ulp.
    vs = torch.full((), voxel_size, dtype=dtype, device=dev)

    lo = torch.amin(torch.where(msk[..., None], pts, inf), dim=-2,
                    keepdim=True)
    cells = torch.floor((pts - lo) / vs).to(torch.int32)
    in_box = torch.all((cells >= 0) & (cells < _CELLS), dim=-1)
    cells = torch.clamp(cells, 0, _CELLS - 1)
    cell_id = cells[..., 0]
    for kk in range(1, dim):
        cell_id = cell_id * _CELLS + cells[..., kk]
    cell_id = torch.where(msk & in_box, cell_id,
                          torch.full_like(cell_id, big))

    # Moments accumulate in per-voxel local coordinates (each point minus
    # its cell corner): in global coordinates E[x^2] - mean^2 cancels
    # catastrophically in f32.  The covariance is translation-invariant.
    local = pts - (lo + cells.to(dtype) * voxel_size)

    sid, order = torch.sort(cell_id, dim=-1, stable=True)
    spts = torch.take_along_dim(local, order[..., None], dim=-2)
    svalid = sid != big
    first = torch.cat([torch.ones_like(svalid[:, :1]),
                       sid[:, 1:] != sid[:, :-1]], dim=-1) & svalid
    seg = torch.cumsum(first.to(torch.int32), dim=-1) - 1
    seg = torch.where(svalid, torch.clamp(seg, 0, capacity),
                      torch.full_like(seg, capacity))

    wf = svalid.to(dtype)[..., None]
    # second moments, packed (xx, yy, zz, xy, xz, yz)
    x, y, z = spts[..., 0], spts[..., 1], spts[..., 2]
    m2 = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)
    rows = torch.cat([wf, spts * wf, m2 * wf], dim=-1)  # (B, N, 10)
    # Each lane owns capacity + 1 segments, its overflow row last.  seg
    # ascends within a lane (a cumsum of run starts; invalid rows last, at
    # ``capacity``) and the lane offset across lanes, so the segments
    # partition the rows in order and each voxel sums as it would alone.
    n_seg = capacity + 1
    lane0 = torch.arange(lanes, dtype=torch.int64, device=dev)[:, None]
    acc = segment_sums(rows.reshape(lanes * n_pts, -1),
                       (seg + lane0 * n_seg).reshape(-1), lanes * n_seg)
    acc = acc.reshape(lanes, n_seg, -1)[:, :capacity]
    cnt = acc[..., 0]
    s1 = acc[..., 1:1 + dim]
    s2 = acc[..., 1 + dim:7 + dim]

    c = torch.clamp(cnt, min=1.0)
    mean = s1 / c[..., None]
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    xx = s2[..., 0] / c - mx * mx
    yy = s2[..., 1] / c - my * my
    zz = s2[..., 2] / c - mz * mz
    xy = s2[..., 3] / c - mx * my
    xz = s2[..., 4] / c - mx * mz
    yz = s2[..., 5] / c - my * mz
    cov = torch.stack([torch.stack([xx, xy, xz], -1),
                       torch.stack([xy, yy, yz], -1),
                       torch.stack([xz, yz, zz], -1)], -2)
    evals, vox_n = linalg.sym3x3_eigh_smallest(cov)
    vox_ok = (cnt >= min_points) & _planar(evals, planarity_eps)

    # Back to the original point order.  Points in voxels dropped by
    # capacity are invalid, not mapped to another voxel's plane; validity
    # rides the normals as a 4th lane, so each step is one 4-lane gather.
    in_range = seg < capacity
    pt_seg_sorted = torch.clamp(seg, 0, capacity - 1).to(torch.int64)
    packed = torch.cat([vox_n, vox_ok.to(dtype)[..., None]], dim=-1)
    pt_sorted = torch.take_along_dim(packed, pt_seg_sorted[..., None],
                                     dim=-2)  # (B, N, 4)
    okf_sorted = pt_sorted[..., 3:4] * (svalid & in_range).to(dtype)[..., None]
    pt_sorted = torch.cat([pt_sorted[..., :3], okf_sorted], dim=-1)
    # The sort's inverse permutation as a scatter: each sorted row goes
    # back to the index it came from (a permutation: one write a slot).
    out = torch.empty_like(pt_sorted).scatter_(
        -2, order[..., None].expand_as(pt_sorted), pt_sorted)
    normals = _orient(out[..., :3], pts, orient_to)
    valid = (out[..., 3] > 0.5) & msk
    return normals.reshape(points.shape), valid.reshape(mask.shape)
