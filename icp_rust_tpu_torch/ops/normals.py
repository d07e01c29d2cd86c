"""Surface normals and batched k-NN (JAX package ``ops/normals.py``).

The point-to-plane config (BASELINE.json configs[1]) needs the tangent
plane of every destination point:

- ``knn_torch``: exact k-NN by a tiled sweep over the db with a running
  (Q, k) carry, ascending by distance, lower db index first on ties;
- ``estimate_normals``: per-point k-neighbour covariance PCA;
- ``estimate_normals_voxel``: per-VOXEL covariance PCA, the path every
  published p2l number uses (one sorted segment-sum pass instead of an
  O(N^2) k-NN).

Normals are the smallest-eigenvalue eigenvectors of the covariances
(``linalg.sym3x3_eigh_smallest``), oriented toward the sensor origin, and
flagged invalid where the neighbourhood is degenerate.

Determinism on the card: the voxel moments are a sorted segment sum.  A
scatter-add (``index_add_``) sums with float atomics there, in an order
that changes from run to run; ``torch.segment_reduce`` over the sorted
segments sums each segment in one fixed order, so a frame's normals, and
with them the trajectory, repeat bitwise.  Every argsort is stable, as
``jnp.argsort`` is.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import linalg
from icp_rust_tpu_torch.ops.voxel import segment_sums

# Planarity gate on the mid/largest eigenvalue ratio.  The closed-form f32
# eigensolver's error floor is ~2e-4 relative to lam2, so the gate sits
# well above it; real planes have lam1/lam2 = O(1).
_PLANARITY_EPS = 2e-3
_CELLS = 1024  # voxel index box: cells per axis


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
    sign = torch.sign(torch.sum(normals * (orient_to - points), dim=-1,
                                keepdim=True))
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

    Every point inherits the normal of its voxel.  points: (N, 3); mask:
    (N,).  Returns (normals (N, 3), valid (N,)); invalid where the voxel
    has fewer than ``min_points`` members, was dropped by ``capacity``,
    lies outside the 1024-cells-per-axis index box (points farther than
    1024 * voxel_size from the cloud minimum: invalid, not clipped, so
    far-apart surfaces never blend into one border voxel), or is
    near-collinear (mid eigenvalue < planarity_eps * largest).

    Batch axes (..., N, 3) run cloud by cloud, each on its own grid at the
    same capacity, as the JAX package vmaps the function: every lane
    equals the unbatched call on it."""
    if points.ndim > 2:
        lanes = [estimate_normals_voxel(p, m, voxel_size, capacity,
                                        orient_to, min_points, planarity_eps)
                 for p, m in zip(points.flatten(0, -3),
                                 mask.flatten(0, -2))]
        return (torch.stack([n for n, _ in lanes]).reshape(points.shape),
                torch.stack([v for _, v in lanes]).reshape(mask.shape))
    n_pts, dim = points.shape
    dtype, dev = points.dtype, points.device
    big = torch.iinfo(torch.int32).max
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    lo = torch.amin(torch.where(mask[:, None], points, inf), dim=0)
    # A tensor divisor: a Python scalar would be multiplied by its
    # reciprocal on the card, and a cell boundary could move by an ulp.
    vs = torch.tensor(voxel_size, dtype=dtype, device=dev)
    cells = torch.floor((points - lo) / vs).to(torch.int32)
    in_box = torch.all((cells >= 0) & (cells < _CELLS), dim=-1)
    cells = torch.clamp(cells, 0, _CELLS - 1)
    cell_id = cells[:, 0]
    for kk in range(1, dim):
        cell_id = cell_id * _CELLS + cells[:, kk]
    cell_id = torch.where(mask & in_box, cell_id,
                          torch.full_like(cell_id, big))

    # Moments accumulate in per-voxel local coordinates (each point minus
    # its cell corner): in global coordinates E[x^2] - mean^2 cancels
    # catastrophically in f32.  The covariance is translation-invariant.
    local = points - (lo + cells.to(dtype) * voxel_size)

    order = torch.argsort(cell_id, stable=True)
    sid = cell_id[order]
    spts = local[order]
    svalid = sid != big
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sid[1:] != sid[:-1]]) & svalid
    seg = torch.cumsum(first.to(torch.int32), dim=0) - 1
    seg = torch.where(svalid, torch.clamp(seg, 0, capacity),
                      torch.full_like(seg, capacity))

    wf = svalid.to(dtype)[:, None]
    # second moments, packed (xx, yy, zz, xy, xz, yz)
    m2 = torch.stack([spts[:, 0] * spts[:, 0], spts[:, 1] * spts[:, 1],
                      spts[:, 2] * spts[:, 2], spts[:, 0] * spts[:, 1],
                      spts[:, 0] * spts[:, 2], spts[:, 1] * spts[:, 2]],
                     dim=-1)
    rows = torch.cat([wf, spts * wf, m2 * wf], dim=-1)  # (N, 10)
    # seg ascends (a cumsum of run starts; invalid rows last, at
    # ``capacity``), so the segments partition the rows in order.
    acc = segment_sums(rows, seg, capacity + 1)
    cnt = acc[:capacity, 0]
    s1 = acc[:capacity, 1:1 + dim]
    s2 = acc[:capacity, 1 + dim:7 + dim]

    c = torch.clamp(cnt, min=1.0)
    mean = s1 / c[:, None]
    xx = s2[:, 0] / c - mean[:, 0] * mean[:, 0]
    yy = s2[:, 1] / c - mean[:, 1] * mean[:, 1]
    zz = s2[:, 2] / c - mean[:, 2] * mean[:, 2]
    xy = s2[:, 3] / c - mean[:, 0] * mean[:, 1]
    xz = s2[:, 4] / c - mean[:, 0] * mean[:, 2]
    yz = s2[:, 5] / c - mean[:, 1] * mean[:, 2]
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
    packed = torch.cat([vox_n, vox_ok.to(dtype)[:, None]], dim=-1)
    pt_sorted = packed[pt_seg_sorted]  # (N, 4)
    okf_sorted = pt_sorted[:, 3:4] * (svalid & in_range).to(dtype)[:, None]
    pt_sorted = torch.cat([pt_sorted[:, :3], okf_sorted], dim=-1)
    inv = torch.argsort(order, stable=True)
    out = pt_sorted[inv]
    normals = _orient(out[:, :3], points, orient_to)
    valid = (out[:, 3] > 0.5) & mask
    return normals, valid
