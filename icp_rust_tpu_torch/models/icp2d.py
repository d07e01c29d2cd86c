"""Scan-to-scan ICP drivers (2D, and 3D with planar motion).

Behavioral parity with reference src/lib.rs:

- ``icp2d`` = Icp2d::estimate (src/lib.rs:91-131): up to ``outer_iters``
  iterations, each (1) transforming all src points by the current T,
  (2) finding the exact 1-NN of each in dst, (3) ``estimate_transform`` on
  (transformed src, matched dst), (4) left-composing T <- dT o T.
- ``icp3d_planar`` = Icp3d::estimate (src/lib.rs:133-174): correspondences
  in 3D, optimization on the xy projection, z untouched.

The outer loop is ``models/driver``'s: solver units, the NN route's
pre-sort, and the bit-exact exit at the fixed point.

Both drivers take one scan pair or a batch of B pairs: src (B, N, D)
against dst (B, M, D), or against one shared dst (M, D), with (B,)-batched
warm starts; more batch axes are flattened into the one pair axis and
restored on the result.  A batch runs in lockstep: each outer iteration
searches and solves every pair at once (the pair-grid NN kernels and the
batched IRLS kernel), a lane at its fixed point stays bitwise unchanged,
and the loop exits when all lanes are fixed.  With
``frame_backend="pairs"`` a batched ``icp2d`` runs instead as one
pair-frame kernel launch, each pair to its own fixed point
(``icp2d_frame``: the kernels on a card, ``icp2d_frame_plain`` on the
CPU).

Entry points run on ``device`` ("cuda" by default); with no card they
raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.driver import ICPStats, fixed_point, \
    outer_step, prepare, sort_pair, unflatten, unscale_transform
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, huber, nn
from icp_rust_tpu_torch.utils.profiling import annotate


def _use_frame_kernel(src, dst, config: ICPConfig, return_stats: bool):
    """Gate for the whole-frame kernels (config.frame_backend): small
    float32 2D scans whose solver resolves to the kernels.  Returns None,
    "single" (one pair, one icp2d_frame launch) or "pairs" (a batch, one
    icp2d_frame_pairs launch); "auto" takes "single" only."""
    if config.frame_backend == "off" or return_stats:
        return None
    if not (src.ndim in (2, 3) and src.shape[-1] == 2
            and src.dtype == torch.float32 and dst.ndim == src.ndim
            and (src.ndim == 2 or dst.shape[0] == src.shape[0])
            and src.shape[-2] <= config.frame_kernel_max
            and dst.shape[-2] <= config.frame_kernel_max
            and align2d.use_cuda_align(src, config.align_backend)):
        return None
    kind = "single" if src.ndim == 2 else "pairs"
    if kind == "single" or config.frame_backend == "pairs":
        return kind
    return None


def _stats_2d(src_t, matched, mask, config, dist_sq, it):
    """Final-transform metrics from the last correspondence set."""
    s = config.point_scale
    maskf = mask.to(src_t.dtype)
    nf = torch.clamp(torch.sum(maskf, dim=-1), min=1.0)
    r = src_t[..., :2] - matched[..., :2]
    k = config.huber_k / s
    err = torch.sum(huber.rho(torch.sum(r * r, dim=-1), k) * maskf, dim=-1)
    inl = torch.all(torch.abs(r) <= k, dim=-1)
    mean_nn = torch.sum(torch.sqrt(torch.clamp(dist_sq, min=0.0)) * maskf,
                        dim=-1) / nf * s
    return ICPStats(
        outer_iters=torch.full(err.shape, it, dtype=torch.int32,
                               device=err.device),
        huber_error=err,
        mean_nn_dist=mean_nn,
        inlier_fraction=torch.sum(inl * maskf, dim=-1) / nf,
    )


def _icp_loop(src, dst, src_mask, dst_mask, t0, config: ICPConfig,
              src_presorted: bool, planar: bool):
    """The unfused outer loop in solver units, shared by both drivers.
    ``planar``: 3D matching with the SE(2) solve on xy (z untouched).
    Returns (t, iterations, (dist_sq, src_t_xy, matched_xy, src_mask),
    lane iterations): the last iteration's correspondences and the mask in
    the loop's point order, which the spatial sort may have permuted."""
    # The SE(2) solve consumes only the matched point's xy.
    route = nn.route(src, dst, 2 if planar else dst.shape[-1], config)
    src, src_mask, dst, dst_mask, _ = sort_pair(
        route.sort, src, src_mask, dst, dst_mask, src_presorted)
    index = nn.NNIndex(route, dst, dst_mask, dst[..., :2] if planar else dst,
                       config)

    def place(t):
        xy = t.apply_points(src[..., :2])
        return xy, torch.cat([xy, src[..., 2:]], dim=-1) if planar else xy

    def solve(xy, _res, rows):
        matched_xy = rows[..., :2]
        return (align2d.estimate_transform(xy, matched_xy, src_mask, config),
                matched_xy)

    aux0 = (torch.full(src.shape[:-1], float("inf"), dtype=src.dtype,
                       device=src.device),
            src[..., :2], torch.zeros_like(src[..., :2]))
    t, it, aux, lane_it = fixed_point(outer_step(index, place, solve), t0,
                                      config.outer_iters, aux0)
    return t, it, aux + (src_mask,), lane_it


def _finish(t, it, aux, config: ICPConfig, return_stats: bool):
    """Rescale the result to physical units; with ``return_stats`` add the
    ICPStats of the last iteration's correspondences."""
    t = unscale_transform(t, config.point_scale)
    if not return_stats:
        return t
    dist_sq, src_xy, matched_xy, mask = aux
    return t, _stats_2d(src_xy, matched_xy, mask, config, dist_sq, it)


def icp2d_frame_plain(src, dst, src_mask, dst_mask, t0: RigidTransform2,
                      config: ICPConfig):
    """Plain PyTorch version of the icp2d_frame and icp2d_frame_pairs
    kernels: the unfused outer loop with torch NN and solver and no sort,
    in solver units.  A lane that reaches its fixed point stays bitwise
    unchanged while the others go on.  Returns (rot, t, outer iterations
    per lane, int32)."""
    cfg = config.with_(frame_backend="off", nn_backend="torch",
                       align_backend="torch")
    t, _, _, lane_it = _icp_loop(src, dst, src_mask, dst_mask, t0, cfg,
                                 src_presorted=False, planar=False)
    return t.rot, t.t, lane_it


icp2d_frame_pairs_plain = icp2d_frame_plain


def icp2d_frame(src, dst, src_mask, dst_mask, t0: RigidTransform2,
                config: ICPConfig):
    """Whole warm-started 2D ICP calls in solver units: kernel 3 (src
    (N, 2)) or kernel 10 (src (B, N, 2)) on a card
    (``ops/align2d_cuda.icp2d_frame``), their plain version on the CPU.
    Returns (rot, t, outer iterations per pair)."""
    frame = align2d_cuda.icp2d_frame if src.is_cuda else icp2d_frame_plain
    return frame(src, dst, src_mask, dst_mask, t0, config)


def icp2d(src, dst, src_mask, dst_mask,
          initial_transform: RigidTransform2,
          config: ICPConfig = ICPConfig(), return_stats: bool = False,
          src_presorted: bool = False, device="cuda"):
    """2D scan-to-scan ICP. src/dst: (N|M, 2), or (B, N|M, 2) for B pairs
    (a shared dst may stay (M, 2)); masks over the point axes.

    Parity: reference Icp2d::estimate (src/lib.rs:105-130).  With
    ``return_stats`` returns (transform, ICPStats).  Scans of at most
    frame_kernel_max points run as one ``icp2d_frame`` launch when the
    solver resolves to the kernels, and a batch as one
    ``icp2d_frame_pairs`` launch with ``frame_backend="pairs"``."""
    with annotate("icp.icp2d"):
        src, dst, src_mask, dst_mask, t0, batch, _ = prepare(
            src, dst, src_mask, dst_mask, initial_transform, config, device)
        if _use_frame_kernel(src, dst, config, return_stats):
            rot, t, _ = icp2d_frame(src, dst, src_mask, dst_mask, t0, config)
            return unflatten(unscale_transform(RigidTransform2(rot, t),
                                               config.point_scale), batch)
        return unflatten(_finish(*_icp_loop(src, dst, src_mask, dst_mask, t0,
                                            config, src_presorted,
                                            planar=False)[:3],
                                 config, return_stats), batch)


def icp3d_planar(src, dst, src_mask, dst_mask,
                 initial_transform: RigidTransform2,
                 config: ICPConfig = ICPConfig(), return_stats: bool = False,
                 src_presorted: bool = False, device="cuda"):
    """3D matching, SE(2)-on-xy optimization (vehicle on the xy-plane).

    src/dst: (N|M, 3), or (B, N|M, 3).  Parity: reference Icp3d::estimate
    (src/lib.rs:148-173).  ``src_presorted``: src already permuted by
    :func:`models.driver.presort_src` (bitwise-identical hoist)."""
    src, dst, src_mask, dst_mask, t0, batch, _ = prepare(
        src, dst, src_mask, dst_mask, initial_transform, config, device)
    return unflatten(_finish(*_icp_loop(src, dst, src_mask, dst_mask, t0,
                                        config, src_presorted,
                                        planar=True)[:3],
                             config, return_stats), batch)


def se2_driver(dim: int):
    """The SE(2) driver for the points' dimension: ``icp2d`` for 2D scans,
    ``icp3d_planar`` (3D matching, SE(2) solve on xy) for 3D ones."""
    return icp2d if dim == 2 else icp3d_planar
