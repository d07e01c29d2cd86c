"""The robust SE(2) solver kernels, their wrappers and their plain PyTorch
versions:

- ``csrc/irls_loop.cu``: the whole inner IRLS loop of one pair in one
  launch on a thread-block cluster of ``IRLS_CLUSTER`` blocks
  (align2d_pallas ``_inner_loop_kernel``; ``csrc/irls_cluster.cuh``);
- ``csrc/irls_loop_batched.cu``: the same loop for B pairs in one launch,
  a cluster per pair, or one block a pair for small pairs
  (``batched_cluster``; ``_inner_loop_batched_kernel``);
- ``csrc/icp2d_frame.cu``: a whole 2D ICP call in one launch on a
  thread-block cluster, the 1-NN sweep split over its blocks and the IRLS
  loop on its leader (``_icp2d_frame_kernel``);
- ``csrc/icp2d_frame_pairs.cu``: B whole 2D ICP calls in one launch, the
  same body on a cluster per pair, each pair to its own fixed point
  (``frame_pairs_shape``; ``_icp2d_frame_pairs_kernel``);
- ``csrc/gn_stats.cu``: one GN update's packed statistics at a given
  transform on a thread-block cluster of ``gn_cluster(N)`` blocks
  (``_gn_kernel``; ``csrc/irls_cluster.cuh``);
- ``csrc/gn_stats_batched.cu``: the same for B pairs, one block a pair
  with each pair's points and residuals held in registers, or gn_stats'
  body on a cluster per pair (``gn_batched_route``;
  ``_gn_batched_kernel``).

All six run the device routines of ``csrc/irls.cuh`` (gn_stats_batched's
one-block route its helpers, with gn_stats_block's terms and order in
registers; irls_loop, irls_loop_batched, gn_stats and gn_stats_batched's
cluster route its helpers, spread over a cluster by
``csrc/irls_cluster.cuh``, whose ``irls_cluster_run`` is the cluster loop
and, run once without its tail, the whole of gn_stats; the two frame
kernels its whole loop, on the leader block of each cluster of
``csrc/frame_cluster.cuh``), so they share one op sequence.  The frame
kernels' cluster sweep finds bitwise the matches of one thread sweeping
all of dst (``frame_sweep`` emulates it).

Plain versions: the inner loops' is ``align2d.irls_loop_torch`` (the
``align_backend="torch"`` loop, batched over pairs); the frames' is
``models/icp2d.icp2d_frame_plain``, the unfused outer loop with
``frame_backend="off"`` and torch backends, which does not sort: the
frame kernels search the unsorted db; the stats kernels' is
``gn_stats_plain``, the same 16 numbers in ``gn_stats_block``'s op order
with the exact medians of ``ops/select``.  A wrapper takes the plain
version only for a CPU tensor (the frames' ``models/icp2d.icp2d_frame``
does the same); a CUDA tensor reaches the kernel or raises.  The kernels
take float32 only: the float64 reference path is a CPU path.

Tolerance against the plain versions: float32 roundoff of the sums, which
are taken in another order (the cluster kernels' float64 rounded once, or
a float32 block tree, vs torch reductions); the medians are exact order
statistics of residuals that may differ in their last bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import align2d, cuda_build, robust
from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL
from icp_rust_tpu_torch.utils.profiling import annotate

_SMALL_ANGLE_F32 = float(torch.finfo(torch.float32).eps) ** 0.25
FRAME_MAX_POINTS = 1536
# icp2d_frame: threads a block and queries a thread of its sweep
# (csrc/icp2d_frame.cu kThreads, kQ), and the cluster sizes it runs on,
# which its launcher picks from N (C entry icp2d_frame_cluster, measured
# on an H100, PERF.md).  Which block sweeps which queries follows from
# them, never the result.
FRAME_THREADS = 1024
FRAME_Q = 2
FRAME_CLUSTERS = (1, 2, 4, 8, 16)
# icp2d_frame_pairs: the threads a block and the (blocks a pair's
# cluster, threads a block) settings it runs on; ``frame_pairs_shape``
# picks one.  Like FRAME_CLUSTERS they set who sweeps which rows and the
# IRLS sums' order (the leader's threads), never the matches.
PAIRS_THREADS = (512, 256, 128)
PAIRS_SHAPES = tuple((c, t) for t in PAIRS_THREADS
                     for c in FRAME_CLUSTERS[::-1])
# Blocks in irls_loop's thread-block cluster (16 measured faster than 8
# on an H100, PERF.md).  Which points each block sums follows from it, so
# it is a constant, not a knob.
IRLS_CLUSTER = 16
# irls_loop_batched: pairs of at most BATCHED_BLOCK_MAX_POINTS points take
# one block each on irls.cuh's loop; larger pairs a cluster each, whose
# blocks take at least BATCHED_MIN_POINTS points, of the cluster sizes
# tried largest first; measured on an H100 (PERF.md).  Like IRLS_CLUSTER
# they set which points each block sums, not the result.
BATCHED_BLOCK_MAX_POINTS = 4096
BATCHED_MIN_POINTS = 1024
BATCHED_CLUSTERS = (16, 8, 4, 2, 1)
# Blocks in gn_stats' thread-block cluster: 16 above this many points,
# else 8 (measured on an H100, PERF.md).  Which points each block sums
# follows from N alone, so it is a rule, not a knob.
GN_CLUSTER_16_ABOVE = 16384
# gn_stats_batched: pairs of at most GN_BATCHED_BLOCK_MAX_POINTS points
# (8 a thread of 512) take one block each, about GN_BATCHED_POINTS points
# a thread held in registers (``gn_batched_threads``); larger pairs a
# cluster each, sized as irls_loop_batched's (``gn_batched_route``);
# measured on an H100 (PERF.md).  They set which points each thread and
# block sums, not the result's contract.
GN_BATCHED_BLOCK_MAX_POINTS = 4096
GN_BATCHED_POINTS = 3
# The one-block route stages 7 floats a point in at most 200 KB.
_BLOCK_ROUTE_MAX_POINTS = 200 * 1024 // 28
# (n, cluster, threads) -> clusters the card holds at once.
_RESIDENT: dict = {}
# (n, cluster) -> gn_stats_batched's clusters resident at once.
_GN_RESIDENT: dict = {}
# (n, m, cluster, threads) -> icp2d_frame_pairs' clusters resident at once.
_FRAME_RESIDENT: dict = {}


def gn_cluster(n: int) -> int:
    """The cluster size gn_stats launches for n points."""
    return 16 if n > GN_CLUSTER_16_ABOVE else 8


def _solver_params(huber_k: float, det_rel_eps: float, tol_d2: float,
                   max_iter: int, point_scale: float) -> list:
    """The kernels' IrlsParams in order; ctypes rounds each float to f32
    once, as the JAX kernel's f32 constants are (k * k and 2 * k are taken
    in double first)."""
    return [huber_k, huber_k * huber_k, 2.0 * huber_k, det_rel_eps, tol_d2,
            int(max_iter), point_scale, _SMALL_ANGLE_F32]


def _check_cuda_f32(name: str, *tensors: Tensor) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(
                f"{name}: the kernel takes float32, got {x.dtype} (the "
                "float64 reference path runs on the CPU)")


def irls_loop_plain(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
                    det_rel_eps: float, tol_d2: float, max_iter: int,
                    point_scale: float):
    """Plain PyTorch version of the irls_loop and irls_loop_batched
    kernels: the torch loop, whose done lanes freeze.  Returns (rot, t,
    iterations per lane) with the batch axes of src."""
    return align2d.irls_loop_torch(src, dst, mask, huber_k, det_rel_eps,
                                   tol_d2, max_iter, point_scale)


irls_loop_batched_plain = irls_loop_plain


def _irls_loop_args(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
                    det_rel_eps: float, tol_d2: float, max_iter: int,
                    point_scale: float, cluster: int = IRLS_CLUSTER):
    """Check the CUDA inputs of the irls_loop kernel and allocate its
    output and scratch.  The kernel reads src/dst (N, 2) float32 and the
    bool mask (N,) in place, with their strides.  Returns (the launcher's
    arguments, out (12,), the scratch): out holds r00 r01 r10 r11 tx ty
    iterations 0, then the first iteration's median x, median y, sigma x,
    sigma y."""
    _check_cuda_f32("irls_loop", src, dst)
    n = src.shape[0]
    if src.shape != (n, 2) or dst.shape != (n, 2) or mask.shape != (n,):
        raise ValueError("irls_loop: src/dst must be (N, 2), mask (N,)")
    if mask.dtype != torch.bool or mask.device != src.device:
        raise TypeError(f"irls_loop: mask must be bool on {src.device}")
    buf = torch.empty(12 + 2 * n, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            mask.data_ptr(), mask.stride(0), n, buf[12:].data_ptr(),
            buf.data_ptr(),
            *_solver_params(huber_k, det_rel_eps, tol_d2, max_iter,
                            point_scale), cluster, stream)
    return args, buf[:12], buf


def irls_loop(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
              det_rel_eps: float, tol_d2: float, max_iter: int,
              point_scale: float):
    """The fixed-correspondence IRLS loop from identity.  src/dst (N, 2)
    in solver units, mask (N,) bool, huber_k in solver units.  Returns
    (rot (2, 2), t (2,), iterations): a 0-d tensor, int32 from the plain
    version, float from the kernel."""
    if src.device.type == "cpu":
        return irls_loop_plain(src, dst, mask, huber_k, det_rel_eps,
                               tol_d2, max_iter, point_scale)
    if src.device.type != "cuda":
        raise ValueError(f"irls_loop: unsupported device {src.device}")
    out = irls_loop_out(src, dst, mask, huber_k, det_rel_eps, tol_d2,
                        max_iter, point_scale)
    return out[:4].reshape(2, 2), out[4:6], out[6]


def irls_loop_out(src: Tensor, dst: Tensor, mask: Tensor, huber_k: float,
                  det_rel_eps: float, tol_d2: float, max_iter: int,
                  point_scale: float) -> Tensor:
    """Launch irls_loop on CUDA tensors; returns its (12,) output (see
    ``_irls_loop_args``)."""
    args, out, _scratch = _irls_loop_args(src, dst, mask, huber_k,
                                          det_rel_eps, tol_d2, max_iter,
                                          point_scale)
    status = cuda_build.launcher("irls_loop")(*args)
    cuda_build.LAUNCHES["irls_loop"] += 1
    if status == -1:
        raise RuntimeError(
            f"irls_loop: no thread-block cluster of {IRLS_CLUSTER} blocks "
            "can be placed on this card")
    cuda_build.check(status, "irls_loop")
    return out


def irls_loop_batched(src: Tensor, dst: Tensor, mask: Tensor,
                      huber_k: float, det_rel_eps: float, tol_d2: float,
                      max_iter: int, point_scale: float):
    """The fixed-correspondence IRLS loop from identity for B pairs at
    once, each pair stopping on its own.  src/dst (B, N, 2) in solver
    units, mask (B, N) bool.  Returns (rot (B, 2, 2), t (B, 2),
    iterations per pair (B,)): int32 from the plain version, float from
    the kernel."""
    if src.device.type == "cpu":
        return irls_loop_batched_plain(src, dst, mask, huber_k, det_rel_eps,
                                       tol_d2, max_iter, point_scale)
    if src.device.type != "cuda":
        raise ValueError(f"irls_loop_batched: unsupported device {src.device}")
    args, out, _scratch = _irls_loop_batched_args(
        src, dst, mask, huber_k, det_rel_eps, tol_d2, max_iter, point_scale)
    status = cuda_build.launcher("irls_loop_batched")(*args)
    cuda_build.LAUNCHES["irls_loop_batched"] += 1
    if status == -1:
        raise RuntimeError(
            f"irls_loop_batched: no thread-block cluster of {args[-3]} "
            "blocks can be placed on this card")
    cuda_build.check(status, "irls_loop_batched")
    b = src.shape[0]
    return out[:, :4].reshape(b, 2, 2), out[:, 4:6], out[:, 6]


def batched_threads(per: int, most: int = 512) -> int:
    """irls_loop_batched's block for ``per`` points: about three points a
    thread, a multiple of 32 in [64, most] (512 in a cluster, 1024 on the
    one-block route)."""
    warps = -(-per // 96)
    return min(most, max(64, 32 * warps))


def batched_cluster(b: int, n: int, resident,
                    block_max: int = BATCHED_BLOCK_MAX_POINTS) -> int:
    """irls_loop_batched's route for B pairs of N points: 0, one block a
    pair on irls.cuh's loop, up to ``block_max`` points; else blocks a
    pair's cluster, the largest of BATCHED_CLUSTERS that leaves a block at
    least BATCHED_MIN_POINTS points and of which the card holds all B
    clusters at once (``resident(cluster)``: clusters it holds), 1 when
    none does."""
    if n <= block_max:
        return 0
    for c in BATCHED_CLUSTERS[:-1]:
        if n >= c * BATCHED_MIN_POINTS and resident(c) >= b:
            return c
    return 1


def gn_batched_route(b: int, n: int, resident) -> int:
    """gn_stats_batched's route for B pairs of N points: 0, one block a
    pair, up to GN_BATCHED_BLOCK_MAX_POINTS points, else
    ``batched_cluster``'s cluster size (``resident(cluster)``: the
    clusters of gn_stats_batched the card holds)."""
    return batched_cluster(b, n, resident, GN_BATCHED_BLOCK_MAX_POINTS)


def gn_batched_threads(n: int) -> int:
    """gn_stats_batched's block on the one-block route: about
    GN_BATCHED_POINTS points a thread, a multiple of 32 in [64, 512]
    (more threads measured slower on an H100, PERF.md; the kernel holds
    at most 8 points a thread at 512)."""
    return min(512, max(64, 32 * -(-n // (32 * GN_BATCHED_POINTS))))


def _gn_resident(n: int, cluster: int) -> int:
    """Clusters of gn_stats_batched the card holds at once, for pairs of
    n points (cached per shape)."""
    got = _GN_RESIDENT.get((n, cluster))
    if got is None:
        got = _GN_RESIDENT[(n, cluster)] = cuda_build.query(
            "gn_stats_batched_resident")(n, cluster)
    return got


def _threads_of(n: int, cluster: int) -> int:
    if cluster == 0:
        return batched_threads(n, 1024)
    return batched_threads(-(-n // cluster))


def _resident(n: int, cluster: int) -> int:
    """Clusters of irls_loop_batched the card holds at once, for pairs of
    n points (cached per shape)."""
    threads = _threads_of(n, cluster)
    key = (n, cluster, threads)
    got = _RESIDENT.get(key)
    if got is None:
        got = _RESIDENT[key] = cuda_build.query(
            "irls_loop_batched_resident")(n, cluster, threads)
    return got


def _irls_loop_batched_args(src: Tensor, dst: Tensor, mask: Tensor,
                            huber_k: float, det_rel_eps: float,
                            tol_d2: float, max_iter: int,
                            point_scale: float, cluster=None):
    """Check the CUDA inputs of the irls_loop_batched kernel and allocate
    its output and scratch.  The kernel reads src/dst (B, N, 2) float32
    and the bool mask (B, N) in place, with their strides.  ``cluster``:
    blocks per pair, 0 for the one-block route, by default
    ``batched_cluster``.  Returns (the launcher's arguments, out (B, 12),
    the scratch): a row holds r00 r01 r10 r11 tx ty iterations 0, then
    (cluster route) the first iteration's median x, median y, sigma x,
    sigma y."""
    _check_cuda_f32("irls_loop_batched", src, dst)
    b, n = src.shape[:2]
    if (src.shape != (b, n, 2) or dst.shape != (b, n, 2)
            or mask.shape != (b, n) or n == 0 or b == 0):
        raise ValueError(
            "irls_loop_batched: src/dst must be (B, N, 2), mask (B, N)")
    if mask.dtype != torch.bool or mask.device != src.device:
        raise TypeError(f"irls_loop_batched: mask must be bool on "
                        f"{src.device}")
    if cluster is None:
        cluster = batched_cluster(b, n, lambda c: _resident(n, c))
    if cluster == 0 and n > _BLOCK_ROUTE_MAX_POINTS:
        raise ValueError(f"irls_loop_batched: the one-block route takes at "
                         f"most {_BLOCK_ROUTE_MAX_POINTS} points a pair")
    buf = torch.empty(b * 12 + 2 * b * n, dtype=torch.float32,
                      device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            mask.data_ptr(), *mask.stride(), b, n, buf[b * 12:].data_ptr(),
            buf.data_ptr(),
            *_solver_params(huber_k, det_rel_eps, tol_d2, max_iter,
                            point_scale), cluster,
            _threads_of(n, cluster), stream)
    return args, buf[:b * 12].view(b, 12), buf


def icp2d_frame(src: Tensor, dst: Tensor, src_mask: Tensor,
                dst_mask: Tensor, t0: RigidTransform2, config: ICPConfig):
    """Whole warm-started 2D ICP calls (Icp2d::estimate with the exact
    fixed-point exit) in one launch: one pair, src (N, 2) and dst (M, 2),
    through the icp2d_frame kernel, or B pairs, (B, N, 2) and (B, M, 2)
    with (B,)-batched warm starts, through the icp2d_frame_pairs kernel,
    each pair to its own fixed point.  Solver units, N, M <= 1536, CUDA
    tensors (``models/icp2d.icp2d_frame`` takes the plain version on the
    CPU).  Returns (rot, t, outer iterations per pair)."""
    out = icp2d_frame_raw(src, dst, src_mask, dst_mask, t0, config)
    return out[..., :4].reshape(*out.shape[:-1], 2, 2), out[..., 4:6], \
        out[..., 6]


icp2d_frame_pairs = icp2d_frame


def icp2d_frame_raw(src: Tensor, dst: Tensor, src_mask: Tensor,
                    dst_mask: Tensor, t0: RigidTransform2,
                    config: ICPConfig) -> Tensor:
    """Launch icp2d_frame (src (N, 2)) or icp2d_frame_pairs (src
    (B, N, 2)) on CUDA tensors; returns the (8,) or (B, 8) output: r00 r01
    r10 r11 tx ty, outer and summed inner iterations of each pair."""
    with annotate("icp.frame_launch"):
        name, args, out, _keep = _icp2d_frame_args(src, dst, src_mask,
                                                   dst_mask, t0, config)
        status = cuda_build.launcher(name)(*args)
        cuda_build.LAUNCHES[name] += 1
        if status == -1:
            raise RuntimeError(f"{name}: no thread-block cluster of that "
                               "shape can be placed on this card")
        cuda_build.check(status, name)
        return out


def _icp2d_frame_args(src: Tensor, dst: Tensor, src_mask: Tensor,
                      dst_mask: Tensor, t0: RigidTransform2,
                      config: ICPConfig, shape=None):
    """Check the CUDA inputs of icp2d_frame (src (N, 2)) or
    icp2d_frame_pairs (src (B, N, 2)) and allocate the output; ``shape``:
    icp2d_frame_pairs' (blocks a pair, threads a block), by default
    ``frame_pairs_shape``'s.  Returns (the kernel's name, the launcher's
    arguments, the (8,) or (B, 8) output, the staged inputs, which the
    caller holds until the launch is enqueued)."""
    name = "icp2d_frame" if src.ndim == 2 else "icp2d_frame_pairs"
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    _check_cuda_f32(name, src, dst, t0.rot, t0.t)
    batch = src.shape[:-2]
    n, m = src.shape[-2], dst.shape[-2]
    if (len(batch) > 1 or src.shape[-1] != 2 or dst.shape != (*batch, m, 2)
            or src_mask.shape != (*batch, n) or dst_mask.shape != (*batch, m)
            or t0.rot.shape != (*batch, 2, 2) or t0.t.shape != (*batch, 2)
            or not 0 < n <= FRAME_MAX_POINTS
            or not 0 < m <= FRAME_MAX_POINTS):
        raise ValueError(
            f"{name}: src/dst must be (N, 2) or (B, N, 2) with 0 < N <= "
            f"{FRAME_MAX_POINTS}, masks and warm starts batched alike; got "
            f"{tuple(src.shape)}, {tuple(dst.shape)}")
    dstm = torch.where(dst_mask[..., None], dst,
                       torch.full_like(dst, _SENTINEL)).contiguous()
    srcc = src.contiguous()
    smask = src_mask.to(device=src.device, dtype=torch.float32).contiguous()
    tp = torch.cat([t0.rot.reshape(*batch, 4), t0.t], dim=-1).contiguous()
    out = torch.empty((*batch, 8), dtype=torch.float32, device=src.device)
    s = config.point_scale
    stream = torch.cuda.current_stream(src.device).cuda_stream
    # The pair-frame launcher takes the pair count before (n, m), and its
    # cluster and block sizes before the stream.
    if batch:
        if shape is None:
            shape = frame_pairs_shape(
                batch[0], n, lambda c, t: _frame_resident(n, m, c, t))
        tail = (config.outer_iters, *shape, stream)
    else:
        tail = (config.outer_iters, stream)
    args = (srcc.data_ptr(), smask.data_ptr(), dstm.data_ptr(), *batch, n, m,
            tp.data_ptr(), out.data_ptr(),
            *_solver_params(config.huber_k / s, config.det_rel_eps,
                            config.inner_delta_sq_tol, config.inner_max_iter,
                            s), *tail)
    return name, args, out, (srcc, smask, dstm, tp)


def frame_pairs_shape(b: int, n: int, resident):
    """icp2d_frame_pairs' (blocks a pair, threads a block) for B pairs of
    n source points: blocks of at least the threads that leave the
    leader's IRLS loop 3 points a thread (``batched_threads``; 512 at
    most), the most threads a pair (blocks x threads), then the most
    blocks, of which the card holds all B clusters at once
    (``resident(cluster, threads)``: clusters it holds) and that leave at
    least 32 query rows a block.  Measured best at 209 x 768, 64 x 1,536
    and one pair of 768 and of 1,536 points on an H100 (PERF.md).  One
    block of 256 threads a pair when none fits (the pairs then run in
    waves)."""
    least = min(batched_threads(n), PAIRS_THREADS[0])
    for c, t in sorted(PAIRS_SHAPES, key=lambda ct: (-ct[0] * ct[1], ct[1])):
        if (t >= least and (c == 1 or n >= 32 * c)
                and resident(c, t) >= b):
            return c, t
    return 1, 256


def _frame_resident(n: int, m: int, cluster: int, threads: int) -> int:
    """Clusters of icp2d_frame_pairs the card holds at once for pairs of
    n x m points (cached per shape); raises on a CUDA error."""
    key = (n, m, cluster, threads)
    got = _FRAME_RESIDENT.get(key)
    if got is None:
        got = cuda_build.query("icp2d_frame_pairs_resident")(n, m, cluster,
                                                             threads)
        if got < 0:
            raise RuntimeError(f"icp2d_frame_pairs: occupancy query failed: "
                               f"cudaError {-got}")
        _FRAME_RESIDENT[key] = got
    return got


def _trailing(valid: Tensor) -> int:
    """Rows up to the last true entry of ``valid``."""
    nz = torch.nonzero(valid)
    return int(nz[-1]) + 1 if nz.numel() else 0


def _sweep_segments(ng: int, s_n: int, m4: int, threads: int) -> int:
    """csrc/frame_cluster.cuh's sweep_segments: the dst segments whose
    rounds of (group, segment) tasks over the threads times segment length
    is least, within the partials' room and segments of >= 4 points, the
    fewest among equals."""
    best, best_cost = 1, None
    # The partials' room (csrc/frame_cluster.cuh partials): pairs a thread.
    room = (2 if threads >= 1024 else 6) * threads
    most = room // s_n if s_n else 1
    for ns in range(1, most + 1):
        if ns > 1 and 4 * ns > m4:
            break
        seg_len = -(-m4 // ns)
        cost = -(-ng * ns // threads) * (-(-seg_len // 4) * 4)
        if best_cost is None or cost < best_cost:
            best, best_cost = ns, cost
    return best


def frame_sweep_plan(n_eff: int, m_eff: int, cluster: int,
                     threads: int = FRAME_THREADS):
    """The frame kernels' sweep schedule for the n_eff swept query rows
    (up to the last valid one) against the m_eff swept dst rows (up to the
    last that is not the sentinel; m4 once padded to a multiple of 4) on a
    cluster of ``cluster`` blocks of ``threads`` threads, as
    csrc/frame_cluster.cuh computes it: per block (first query row, rows,
    dst segments, segment length, a multiple of 4)."""
    m4 = -(-m_eff // 4) * 4
    per = -(-n_eff // cluster)
    plan = []
    for r in range(cluster):
        row0 = min(n_eff, r * per)
        s_n = min(n_eff, row0 + per) - row0
        ng = -(-s_n // FRAME_Q)
        nseg = _sweep_segments(ng, s_n, m4, threads)
        seg_len = -(-m4 // nseg)
        plan.append((row0, s_n, nseg, -(-seg_len // 4) * 4))
    return plan


def frame_sweep(query: Tensor, dst: Tensor, cluster: int,
                threads: int = FRAME_THREADS, smask: Tensor | None = None):
    """The frame kernels' 1-NN sweep on tensors, on a cluster of
    ``cluster`` blocks of ``threads`` threads (``frame_sweep_plan``): the
    query rows (N, 2) up to the last valid one (``smask``, all by default)
    cut into the blocks' slices, against dst (M, 2), sentinel-masked, up
    to its last row that is not the sentinel and padded with the sentinel,
    cut into each block's ascending segments; the first minimum of each
    segment (ex*ex + ey*ey; index 0 where no point is finite), merged
    lexicographically on (distance, index).  Returns (dist, idx int64);
    rows past the last valid one get (+inf, 0), as their matches are
    never read."""
    n = query.shape[0]
    n_eff = n if smask is None else _trailing(smask)
    m_eff = _trailing(torch.any(dst != _SENTINEL, dim=1))
    plan = frame_sweep_plan(n_eff, m_eff, cluster, threads)
    dist = torch.full((n,), float("inf"), dtype=dst.dtype,
                      device=dst.device)
    idx = torch.zeros(n, dtype=torch.int64, device=dst.device)
    for row0, s_n, nseg, seg_len in plan:
        if not s_n * seg_len:  # no rows, or no dst row to sweep
            continue
        d_all = torch.full((nseg * seg_len, 2), _SENTINEL, dtype=dst.dtype,
                           device=dst.device)
        d_all[:m_eff] = dst[:m_eff]
        q = query[row0:row0 + s_n]
        ex = q[:, None, 0] - d_all[None, :, 0]
        ey = q[:, None, 1] - d_all[None, :, 1]
        ld, li = torch.min((ex * ex + ey * ey).reshape(s_n, nseg, seg_len),
                           dim=2)
        li = torch.where(torch.isinf(ld), 0,
                         li + seg_len * torch.arange(nseg, device=dst.device))
        # The lexicographic minimum over the segments.
        best = torch.amin(ld, dim=1)
        dist[row0:row0 + s_n] = best
        idx[row0:row0 + s_n] = torch.amin(
            torch.where(ld == best[:, None], li, nseg * seg_len), dim=1)
    return dist, idx


def gn_stats_plain(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                   t: Tensor, huber_k: float) -> Tensor:
    """Plain PyTorch version of the gn_stats and gn_stats_batched kernels
    (_gn_kernel, _gn_batched_kernel): the packed (..., 16) statistics of
    clouds (..., N, 2) at (rot (..., 2, 2), t (..., 2)) in src's dtype, in
    gn_stats_block's op order: residuals, the exact median and MAD per
    dimension, the ten sums and the Huber error over the mask-true points,
    the count, sigma_x, sigma_y, 0, 0.  A fully masked cloud gives zero
    sums, count 0 and sigma 0."""
    dt = src.dtype
    rot, t = rot.to(dt), t.to(dt)
    mask = mask.to(device=src.device, dtype=torch.bool)
    sx, sy, dx, dy = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    r00, r01 = rot[..., 0, 0, None], rot[..., 0, 1, None]
    r10, r11 = rot[..., 1, 0, None], rot[..., 1, 1, None]
    tx, ty = t[..., 0, None], t[..., 1, None]
    r = torch.stack([r00 * sx + r01 * sy + tx - dx,
                     r10 * sx + r11 * sy + ty - dy], dim=-2)  # (..., 2, N)
    m2 = mask[..., None, :].expand(r.shape)
    med, _ = robust.masked_median(r, m2)
    mad, _ = robust.masked_median(torch.abs(r - med[..., None]), m2)
    sig = robust.MAD_SCALE * mad  # (..., 2)
    one = torch.ones_like(sig)
    g = torch.where(sig != 0.0, one / torch.where(sig != 0.0, sig, one),
                    torch.zeros_like(sig))
    # k^2 and 2k rounded once to the working type, as the kernels' f32
    # parameters are; a tensor divisor keeps k / sqrt(e) a true division.
    k2 = huber_k * huber_k
    hk = torch.tensor(huber_k, dtype=dt, device=src.device)
    e = r * r
    u = torch.where(e <= k2, torch.ones_like(e), hk / torch.sqrt(e)) \
        * g[..., None]
    w = torch.stack([-r00 * sy + r01 * sx, -r10 * sy + r11 * sx], dim=-2)
    zero = torch.zeros((), dtype=dt, device=src.device)

    def msum(x):
        return torch.sum(torch.where(mask, x, zero), dim=-1)

    sums = []
    for d in range(2):
        u_d, w_d, r_d = u[..., d, :], w[..., d, :], r[..., d, :]
        uw = u_d * w_d
        sums += [msum(u_d), msum(uw), msum(uw * w_d), msum(u_d * r_d),
                 msum(uw * r_d)]
    ee = e[..., 0, :] + e[..., 1, :]
    rho = torch.where(ee <= k2, ee, 2.0 * huber_k * torch.sqrt(ee) - k2)
    err = msum(rho)
    n = torch.sum(mask, dim=-1).to(dt)
    zeros = torch.zeros_like(err)
    return torch.stack(sums + [err, n, sig[..., 0], sig[..., 1], zeros,
                               zeros], dim=-1)


gn_stats_batched_plain = gn_stats_plain


def _gn_stats_args(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                   t: Tensor, huber_k: float, cluster: int | None = None):
    """Check the CUDA inputs of the gn_stats kernel and allocate its output
    and scratch.  The kernel reads src/dst (N, 2) float32 and the mask
    (N,) as bool (true where nonzero, as the plain version takes it) in
    place, with their strides.  ``cluster`` defaults to ``gn_cluster(N)``.
    Returns (the launcher's arguments, out (16,), the tensors that the
    arguments point into, which the caller holds until the launch is
    enqueued)."""
    if src.device.type != "cuda":
        raise ValueError(f"gn_stats: unsupported device {src.device}")
    _check_cuda_f32("gn_stats", src, dst)
    n = src.shape[0]
    if (src.shape != (n, 2) or dst.shape != (n, 2) or mask.shape != (n,)
            or rot.shape != (2, 2) or t.shape != (2,) or n == 0):
        raise ValueError(
            f"gn_stats: src/dst must be (N, 2) with N > 0, mask (N,), rot "
            f"(2, 2), t (2,); got {tuple(src.shape)}, {tuple(mask.shape)}, "
            f"{tuple(rot.shape)}, {tuple(t.shape)}")
    mask = mask.to(device=src.device, dtype=torch.bool)
    cluster = gn_cluster(n) if cluster is None else cluster
    rt = torch.cat([rot.reshape(4), t]).to(device=src.device,
                                           dtype=torch.float32).contiguous()
    buf = torch.empty(16 + 2 * n, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    # ctypes rounds each float to f32 once (k * k and 2 k taken in double
    # first), as the TPU kernel's f32 constants are.
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            mask.data_ptr(), mask.stride(0), n, rt.data_ptr(),
            buf[16:].data_ptr(), buf.data_ptr(), huber_k, huber_k * huber_k,
            2.0 * huber_k, cluster, stream)
    return args, buf[:16], (mask, rt, buf)


def _gn_batched_args(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                     t: Tensor, huber_k: float, cluster: int | None = None,
                     threads: int | None = None):
    """Check the CUDA inputs of gn_stats_batched and allocate its output.
    The kernel reads src/dst (B, N, 2) float32 and the mask (B, N) as
    bool (true where nonzero, as the plain version takes it) in place,
    with their strides.  ``cluster``: 0 for one block a pair, else blocks
    a pair's cluster, by default ``gn_batched_route``; ``threads``: the
    one-block route's block, by default ``gn_batched_threads(N)``.
    Returns (the launcher's arguments, out (B, 16), the tensors that the
    arguments point into, which the caller holds until the launch is
    enqueued)."""
    name = "gn_stats_batched"
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    _check_cuda_f32(name, src, dst)
    b, n = src.shape[:2]
    if (src.shape != (b, n, 2) or dst.shape != src.shape
            or mask.shape != (b, n) or rot.shape != (b, 2, 2)
            or t.shape != (b, 2) or n == 0 or b == 0):
        raise ValueError(
            f"{name}: src/dst must be (B, N, 2) with N, B > 0, mask, rot and "
            f"t batched alike; got {tuple(src.shape)}, {tuple(mask.shape)}, "
            f"{tuple(rot.shape)}, {tuple(t.shape)}")
    mask = mask.to(device=src.device, dtype=torch.bool)
    if cluster is None:
        cluster = gn_batched_route(b, n, lambda c: _gn_resident(n, c))
    threads = gn_batched_threads(n) if threads is None else threads
    per = -(-n // threads)
    if cluster == 0 and (per > 8 or (per > 4 and threads > 512)):
        raise ValueError(f"{name}: one block of {threads} threads takes at "
                         "most 8 points a thread, 4 above 512 threads")
    rt = torch.cat([rot.reshape(b, 4), t], dim=-1).to(
        device=src.device, dtype=torch.float32).contiguous()
    # A cluster block keeps its slice's residuals in this scratch where
    # the slice is too large to stage (the kernel decides, and refuses a
    # null scratch there); one block a pair keeps them in registers.
    scratch = None if cluster == 0 else torch.empty(
        2 * b * n, dtype=torch.float32, device=src.device)
    out = torch.empty((b, 16), dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            mask.data_ptr(), *mask.stride(), b, n, rt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            huber_k, huber_k * huber_k, 2.0 * huber_k, cluster, threads,
            stream)
    return args, out, (mask, rt, scratch)


def gn_stats(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor, t: Tensor,
             huber_k: float) -> Tensor:
    """One robust GN update's statistics at (rot (2, 2), t (2,)): the
    packed (16,) vector of ``assemble_update`` for src/dst (N, 2) in solver
    units, mask (N,).  The kernel takes any N (the TPU kernel's N % 128 ==
    0 comes from its (M, 128) layout, not copied here)."""
    if src.device.type == "cpu":
        return gn_stats_plain(src, dst, mask, rot, t, huber_k)
    args, out, _keep = _gn_stats_args(src, dst, mask, rot, t, huber_k)
    status = cuda_build.launcher("gn_stats")(*args)
    cuda_build.LAUNCHES["gn_stats"] += 1
    if status == -1:
        raise RuntimeError(
            f"gn_stats: no thread-block cluster of {args[-2]} blocks can be "
            "placed on this card")
    cuda_build.check(status, "gn_stats")
    return out


def gn_stats_batched(src: Tensor, dst: Tensor, mask: Tensor, rot: Tensor,
                     t: Tensor, huber_k: float) -> Tensor:
    """The statistics of B pairs at once, each at its own (rot (B, 2, 2),
    t (B, 2)): (B, 16) for src/dst (B, N, 2), mask (B, N)."""
    if src.device.type == "cpu":
        return gn_stats_batched_plain(src, dst, mask, rot, t, huber_k)
    args, out, _keep = _gn_batched_args(src, dst, mask, rot, t, huber_k)
    status = cuda_build.launcher("gn_stats_batched")(*args)
    cuda_build.LAUNCHES["gn_stats_batched"] += 1
    if status == -1:
        raise RuntimeError(
            f"gn_stats_batched: no thread-block cluster of {args[-3]} blocks "
            "can be placed on this card")
    cuda_build.check(status, "gn_stats_batched")
    return out


def assemble_update(stats: Tensor, rot: Tensor):
    """(jtj (..., 3, 3), jtr (..., 3), err, count, sigma_x, sigma_y) from
    the packed stats (align2d_pallas.assemble_update), batch-agnostic:
    stats (..., 16), rot (..., 2, 2).  With J = [R | w] per point,
    sum u J_x^T J_x needs only S_u, S_uw and S_uw2 of each dimension, and
    J^T r likewise."""
    s = [stats[..., i] for i in range(14)]
    rot = rot.to(stats.dtype)
    jtj = 0.0
    jtr = 0.0
    for d in range(2):
        a, b = rot[..., d, 0], rot[..., d, 1]
        s_u, s_uw, s_uw2, s_ur, s_uwr = s[5 * d:5 * d + 5]
        jtj = jtj + torch.stack([
            torch.stack([a * a * s_u, a * b * s_u, a * s_uw], dim=-1),
            torch.stack([a * b * s_u, b * b * s_u, b * s_uw], dim=-1),
            torch.stack([a * s_uw, b * s_uw, s_uw2], dim=-1)], dim=-2)
        jtr = jtr + torch.stack([a * s_ur, b * s_ur, s_uwr], dim=-1)
    return jtj, jtr, s[10], s[11], s[12], s[13]


def gn_stats_errors(got: Tensor, want: Tensor):
    """How far packed stats ``got`` (..., 16) are from ``want``, over every
    pair: (max error of the ten sums and the Huber error, each against the
    Cauchy-Schwarz bound of its absolute terms, max |count difference|,
    max relative sigma error).  With u >= 0 the absolute terms of S_uw sum
    to at most sqrt(S_u S_uw2), those of S_ur and S_uwr to at most
    sqrt(S_u g err) and sqrt(S_uw2 g err) (u r_d^2 <= g rho(|r|^2) for
    Huber's rho, g = 1 / sigma_d); S_u, S_uw2 and the error have no
    negative terms.  So the measure is the sums' roundoff whatever
    cancellation a sum has."""
    w = want.detach().to(device="cpu", dtype=torch.float64).reshape(-1, 16)
    d = (got.detach().to(device="cpu", dtype=torch.float64).reshape(-1, 16)
         - w).abs()
    err = w[:, 10]
    scale = torch.empty_like(w[:, :11])
    for base, sig in ((0, w[:, 12]), (5, w[:, 13])):
        g = torch.where(sig != 0.0, 1.0 / torch.where(sig != 0.0, sig, 1.0),
                        0.0)
        s_u, s_uw2 = w[:, base], w[:, base + 2]
        scale[:, base] = s_u
        scale[:, base + 1] = torch.sqrt(s_u * s_uw2)
        scale[:, base + 2] = s_uw2
        scale[:, base + 3] = torch.sqrt(s_u * g * err)
        scale[:, base + 4] = torch.sqrt(s_uw2 * g * err)
    scale[:, 10] = err
    rel = float(torch.max(d[:, :11] / torch.clamp(scale, min=1e-30)))
    sig_rel = float(torch.max(d[:, 12:14] / torch.clamp(
        w[:, 12:14].abs(), min=1e-30)))
    return rel, float(torch.max(d[:, 11])), sig_rel
