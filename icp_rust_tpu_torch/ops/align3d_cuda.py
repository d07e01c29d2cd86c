"""The robust SE(3) point-to-plane kernels, their wrappers and their plain
PyTorch versions:

- ``csrc/p2l_loop.cu``: the whole fixed-correspondence p2l IRLS loop of
  one cloud in one launch on a thread-block cluster of ``p2l_cluster(N)``
  blocks (align3d_pallas ``_p2l_loop_kernel``; ``csrc/p2l_cluster.cuh``);
- ``csrc/p2l_stats.cu``: one GN update's packed statistics at a given
  transform on a cluster of ``p2l_cluster(N)`` blocks (``_p2l_kernel``).

Both run ``csrc/p2l_cluster.cuh``'s ``p2l_cluster_run`` (p2l_loop the
whole loop with ``csrc/p2l.cuh``'s scalar tail, p2l_stats one pass of
its body without the tail), so they share one op sequence.  The plain
versions follow the TPU kernels' op sequence, not the
``align_backend="torch"`` loop: the exact radix median and MAD of the
scalar residual (``ops/select``), the 21 + 6 sums and the Huber error,
and for the loop the 6x6 Cholesky in ``_chol_solve6``'s order written
out over the six indices, ``ok = solve_ok & n >= 6 & sigma != 0`` with
no residual gate, the stop order of ``align3d_pallas.py:285-290`` and
the SE(3) exp with the ``eps_f32**0.25`` branch.  A wrapper takes the
plain version only for a CPU tensor; a CUDA tensor reaches the kernel or
raises.  The kernels take float32 only.

Tolerance against the plain versions: float32 roundoff of the sums,
which are taken in another order (float64 over the cluster, rounded
once, vs torch's float32 reductions); the medians are exact order
statistics of residuals that may differ in their last bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from icp_rust_tpu_torch.ops import cuda_build, robust

_SMALL_ANGLE_F32 = float(torch.finfo(torch.float32).eps) ** 0.25
# Blocks in p2l_loop's and p2l_stats' thread-block cluster: 16 above this
# many points, else 8 (on an H100 16 is 6-10 % faster at 28,160-28,800
# points, 8 is 3-19 % faster at 3,072-14,400; PERF.md).  Which points each
# block sums follows from N alone, so it is a rule, not a knob.
P2L_CLUSTER_16_ABOVE = 16384


def p2l_cluster(n: int) -> int:
    """The cluster size p2l_loop and p2l_stats launch for n points."""
    return 16 if n > P2L_CLUSTER_16_ABOVE else 8
# (i, j) -> index into the 21 row-major upper-triangle sums.
_SYM6 = [[min(i, j) * 6 - min(i, j) * (min(i, j) - 1) // 2
          + abs(i - j) for j in range(6)] for i in range(6)]


def _columns(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor):
    """The ten (N,) columns sx sy sz dx dy dz nx ny nz mask (mask as 1.0
    for true), contiguous."""
    cols = [x[:, k].contiguous() for x in (src, dst, normals)
            for k in range(3)]
    return cols + [mask.to(device=src.device, dtype=src.dtype).contiguous()]


def _residuals(rot9, t3, cols):
    """(px, py, pz, r): the moved points p = R s + t and the residuals r =
    n . (p - d) at the transform (rot9, t3) (0-d tensors), in the kernels'
    op order."""
    sx, sy, sz, dx, dy, dz, nx, ny, nz, _ = cols
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot9
    tx, ty, tz = t3
    px = r00 * sx + r01 * sy + r02 * sz + tx
    py = r10 * sx + r11 * sy + r12 * sz + ty
    pz = r20 * sx + r21 * sy + r22 * sz + tz
    return px, py, pz, nx * (px - dx) + ny * (py - dy) + nz * (pz - dz)


def identity_residuals(src: Tensor, dst: Tensor, normals: Tensor,
                       mask: Tensor) -> Tensor:
    """The residuals of the loop's first iteration (at the identity), as
    the kernels and the plain versions form them."""
    cols = _columns(src, dst, normals, mask)
    one = torch.ones((), dtype=src.dtype, device=src.device)
    zero = torch.zeros_like(one)
    rot9 = [one, zero, zero, zero, one, zero, zero, zero, one]
    return _residuals(rot9, [zero, zero, zero], cols)[3]


def _stats_core(rot9, t3, cols, huber_k: float):
    """_p2l_stats_core on tensors: returns (jtj (21 0-d), jtr (6 0-d),
    err, sigma, n) at the transform (rot9, t3) (0-d tensors)."""
    nx, ny, nz, mf = cols[6:]
    px, py, pz, r = _residuals(rot9, t3, cols)

    mask = mf > 0.5
    med, _ = robust.masked_median(r, mask)
    mad, _ = robust.masked_median(torch.abs(r - med), mask)
    sig = robust.MAD_SCALE * mad
    one = torch.ones_like(sig)
    g = torch.where(sig != 0.0, one / torch.where(sig != 0.0, sig, one),
                    torch.zeros_like(sig))
    # k^2 and 2k rounded once to the working type, as the kernels' f32
    # parameters are; a tensor divisor keeps k / sqrt(e) a true division.
    k2 = huber_k * huber_k
    hk = torch.tensor(huber_k, dtype=r.dtype, device=r.device)
    e = r * r
    u = torch.where(e <= k2, one, hk / torch.sqrt(e)) * g * mf
    js = (nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz,
          px * ny - py * nx)
    jtj = [torch.sum(u * js[a] * js[b]) for a in range(6)
           for b in range(a, 6)]
    jtr = [torch.sum(u * js[a] * r) for a in range(6)]
    rho = torch.where(e <= k2, e, 2.0 * huber_k * torch.sqrt(e) - k2)
    return jtj, jtr, torch.sum(rho * mf), sig, torch.sum(mask)


def _chol_solve6(jtj, jtr):
    """_chol_solve6 on 0-d tensors: jtj the 21 upper-triangle sums
    (row-major), jtr the 6 right-hand sides.  Returns (x list of 6, ok)."""
    zero = torch.zeros_like(jtr[0])
    one = torch.ones_like(jtr[0])
    ok = torch.ones_like(jtr[0], dtype=torch.bool)
    l = [[zero] * 6 for _ in range(6)]
    for i in range(6):
        d = jtj[_SYM6[i][i]]
        for k in range(i):
            d = d - l[i][k] * l[i][k]
        ok = ok & (d > 0.0)
        lii = torch.sqrt(torch.where(d > 0.0, d, one))
        l[i][i] = lii
        inv_lii = one / lii
        for j in range(i + 1, 6):
            v = jtj[_SYM6[j][i]]
            for k in range(i):
                v = v - l[j][k] * l[i][k]
            l[j][i] = v * inv_lii
    y = [None] * 6
    for i in range(6):
        v = jtr[i]
        for k in range(i):
            v = v - l[i][k] * y[k]
        y[i] = v / l[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        v = y[i]
        for k in range(i + 1, 6):
            v = v - l[k][i] * x[k]
        x[i] = v / l[i][i]
    for i in range(6):
        ok = ok & torch.isfinite(x[i])
    return x, ok


def _exp_compose(d, rot9, t3, small_angle: float):
    """Exp(d) o (rot9, t3) in _p2l_loop_kernel's op order (align3d_pallas.py
    :292-348); every divisor a tensor, so each division is a true one."""
    w0, w1, w2 = d[3], d[4], d[5]
    c = {v: torch.full_like(w0, v) for v in (1.0, 6.0, 24.0, 120.0)}
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = torch.sqrt(th2)
    small = th < small_angle
    safe2 = torch.where(small, c[1.0], th2)
    safe = torch.sqrt(safe2)
    av = torch.where(small, 1.0 - th2 / c[6.0], torch.sin(safe) / safe)
    bv = torch.where(small, 0.5 - th2 / c[24.0],
                     (1.0 - torch.cos(safe)) / safe2)
    cv = torch.where(small, 1.0 / 6.0 - th2 / c[120.0],
                     (safe - torch.sin(safe)) / (safe2 * safe))
    k2_00 = -(w1 * w1 + w2 * w2)
    k2_11 = -(w0 * w0 + w2 * w2)
    k2_22 = -(w0 * w0 + w1 * w1)
    k2_01 = w0 * w1
    k2_02 = w0 * w2
    k2_12 = w1 * w2
    e = [1.0 + bv * k2_00, -av * w2 + bv * k2_01, av * w1 + bv * k2_02,
         av * w2 + bv * k2_01, 1.0 + bv * k2_11, -av * w0 + bv * k2_12,
         -av * w1 + bv * k2_02, av * w0 + bv * k2_12, 1.0 + bv * k2_22]
    v = [1.0 + cv * k2_00, -bv * w2 + cv * k2_01, bv * w1 + cv * k2_02,
         bv * w2 + cv * k2_01, 1.0 + cv * k2_11, -bv * w0 + cv * k2_12,
         -bv * w1 + cv * k2_02, bv * w0 + cv * k2_12, 1.0 + cv * k2_22]
    td = [v[3 * i] * d[0] + v[3 * i + 1] * d[1] + v[3 * i + 2] * d[2]
          for i in range(3)]
    r = rot9
    nr = [e[3 * i] * r[j] + e[3 * i + 1] * r[3 + j] + e[3 * i + 2] * r[6 + j]
          for i in range(3) for j in range(3)]
    nt = [e[3 * i] * t3[0] + e[3 * i + 1] * t3[1] + e[3 * i + 2] * t3[2]
          + td[i] for i in range(3)]
    return nr, nt


def p2l_stats_plain(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
                    rot: Tensor, t: Tensor, huber_k: float) -> Tensor:
    """Plain PyTorch version of the p2l_stats kernel (_p2l_kernel): the
    packed (32,) statistics at (rot, t) in src's dtype."""
    cols = _columns(src, dst, normals, mask)
    rot9 = [rot.to(src.dtype)[i, j] for i in range(3) for j in range(3)]
    t3 = [t.to(src.dtype)[i] for i in range(3)]
    jtj, jtr, err, sig, n = _stats_core(rot9, t3, cols, huber_k)
    zero = torch.zeros_like(err)
    return torch.stack(jtj + jtr + [err, n.to(err.dtype), sig, zero, zero])


def p2l_loop_plain(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
                   huber_k: float, tol_d2: float, max_iter: int,
                   point_scale: float):
    """Plain PyTorch version of the p2l_loop kernel (_p2l_loop_kernel) from
    the identity, in src's dtype.  Returns (rot (3, 3), t (3,), iterations
    (0-d int32))."""
    cols = _columns(src, dst, normals, mask)
    one = torch.ones((), dtype=src.dtype, device=src.device)
    zero = torch.zeros_like(one)
    rot9 = [one, zero, zero, zero, one, zero, zero, zero, one]
    t3 = [zero, zero, zero]
    prev_err = torch.full_like(one, torch.finfo(src.dtype).max)
    # point_scale^2 and the tolerance rounded once to the working type.
    s2 = torch.full_like(one, point_scale * point_scale)
    tol = torch.full_like(one, tol_d2)
    it, done = 0, False
    while it < max_iter and not done:
        jtj, jtr, err, sig, n = _stats_core(rot9, t3, cols, huber_k)
        x, solve_ok = _chol_solve6(jtj, jtr)
        ok = solve_ok & (n >= 6) & (sig != 0.0)
        d = [torch.where(ok, -xi, zero) for xi in x]
        stop = ~ok
        d2_phys = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * s2 + (
            d[3] * d[3] + d[4] * d[4] + d[5] * d[5])
        stop = stop | (d2_phys < tol)
        stop = stop | (err > prev_err)
        nr, nt = _exp_compose(d, rot9, t3, _SMALL_ANGLE_F32)
        rot9 = [torch.where(stop, c, n_) for c, n_ in zip(rot9, nr)]
        t3 = [torch.where(stop, c, n_) for c, n_ in zip(t3, nt)]
        prev_err = torch.where(stop, prev_err, err)
        it += 1
        done = bool(stop)
    return (torch.stack(rot9).reshape(3, 3), torch.stack(t3),
            torch.tensor(it, dtype=torch.int32))


def _check(name: str, src, dst, normals, mask) -> int:
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    n = src.shape[0]
    for x in (src, dst, normals):
        if x.device != src.device:
            raise ValueError(f"{name}: tensors on {x.device} and "
                             f"{src.device}")
        if x.dtype != torch.float32:
            raise TypeError(
                f"{name}: the kernel takes float32, got {x.dtype} (the "
                "float64 reference path runs on the CPU)")
        if x.shape != (n, 3):
            raise ValueError(f"{name}: src/dst/normals must be (N, 3)")
    if mask.shape != (n,) or n == 0:
        raise ValueError(f"{name}: mask must be (N,) with N > 0")
    return n


def _check_mask(name: str, src: Tensor, mask: Tensor) -> None:
    """The p2l kernels read a bool or float32 mask (true above 0.5) on
    src's device."""
    if (mask.dtype not in (torch.bool, torch.float32)
            or mask.device != src.device):
        raise TypeError(f"{name}: mask must be bool or float32 on "
                        f"{src.device}")


def _p2l_loop_args(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
                   huber_k: float, tol_d2: float, max_iter: int,
                   point_scale: float, cluster: int | None = None):
    """Check the CUDA inputs of the p2l_loop kernel and allocate its output
    and scratch.  The kernel reads src, dst and normals (N, 3) float32 and
    the bool or float32 mask (N,) in place, with their strides.  Returns
    (the launcher's arguments, out (16,), the scratch): out holds r00..r22
    (row-major), tx ty tz, iterations, then the first iteration's median,
    MAD and sigma.  ``cluster`` defaults to ``p2l_cluster(N)``."""
    n = _check("p2l_loop", src, dst, normals, mask)
    cluster = p2l_cluster(n) if cluster is None else cluster
    _check_mask("p2l_loop", src, mask)
    buf = torch.empty(16 + n, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    # ctypes rounds each float to f32 once (k*k, 2k and s^2 taken in
    # double first), as the TPU kernel's f32 constants are.
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            normals.data_ptr(), *normals.stride(), mask.data_ptr(),
            mask.stride(0), int(mask.dtype == torch.float32), n,
            buf[16:].data_ptr(), buf.data_ptr(), huber_k, huber_k * huber_k,
            2.0 * huber_k, tol_d2, int(max_iter), point_scale * point_scale,
            _SMALL_ANGLE_F32, cluster, stream)
    return args, buf[:16], buf


def p2l_loop_out(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
                 huber_k: float, tol_d2: float, max_iter: int,
                 point_scale: float) -> Tensor:
    """Launch p2l_loop on CUDA tensors; returns its (16,) output (see
    ``_p2l_loop_args``)."""
    args, out, _scratch = _p2l_loop_args(src, dst, normals, mask, huber_k,
                                         tol_d2, max_iter, point_scale)
    status = cuda_build.launcher("p2l_loop")(*args)
    cuda_build.LAUNCHES["p2l_loop"] += 1
    if status == -1:
        raise RuntimeError(
            f"p2l_loop: no thread-block cluster of {args[-2]} blocks can be "
            "placed on this card")
    cuda_build.check(status, "p2l_loop")
    return out


def p2l_loop(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
             huber_k: float, tol_d2: float, max_iter: int,
             point_scale: float):
    """The fixed-correspondence p2l IRLS loop from the identity: src, dst
    (the matched plane points) and normals (N, 3) in solver units, mask
    (N,), huber_k in solver units.  Returns (rot (3, 3), t (3,),
    iterations): a 0-d tensor, int32 from the plain version, float from
    the kernel."""
    if src.device.type == "cpu":
        return p2l_loop_plain(src, dst, normals, mask, huber_k, tol_d2,
                              max_iter, point_scale)
    out = p2l_loop_out(src, dst, normals, mask, huber_k, tol_d2, max_iter,
                       point_scale)
    return out[:9].reshape(3, 3), out[9:12], out[12]


def _p2l_stats_args(src: Tensor, dst: Tensor, normals: Tensor,
                    mask: Tensor, rot: Tensor, t: Tensor, huber_k: float,
                    cluster: int | None = None):
    """Check the CUDA inputs of the p2l_stats kernel and allocate its
    output and scratch.  The kernel reads src, dst and normals (N, 3)
    float32 and the bool or float32 mask (N,) in place, with their
    strides.  ``cluster`` defaults to ``p2l_cluster(N)``.  Returns (the
    launcher's arguments, out (32,), the tensors that the arguments point
    into, which the caller holds until the launch is enqueued)."""
    n = _check("p2l_stats", src, dst, normals, mask)
    if rot.shape != (3, 3) or t.shape != (3,):
        raise ValueError("p2l_stats: rot must be (3, 3), t (3,)")
    _check_mask("p2l_stats", src, mask)
    cluster = p2l_cluster(n) if cluster is None else cluster
    rt = torch.cat([rot.reshape(9), t]).to(
        device=src.device, dtype=torch.float32).contiguous()
    buf = torch.empty(32 + n, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    args = (src.data_ptr(), *src.stride(), dst.data_ptr(), *dst.stride(),
            normals.data_ptr(), *normals.stride(), mask.data_ptr(),
            mask.stride(0), int(mask.dtype == torch.float32), n,
            rt.data_ptr(), buf[32:].data_ptr(), buf.data_ptr(), huber_k,
            huber_k * huber_k, 2.0 * huber_k, cluster, stream)
    return args, buf[:32], (rt, buf)


def p2l_stats(src: Tensor, dst: Tensor, normals: Tensor, mask: Tensor,
              rot: Tensor, t: Tensor, huber_k: float) -> Tensor:
    """One p2l GN update's statistics at (rot (3, 3), t (3,)): the packed
    (32,) vector of ``assemble_p2l``."""
    if src.device.type == "cpu":
        return p2l_stats_plain(src, dst, normals, mask, rot, t, huber_k)
    args, out, _keep = _p2l_stats_args(src, dst, normals, mask, rot, t,
                                       huber_k)
    status = cuda_build.launcher("p2l_stats")(*args)
    cuda_build.LAUNCHES["p2l_stats"] += 1
    if status == -1:
        raise RuntimeError(
            f"p2l_stats: no thread-block cluster of {args[-2]} blocks can be "
            "placed on this card")
    cuda_build.check(status, "p2l_stats")
    return out


def stats_errors(got: Tensor, want: Tensor):
    """How far packed stats ``got`` are from ``want``: (max error of the 27
    sums and the Huber error, each against the Cauchy-Schwarz bound of
    its absolute terms, |count difference|, relative sigma error).  With u
    >= 0 the absolute terms of JtJ_ab sum to at most sqrt(JtJ_aa JtJ_bb),
    those of Jtr_a to at most sqrt(JtJ_aa g err) (u r^2 <= g rho(r^2) for
    Huber's rho, g = 1 / sigma), so the measure is the sums' roundoff
    whatever cancellation a sum has."""
    w = want.detach().to(device="cpu", dtype=torch.float64)
    d = (got.detach().to(device="cpu", dtype=torch.float64) - w).abs()
    diag = w[[_SYM6[a][a] for a in range(6)]]
    g = 1.0 / float(w[29]) if float(w[29]) != 0.0 else 0.0
    scale = torch.empty(28, dtype=torch.float64)
    for a in range(6):
        for b in range(a, 6):
            scale[_SYM6[a][b]] = torch.sqrt(diag[a] * diag[b])
        scale[21 + a] = torch.sqrt(diag[a] * g * w[27])
    scale[27] = w[27]
    rel = float(torch.max(d[:28] / torch.clamp(scale, min=1e-30)))
    return rel, float(d[28]), float(d[29]) / max(abs(float(w[29])), 1e-30)


def assemble_p2l(stats: Tensor):
    """(jtj (6, 6), jtr (6,), err, count, sigma) from the packed stats."""
    idx = torch.tensor(_SYM6, dtype=torch.int64, device=stats.device)
    return stats[idx], stats[21:27], stats[27], stats[28], stats[29]
