"""The port's single and batched GN-statistics kernels' plain versions
(``ops/align2d_cuda.gn_stats_plain``, ``gn_stats_batched_plain``), its
``weighted_gn_update_cuda`` and the rest of ``ops/align2d`` (``error``,
``huber_error``, ``gauss_newton_update``) against the JAX package, on the
CPU.  The JAX side runs its Pallas kernels in interpret mode, as its own
tests/test_align_pallas.py does.

Tolerances:
- Packed statistics, float32: each of the ten sums and the Huber error
  within STATS_TOL of the Cauchy-Schwarz bound of its absolute terms (f32
  sums in another order; ``align2d_cuda.gn_stats_errors``), the count
  exact, sigma within SIGMA_TOL relative (an exact order statistic of
  residuals that may differ in their last bit).
- ``weighted_gn_update_cuda`` against ``weighted_gn_update_pallas``: the
  JAX test's own gates, delta rtol 2e-4 and atol 1e-6, ``ok`` equal, the
  error rtol 1e-5.
- ``error``, ``huber_error`` and ``gauss_newton_update``, float64: 1e-12
  (the same formulas; the sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT
from icp_rust_tpu.ops import align2d as j_align
from icp_rust_tpu.ops import align2d_pallas as j_pallas
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, cuda_build

STATS_TOL = 1e-5
SIGMA_TOL = 1e-6
HUBER_K = 1.345


def _problem(seed=0, n=256, masked=True):
    """tests/test_align_pallas.py's problem: a rotated, shifted, noisy copy
    with every 17th point an outlier and ~20 % masked."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    th = 0.15
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, -s], [s, c]], np.float32)
    dst = src @ rot.T + np.array([0.3, -0.2], np.float32)
    dst += rng.normal(0, 0.05, dst.shape).astype(np.float32)
    dst[::17] += 3.0  # outliers exercise the Huber branch
    mask = (rng.random(n) > 0.2) if masked else np.ones(n, bool)
    return src, dst, mask


def _rt(th, t, batch=()):
    c, s = np.cos(th), np.sin(th)
    rot = np.broadcast_to(np.array([[c, -s], [s, c]], np.float32),
                          (*batch, 2, 2)).copy()
    return rot, np.broadcast_to(np.asarray(t, np.float32),
                                (*batch, 2)).copy()


def _batch(seed=0, b=4, n=256):
    """tests/test_align_pallas.py's batch: odd and even valid counts and a
    fully masked row."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (b, n, 2)).astype(np.float32)
    dst = src + rng.normal(0, 0.1, (b, n, 2)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    mask[3] = False
    rot, _ = _rt(0.2, (0.0, 0.0), (b,))
    t = rng.normal(0, 0.1, (b, 2)).astype(np.float32)
    return src, dst, mask, rot, t


def _tt(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _jj(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("case", ["identity", "rotated", "unmasked"])
def test_gn_stats_plain_matches_pallas_interpret(case):
    seed, (rot, t) = {"identity": (0, _rt(0.0, (0.0, 0.0))),
                      "rotated": (3, _rt(-0.4, (0.4, 0.1))),
                      "unmasked": (5, _rt(0.1, (0.2, -0.1)))}[case]
    src, dst, mask = _problem(seed, masked=case != "unmasked")
    want = j_pallas.gn_stats_pallas(*_jj(src, dst, mask, rot, t), HUBER_K,
                                    interpret=True)
    got = align2d_cuda.gn_stats(*_tt(src, dst, mask, rot, t), HUBER_K)
    assert got.shape == (16,) and got.dtype == torch.float32
    rel, dn, sig_rel = align2d_cuda.gn_stats_errors(
        got, torch.as_tensor(np.array(want)))
    assert rel <= STATS_TOL and dn == 0 and sig_rel <= SIGMA_TOL
    assert float(got[11]) == mask.sum()
    assert float(got[14]) == float(got[15]) == 0.0


def test_gn_stats_batched_plain_matches_pallas_interpret():
    src, dst, mask, rot, t = _batch()
    counts = mask.sum(axis=1)
    assert counts[3] == 0 and len(set(counts[:3] % 2)) == 2  # odd and even
    want = j_pallas.gn_stats_pallas_batched(*_jj(src, dst, mask, rot, t),
                                            HUBER_K, interpret=True)
    got = align2d_cuda.gn_stats_batched(*_tt(src, dst, mask, rot, t),
                                        HUBER_K)
    assert got.shape == (4, 16)
    rel, dn, sig_rel = align2d_cuda.gn_stats_errors(
        got, torch.as_tensor(np.array(want)))
    assert rel <= STATS_TOL and dn == 0 and sig_rel <= SIGMA_TOL
    # The fully masked pair: zero sums, count 0, sigma 0, as on the TPU.
    assert torch.equal(got[3], torch.zeros(16))
    # Each pair equals the single-cloud plain version.
    for i in range(4):
        one = align2d_cuda.gn_stats_plain(*_tt(src[i], dst[i], mask[i],
                                               rot[i], t[i]), HUBER_K)
        torch.testing.assert_close(got[i], one, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("batched", [False, True])
def test_weighted_gn_update_cuda_matches_pallas_update(batched):
    if batched:
        src, dst, mask, rot, t = _batch(seed=2)
    else:
        src, dst, mask = _problem(seed=3)
        rot, t = _rt(-0.4, (0.4, 0.1))
    want = j_align.weighted_gn_update_pallas(
        JT(*_jj(rot, t)), *_jj(src, dst, mask), HUBER_K, interpret=True)
    got = align2d.weighted_gn_update_cuda(
        RigidTransform2(*_tt(rot, t)), *_tt(src, dst, mask), HUBER_K)
    np.testing.assert_allclose(got.delta.numpy(), np.asarray(want.delta),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               rtol=1e-5)
    if batched:  # the fully masked pair is not ok and does not move
        assert not bool(got.ok[3]) and torch.equal(got.delta[3],
                                                   torch.zeros(3))


def test_weighted_gn_update_cuda_matches_the_einsum_update():
    """The packed-statistics update against the port's own einsum update
    (weighted_gauss_newton_update), as tests/test_align_pallas.py holds the
    TPU kernel against the XLA path."""
    src, dst, mask = _tt(*_problem(seed=0))
    t = RigidTransform2.identity()
    got = align2d.weighted_gn_update_cuda(t, src, dst, mask, HUBER_K)
    want = align2d.weighted_gauss_newton_update(t, src, dst, mask, HUBER_K)
    torch.testing.assert_close(got.delta, want.delta, rtol=2e-4, atol=1e-6)
    assert bool(got.ok) == bool(want.ok)
    torch.testing.assert_close(got.err, want.err, rtol=1e-5, atol=0)


def test_assemble_update_matches_jax():
    src, dst, mask, rot, t = _batch(seed=4)
    stats = align2d_cuda.gn_stats_batched(*_tt(src, dst, mask, rot, t),
                                          HUBER_K)
    got = align2d_cuda.assemble_update(stats, torch.as_tensor(rot))
    want = j_pallas.assemble_update(jnp.asarray(stats.numpy()),
                                    jnp.asarray(rot))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(got[0], got[0].transpose(-1, -2))


def _f64_problem(batch=()):
    rng = np.random.default_rng(9)
    n = 200
    src = rng.uniform(-2, 2, (*batch, n, 2))
    dst = src + rng.normal(0, 0.1, src.shape)
    dst[..., ::13, :] += 2.0
    mask = rng.random((*batch, n)) > 0.15
    th = rng.uniform(-0.3, 0.3, batch)
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    t = rng.normal(0, 0.2, (*batch, 2))
    return src, dst, mask, rot, t


@pytest.mark.parametrize("batch", [(), (3,)])
def test_error_huber_error_and_gauss_newton_update_match_jax_f64(batch):
    src, dst, mask, rot, t = _f64_problem(batch)
    jt, pt = JT(*_jj(rot, t)), RigidTransform2(*_tt(rot, t))
    js, jd, jm = _jj(src, dst, mask)
    ps, pd, pm = _tt(src, dst, mask)
    np.testing.assert_allclose(align2d.error(pt, ps, pd, pm).numpy(),
                               np.asarray(j_align.error(jt, js, jd, jm)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        align2d.huber_error(pt, ps, pd, pm, HUBER_K).numpy(),
        np.asarray(j_align.huber_error(jt, js, jd, jm, HUBER_K)),
        rtol=1e-12, atol=1e-12)
    want = j_align.gauss_newton_update(jt, js, jd, jm, 1e-12)
    got = align2d.gauss_newton_update(pt, ps, pd, pm, 1e-12)
    np.testing.assert_allclose(got.delta.numpy(), np.asarray(want.delta),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               rtol=1e-12)
    assert got.delta.dtype == torch.float64
    # The plain update's err is the unweighted sum (GNUpdate's note).
    torch.testing.assert_close(got.err, align2d.error(pt, ps, pd, pm))


def test_gauss_newton_update_degenerate_is_not_ok():
    src = torch.zeros((4, 2), dtype=torch.float64)
    mask = torch.tensor([True, False, False, False])
    t = RigidTransform2.identity(dtype=torch.float64)
    upd = align2d.gauss_newton_update(t, src, src + 0.1, mask)
    assert not bool(upd.ok)
    assert torch.equal(upd.delta, torch.zeros(3, dtype=torch.float64))


def test_gn_stats_wrappers_refuse_other_devices_and_shapes():
    src, dst, mask, rot, t = _tt(*_batch(seed=1))
    meta = [x.to("meta") for x in (src, dst, mask, rot, t)]
    with pytest.raises(ValueError, match="unsupported device"):
        align2d_cuda.gn_stats_batched(*meta, HUBER_K)
    with pytest.raises(ValueError, match="unsupported device"):
        align2d_cuda.gn_stats(*[x[0] for x in meta], HUBER_K)
    for name in ("gn_stats", "gn_stats_batched"):
        assert name in cuda_build.SOURCES and name in cuda_build._SIGNATURES
        assert name in cuda_build.LAUNCHES


def test_gn_batched_route_rule():
    """Kernel 13's route (``align2d_cuda.gn_batched_route``): one block a
    pair (0) up to GN_BATCHED_BLOCK_MAX_POINTS points, its block about
    GN_BATCHED_POINTS points a thread, at most 512 threads and 8 points a
    thread; above, kernel 7's cluster rule (here on a card that holds 132
    blocks, one an SM)."""
    resident = lambda c: 132 // c  # noqa: E731
    route, lim = (align2d_cuda.gn_batched_route,
                  align2d_cuda.GN_BATCHED_BLOCK_MAX_POINTS)
    assert route(211, 768, resident) == 0 and route(1, lim, resident) == 0
    assert route(11, 28160, resident) == 8
    for b, n in ((1, lim + 1), (11, 28160), (40, 28160), (200, 28160)):
        assert route(b, n, resident) == align2d_cuda.batched_cluster(
            b, n, resident, 0)
    for n in (1, 100, 101, 768, 1000, 3072, lim):
        t = align2d_cuda.gn_batched_threads(n)
        per = -(-n // t)
        assert t % 32 == 0 and 64 <= t <= 512 and per <= 8
        assert per <= align2d_cuda.GN_BATCHED_POINTS or t == 512
    assert align2d_cuda.gn_batched_threads(768) == \
        32 * -(-768 // (32 * align2d_cuda.GN_BATCHED_POINTS))


@pytest.mark.parametrize("kernel", ["gn_stats", "p2l_stats"])
def test_stats_cluster_rule_and_slices(kernel):
    """Kernels 12 and 14's cluster sizes (``align2d_cuda.gn_cluster``,
    ``align3d_cuda.p2l_cluster``): 8 blocks up to 16,384 points, 16
    above.  Block r of C takes the points [min(N, r per), min(N, (r + 1)
    per)), per = ceil(N / C) (irls_cluster.cuh's irls_cluster_pair,
    p2l_stats.cu's kernel), which cover [0, N) exactly and in order; a
    block stages its slice in shared memory up to 200 KB (25 and 41 bytes
    a point) and reads it in place above, as at 140,000 points."""
    from icp_rust_tpu_torch.ops import align3d_cuda

    rule, point_bytes = ((align2d_cuda.gn_cluster, 25) if kernel == "gn_stats"
                         else (align3d_cuda.p2l_cluster, 41))
    for n, want in ((1, 8), (999, 8), (16384, 8), (16385, 16), (28800, 16),
                    (140000, 16)):
        c = rule(n)
        assert c == want
        per = -(-n // c)
        bounds = [(min(n, r * per), min(n, (r + 1) * per)) for r in range(c)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] and a[0] <= a[1]
                   for a, b in zip(bounds, bounds[1:]))
        assert (per * point_bytes <= 200 * 1024) == (n != 140000)
