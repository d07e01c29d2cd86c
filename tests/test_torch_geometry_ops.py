"""The port's geometry and scalar ops against the JAX package on the same
inputs (made with numpy from a seed).

Tolerances: float64 results agree to <= 1e-12 (the same formulas in the
same op order; only libm's sin/cos/atan2 may differ in the last ulp).
Order statistics (medians, MAD, k-th smallest) are exact selections, so
they agree bitwise in both float widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.geometry import se2 as j_se2
from icp_rust_tpu.geometry import so2 as j_so2
from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT
from icp_rust_tpu.ops import huber as j_huber
from icp_rust_tpu.ops import linalg as j_linalg
from icp_rust_tpu.ops import robust as j_robust
from icp_rust_tpu.ops import select as j_select
from icp_rust_tpu_torch.geometry import se2, so2
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2 as TT
from icp_rust_tpu_torch.ops import huber, linalg, robust, select

F64_TOL = 1e-12
DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "f64": (np.float64, jnp.float64, torch.float64)}


def _np(x):
    return np.array(x)


def _thetas():
    rng = np.random.default_rng(0)
    return np.concatenate([
        [0.0, np.pi, -np.pi, 1e-9, -3e-5, 1.1e-4, 1.3e-4, 0.5 * np.pi],
        rng.uniform(-np.pi, np.pi, 24),
    ])


def test_so2_exp_log_identity():
    th = _thetas()
    got = so2.exp(torch.as_tensor(th))
    want = j_so2.exp(jnp.asarray(th))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(so2.log(got).numpy(), _np(j_so2.log(want)),
                               atol=F64_TOL, rtol=0)
    assert torch.equal(so2.identity((3,), torch.float64),
                       torch.as_tensor(_np(j_so2.identity((3,),
                                                          jnp.float64))))


def _twists(seed=1, n=32):
    rng = np.random.default_rng(seed)
    tw = rng.uniform(-2, 2, (n, 3))
    tw[:, 2] = _thetas()[:n]
    return tw


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_se2_calc_rt_exp_log(prec):
    npt, jdt, tdt = DT[prec]
    tw = _twists().astype(npt)
    rot, t = se2.calc_rt(torch.as_tensor(tw))
    jrot, jt = j_se2.calc_rt(jnp.asarray(tw, jdt))
    tol = F64_TOL if prec == "f64" else 2e-6
    np.testing.assert_allclose(rot.numpy(), _np(jrot), atol=tol, rtol=0)
    np.testing.assert_allclose(t.numpy(), _np(jt), atol=tol, rtol=0)
    m = se2.exp(torch.as_tensor(tw))
    jm = j_se2.exp(jnp.asarray(tw, jdt))
    np.testing.assert_allclose(m.numpy(), _np(jm), atol=tol, rtol=0)
    np.testing.assert_allclose(se2.log(m).numpy(), _np(j_se2.log(jm)),
                               atol=tol * 10, rtol=0)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_se2_small_angle_branch(prec):
    npt, jdt, tdt = DT[prec]
    thr = float(np.finfo(npt).eps) ** 0.25
    th = np.array([0.0, thr * 0.5, -thr * 0.999, thr * 1.001], npt)
    a, b = se2._v_coeffs(torch.as_tensor(th))
    ja, jb = j_se2._v_coeffs(jnp.asarray(th, jdt))
    tol = F64_TOL if prec == "f64" else 1e-7
    np.testing.assert_allclose(a.numpy(), _np(ja), atol=tol, rtol=0)
    np.testing.assert_allclose(b.numpy(), _np(jb), atol=tol, rtol=0)
    assert a[0].item() == 1.0 and b[0].item() == 0.0


def test_transform2d_ops():
    rng = np.random.default_rng(2)
    tw_a, tw_b = _twists(3, 8), _twists(4, 8)
    pts = rng.uniform(-5, 5, (8, 40, 2))
    a, b = TT.from_twist(torch.as_tensor(tw_a)), TT.from_twist(
        torch.as_tensor(tw_b))
    ja, jb = JT.from_twist(jnp.asarray(tw_a)), JT.from_twist(
        jnp.asarray(tw_b))
    pairs = [
        (a.apply_points(torch.as_tensor(pts)), ja.apply_points(
            jnp.asarray(pts))),
        (a.inverse().rot, ja.inverse().rot), (a.inverse().t, ja.inverse().t),
        (a.compose(b).rot, ja.compose(jb).rot),
        (a.compose(b).t, ja.compose(jb).t),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F64_TOL,
                                   rtol=0)
    ident = TT.identity((2,), torch.float64)
    jident = JT.identity((2,), jnp.float64)
    assert torch.equal(ident.rot, torch.as_tensor(_np(jident.rot)))
    assert a.astype(torch.float32).dtype == torch.float32


# ---------------- huber ----------------------------------------------------


@pytest.mark.parametrize("k", [0.1, 1.345, 4.0])
def test_huber_rho_drho(k):
    rng = np.random.default_rng(5)
    e = np.concatenate([[0.0, k * k, 1e-320], rng.uniform(0, 9 * k * k, 64)])
    # XLA may take k/sqrt(e) as k*rsqrt(e): 1 ulp apart.
    np.testing.assert_allclose(
        huber.rho(torch.as_tensor(e), k).numpy(),
        _np(j_huber.rho(jnp.asarray(e), k)), rtol=F64_TOL, atol=0)
    np.testing.assert_allclose(
        huber.drho(torch.as_tensor(e), k).numpy(),
        _np(j_huber.drho(jnp.asarray(e), k)), rtol=F64_TOL, atol=0)


# ---------------- linalg ---------------------------------------------------

_SINGULAR = [np.zeros((3, 3)),
             np.array([[3.0, 1.0, 2.0], [6.0, 2.0, 4.0], [9.0, 9.0, 7.0]])]
_DENORMAL = np.array([
    [3.00792510e-38, -1.97985750e-45, 3.61627897e-44],
    [7.09699991e-49, -3.08764937e-49, -8.31427092e-41],
    [2.03723891e-42, -3.84594910e-42, 1.00872600e-40],
])
_NEAR = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1e-30]])


@pytest.mark.parametrize("case", ["random", "singular", "denormal", "near"])
@pytest.mark.parametrize("det_rel_eps", [0.0, 1e-6])
def test_solve3x3_matches_jax(case, det_rel_eps):
    rng = np.random.default_rng(6)
    if case == "random":
        m = rng.normal(size=(16, 3, 3))
    elif case == "singular":
        m = np.stack(_SINGULAR)
    elif case == "denormal":
        m = _DENORMAL[None]
    else:
        m = _NEAR[None]
    b = rng.normal(size=m.shape[:-1])
    x, ok = linalg.solve3x3(torch.as_tensor(m), torch.as_tensor(b),
                            det_rel_eps)
    jx, jok = j_linalg.solve3x3(jnp.asarray(m), jnp.asarray(b), det_rel_eps)
    np.testing.assert_array_equal(ok.numpy(), _np(jok))
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=F64_TOL, atol=0)
    np.testing.assert_array_equal(linalg.det3x3(torch.as_tensor(m)).numpy(),
                                  _np(j_linalg.det3x3(jnp.asarray(m))))
    if case == "denormal" and det_rel_eps == 0.0:
        inv, ok1 = linalg.inverse3x3(torch.as_tensor(m))
        assert bool(ok1.all())
        err = np.abs(inv.numpy()[0] @ m[0] - np.eye(3))
        assert err.max() < 1e-14
    if case == "singular":
        assert not ok.any()


def test_adjugate3x3_matches_jax():
    m = np.random.default_rng(7).normal(size=(5, 3, 3))
    np.testing.assert_array_equal(
        linalg.adjugate3x3(torch.as_tensor(m)).numpy(),
        _np(j_linalg.adjugate3x3(jnp.asarray(m))))


# ---------------- select / robust (exact order statistics) -----------------


def _sample(prec, seed, n=301, ties=False):
    npt = DT[prec][0]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (4, n)).astype(npt)
    if ties:
        x = np.round(x).astype(npt)
    x[0, :5] = [0.0, -0.0, np.inf, -np.inf, 1e-40]  # 1e-40: f32 denormal
    mask = rng.random((4, n)) > 0.3
    mask[1, 1:] = False          # one valid lane
    mask[2, : n // 2 * 2] = True  # an even count
    mask[2, n // 2 * 2:] = False
    return x, mask


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("ties", [False, True])
def test_kth_smallest_masked_bitwise(prec, ties):
    x, mask = _sample(prec, 8, ties=ties)
    n = mask.sum(-1)
    for k in (np.zeros_like(n), n // 2, n - 1):
        got = select.kth_smallest_masked(torch.as_tensor(x),
                                         torch.as_tensor(mask),
                                         torch.as_tensor(k))
        want = j_select.kth_smallest_masked(jnp.asarray(x), jnp.asarray(mask),
                                            jnp.asarray(k, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), _np(want))
        sorted_ok = [np.sort(x[i][mask[i]])[k[i]] for i in range(4)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(sorted_ok))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("ties", [False, True])
def test_median_mad_sigma_bitwise(prec, ties):
    x, mask = _sample(prec, 9, ties=ties)
    x = np.where(np.isfinite(x), x, 0).astype(x.dtype)
    tx, tm = torch.as_tensor(x), torch.as_tensor(mask)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    for got, want in [
        (select.masked_median_radix(tx, tm), j_select.masked_median_radix(
            jx, jm)),
        (robust.masked_mad(tx, tm), j_robust.masked_mad(jx, jm)),
        (robust.masked_stddev(tx, tm), j_robust.masked_stddev(jx, jm)),
    ]:
        np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    empty = robust.masked_median(tx, torch.zeros_like(tm))
    assert not empty[1].any() and (empty[0] == 0).all()


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_calc_stddevs_bitwise(prec):
    npt = DT[prec][0]
    rng = np.random.default_rng(10)
    r = rng.normal(0.0, [2.0, 0.5], size=(3, 257, 2)).astype(npt)
    mask = rng.random((3, 257)) > 0.2
    mask[2] = False
    got = robust.calc_stddevs(torch.as_tensor(r), torch.as_tensor(mask))
    want = j_robust.calc_stddevs(jnp.asarray(r), jnp.asarray(mask))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


def test_median_reference_cases():
    # Reference src/stats.rs:69-90.
    for vals, want in [([-9., -6., -4., -1., -6., 5., 8., 5., 5., 4.], 1.5),
                       ([50.], 50.0), ([10., 11.], 10.5)]:
        x = torch.tensor(vals, dtype=torch.float64)
        med, ok = robust.masked_median(x, torch.ones_like(x, dtype=bool))
        assert (med.item(), bool(ok)) == (want, True)
