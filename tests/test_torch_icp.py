"""The port's ICP drivers (icp2d, icp3d_planar) against the JAX drivers and
the NumPy oracle, on the synthetic ground-truth cases of
tests/test_parity_oracle.py.

Tolerances:
- float64: <= 1e-9 against the JAX XLA path and the oracle, the JAX
  package's own parity tolerance (20 outer iterations of sums taken in
  another order).
- float32 against the JAX float32 XLA path: 1e-5 (f32 roundoff of
  few-hundred-point sums, compounded over the outer loop).
- The kernel-structured CPU path (Morton sort, db pack, center bound,
  survivor lists, the kernels' plain versions) against the unsorted plain
  path: 1e-5 in rot and t.  Sorting permutes the points, so every sum is
  taken in another order; the correspondences are exact either way.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT
from icp_rust_tpu.utils import oracle_np as oracle
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2 as TT
from icp_rust_tpu_torch.models import driver
from icp_rust_tpu_torch.models import icp2d as m
from icp_rust_tpu_torch.ops import nn

F64_TOL = 1e-9
F32_TOL = 1e-5
CPU = {"device": "cpu"}
# The JAX package's models/__init__ re-exports the icp2d function under
# the module's name.
j_icp = importlib.import_module("icp_rust_tpu.models.icp2d")


def _case2d(n=120):
    rng = np.random.default_rng(1)
    src = rng.uniform(-5, 5, (n, 2))
    t_true = oracle.Transform.from_twist([0.05, -0.02, 0.03])
    dst = t_true.apply(src) + rng.normal(0, 0.005, (n, 2))
    return src, dst


def _case3d(n=150):
    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 5, (n, 3))
    src[:, 2] = rng.uniform(0.2, 1.8, n)
    t_true = oracle.Transform.from_twist([0.04, -0.03, 0.02])
    dst = src.copy()
    dst[:, :2] = t_true.apply(src[:, :2])
    dst += rng.normal(0, 0.004, dst.shape)
    return src, dst


def _drivers(planar):
    if planar:
        return m.icp3d_planar, j_icp.icp3d_planar, oracle.Icp3d, _case3d
    return m.icp2d, j_icp.icp2d, oracle.Icp2d, _case2d


@pytest.mark.parametrize("planar", [False, True])
def test_float64_matches_jax_and_oracle(planar):
    port, jax_fn, orc, case = _drivers(planar)
    src, dst = case()
    ones = np.ones(len(src), bool)
    got = port(src, dst, ones, ones, TT.identity(dtype=torch.float64),
               REFERENCE_CONFIG, **CPU)
    want = jax_fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ones),
                  jnp.asarray(ones), JT.identity(dtype=jnp.float64), J_REF)
    t_o = orc(dst).estimate(src, oracle.Transform.identity(), 20)
    for ref_rot, ref_t in ((np.array(want.rot), np.array(want.t)),
                           (t_o.rot, t_o.t)):
        np.testing.assert_allclose(got.rot.numpy(), ref_rot, atol=F64_TOL)
        np.testing.assert_allclose(got.t.numpy(), ref_t, atol=F64_TOL)


@pytest.mark.parametrize("planar", [False, True])
def test_float64_stats_match_jax(planar):
    port, jax_fn, _, case = _drivers(planar)
    src, dst = case()
    mask = np.ones(len(src), bool)
    mask[::9] = False
    warm = TT.from_twist(torch.tensor([0.01, 0.0, 0.01], dtype=torch.float64))
    jwarm = JT.from_twist(jnp.asarray([0.01, 0.0, 0.01]))
    _, st = port(src, dst, mask, mask, warm, REFERENCE_CONFIG,
                 return_stats=True, **CPU)
    _, jst = jax_fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                    jnp.asarray(mask), jwarm, J_REF, return_stats=True)
    assert int(st.outer_iters) == int(jst.outer_iters)
    for f in ("huber_error", "mean_nn_dist", "inlier_fraction"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.array(getattr(jst, f)), rtol=F64_TOL,
                                   atol=F64_TOL)


@pytest.mark.parametrize("planar", [False, True])
def test_float32_matches_jax_xla_path(planar):
    port, jax_fn, _, case = _drivers(planar)
    src, dst = (a.astype(np.float32) for a in case())
    ones = np.ones(len(src), bool)
    cfg = ICPConfig(nn_backend="torch", align_backend="torch",
                    frame_backend="off", det_rel_eps=1e-9)
    jcfg = JaxConfig(nn_backend="xla", align_backend="xla",
                     frame_backend="off", det_rel_eps=1e-9)
    got = port(src, dst, ones, ones, TT.identity(), cfg, **CPU)
    want = jax_fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ones),
                  jnp.asarray(ones), JT.identity(dtype=jnp.float32), jcfg)
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=F32_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t), atol=F32_TOL)


def _frames3d(stride=16):
    from icp_rust_tpu_torch.utils import io

    frames, _ = io.synthesize_frames3d(2, seed=0)
    pts, mask = io.pad_points([f[::stride] for f in frames])
    return pts, mask


def test_kernel_structured_cpu_path_tracks_plain_path():
    pts, mask = _frames3d()
    kern = ICPConfig(nn_dst_tile=256, det_rel_eps=1e-9)  # "auto": kernels
    plain = kern.with_(nn_backend="torch", align_backend="torch")
    assert nn.route(torch.as_tensor(pts[0], dtype=torch.float32),
                    torch.as_tensor(pts[1]), 2, kern).sort == "morton"
    assert nn.route(torch.as_tensor(pts[0], dtype=torch.float32),
                    torch.as_tensor(pts[1]), 2, plain).sort is None
    t0 = TT.identity()
    got, st = m.icp3d_planar(pts[0], pts[1], mask[0], mask[1], t0, kern,
                             return_stats=True, **CPU)
    want, wst = m.icp3d_planar(pts[0], pts[1], mask[0], mask[1], t0, plain,
                               return_stats=True, **CPU)
    np.testing.assert_allclose(got.rot.numpy(), want.rot.numpy(),
                               atol=F32_TOL)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=F32_TOL)
    assert 1 < int(st.outer_iters) < kern.outer_iters
    np.testing.assert_allclose(float(st.mean_nn_dist),
                               float(wst.mean_nn_dist), rtol=1e-4)


def test_stats_on_the_sorted_route_use_the_sorted_mask():
    """Masked points in the middle of src: the Morton sort moves them last,
    and the stats must follow the permuted mask."""
    pts, mask = _frames3d()
    mask = mask.copy()
    mask[0, ::3] = False
    kern = ICPConfig(nn_dst_tile=256, det_rel_eps=1e-9)
    plain = kern.with_(nn_backend="torch", align_backend="torch")
    t0 = TT.identity()
    _, st = m.icp3d_planar(pts[0], pts[1], mask[0], mask[1], t0, kern,
                           return_stats=True, **CPU)
    _, wst = m.icp3d_planar(pts[0], pts[1], mask[0], mask[1], t0, plain,
                            return_stats=True, **CPU)
    for f in ("huber_error", "mean_nn_dist", "inlier_fraction"):
        np.testing.assert_allclose(float(getattr(st, f)),
                                   float(getattr(wst, f)), rtol=1e-4)


def test_presorted_src_is_bitwise_identical():
    pts, mask = _frames3d(stride=24)
    cfg = ICPConfig(nn_dst_tile=256)
    src = torch.as_tensor(pts[0], dtype=torch.float32)
    smask = torch.as_tensor(mask[0])
    s2, m2, pre = driver.presort_src(src, smask, torch.as_tensor(pts[1]),
                                     cfg)
    assert pre
    a = m.icp3d_planar(src, pts[1], smask, mask[1], TT.identity(), cfg, **CPU)
    b = m.icp3d_planar(s2, pts[1], m2, mask[1], TT.identity(), cfg,
                       src_presorted=True, **CPU)
    assert torch.equal(a.rot, b.rot) and torch.equal(a.t, b.t)


def test_spatial_sort_prefix_mask():
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-3, 3, (500, 3)))
    mask = torch.as_tensor(rng.random(500) > 0.3)
    srt, msk, (extra,) = driver.spatial_sort(pts, mask, extras=(pts[:, 0],))
    order = nn.spatial_order(pts, mask, "morton").to(torch.int64)
    assert torch.equal(msk, mask[order])
    assert torch.equal(extra, pts[order, 0]) and torch.equal(srt, pts[order])


def test_fixed_point_exit_is_exact():
    """Exiting at dT == identity equals running every outer iteration."""
    src, dst = _case2d()
    ones = np.ones(len(src), bool)
    cfg = REFERENCE_CONFIG
    a, st = m.icp2d(src, dst, ones, ones, TT.identity(dtype=torch.float64),
                    cfg, return_stats=True, **CPU)
    assert int(st.outer_iters) < cfg.outer_iters
    b = m.icp2d(src, dst, ones, ones, TT.identity(dtype=torch.float64),
                cfg.with_(outer_iters=3 * cfg.outer_iters), **CPU)
    assert torch.equal(a.rot, b.rot) and torch.equal(a.t, b.t)
    dt = TT.identity(dtype=torch.float64)
    assert bool(driver.is_identity(dt))
    assert not bool(driver.is_identity(TT(dt.rot, dt.t + 1e-300)))


def test_frame_kernel_gate_and_route():
    src, dst = (a.astype(np.float32) for a in _case2d())
    ones = np.ones(len(src), bool)
    s, d = torch.as_tensor(src), torch.as_tensor(dst)
    cfg = ICPConfig(det_rel_eps=1e-9)
    assert m._use_frame_kernel(s, d, cfg, return_stats=False)
    assert not m._use_frame_kernel(s, d, cfg, return_stats=True)
    assert not m._use_frame_kernel(s.double(), d.double(), cfg, False)
    assert not m._use_frame_kernel(s, d, cfg.with_(frame_backend="off"),
                                   False)
    assert not m._use_frame_kernel(
        s, d, cfg.with_(align_backend="torch"), False)
    assert not m._use_frame_kernel(s, d, cfg.with_(frame_kernel_max=100),
                                   False)
    frame = m.icp2d(src, dst, ones, ones, TT.identity(), cfg, **CPU)
    unfused = m.icp2d(src, dst, ones, ones, TT.identity(),
                      cfg.with_(frame_backend="off", nn_backend="torch",
                                align_backend="torch"), **CPU)
    assert torch.equal(frame.rot, unfused.rot)
    assert torch.equal(frame.t, unfused.t)


@pytest.mark.parametrize("planar", [False, True])
def test_float64_point_scale_matches_jax(planar):
    port, jax_fn, _, case = _drivers(planar)
    src, dst = (a * 3000.0 for a in case())
    ones = np.ones(len(src), bool)
    cfg = REFERENCE_CONFIG.with_(point_scale=3000.0)
    got = port(src, dst, ones, ones, TT.identity(dtype=torch.float64), cfg,
               **CPU)
    want = jax_fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ones),
                  jnp.asarray(ones), JT.identity(dtype=jnp.float64),
                  J_REF.with_(point_scale=3000.0))
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=F64_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=F64_TOL * 3000.0)


def test_icp2d_over_two_batch_axes_matches_jax():
    """float32 src/dst (2, 2, 256, 2), all valid, an identity warm start
    of batch (2, 2): the port flattens the batch axes into its one pair
    axis and restores them on the transforms and the stats."""
    rng = np.random.default_rng(9)
    src = rng.uniform(-5, 5, (2, 2, 256, 2))
    tw = rng.normal(0, 1, (2, 2, 3)) * [0.05, 0.05, 0.03]
    dst = np.stack([[oracle.Transform.from_twist(tw[i, j]).apply(src[i, j])
                     for j in range(2)] for i in range(2)])
    dst = (dst + rng.normal(0, 0.005, dst.shape)).astype(np.float32)
    src = src.astype(np.float32)
    mask = np.ones((2, 2, 256), bool)
    t, st = m.icp2d(src, dst, mask, mask, TT.identity((2, 2)), ICPConfig(),
                    return_stats=True, **CPU)
    jt, jst = j_icp.icp2d(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(mask), jnp.asarray(mask),
                          JT.identity((2, 2)), JaxConfig(),
                          return_stats=True)
    assert t.rot.shape == (2, 2, 2, 2) and t.t.shape == (2, 2, 2)
    assert st.huber_error.shape == (2, 2)
    np.testing.assert_allclose(t.rot.numpy(), np.array(jt.rot),
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(t.t.numpy(), np.array(jt.t), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(st.inlier_fraction.numpy(),
                               np.array(jst.inlier_fraction), atol=1e-6)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n,m", [(700, 768), (1536, 1536)])
def test_frame_cluster_sweep_is_the_first_minimum(n, m, cluster):
    """icp2d_frame's sweep on a cluster (``align2d_cuda.frame_sweep``):
    query slices over blocks, dst segments over a block's threads, merged
    lexicographically.  Bitwise equal to a brute-force first-minimum
    sweep, the one-block kernel's, with every dst point twice (the copies
    in other segments, ties straddling segment boundaries), queries on dst
    points and masked dst rows; a fully masked dst gives (+inf, 0)."""
    from icp_rust_tpu_torch.ops import align2d_cuda as ac
    from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL

    rng = np.random.default_rng(n + cluster)
    base = rng.uniform(-3, 3, (m // 2, 2)).astype(np.float32)
    dst = torch.as_tensor(np.concatenate([base, base]))
    query = torch.as_tensor(rng.uniform(-3, 3, (n, 2)).astype(np.float32))
    query[::3] = dst[torch.as_tensor(rng.integers(0, m, len(query[::3])))]
    dst[torch.as_tensor(rng.random(m) < 0.1)] = _SENTINEL
    ex = query[:, None, 0] - dst[None, :, 0]
    ey = query[:, None, 1] - dst[None, :, 1]
    want_d, want_i = torch.min(ex * ex + ey * ey, dim=1)
    got_d, got_i = ac.frame_sweep(query, dst, cluster)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    segs = {seg for _, s_n, seg, _ in ac.frame_sweep_plan(n, m, cluster)
            if s_n}
    assert max(segs) > 1 or cluster < 8
    none = torch.full_like(dst, _SENTINEL)
    got_d, got_i = ac.frame_sweep(query, none, cluster)
    assert bool(torch.isinf(got_d).all()) and not bool(got_i.any())


def _chip_smoke():
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.fixture(scope="module")
def near_tie_pair():
    """Pair 5 of chip_smoke.py's 64 consecutive pairs of 1,536 synthetic
    points (``big_frame_pairs``; its first six pairs are those of the 64),
    where the frame kernels on the card land 4.8e-5 from their plain
    version (ROADMAP.md section 3), and the port's plain frame loop on it
    in float32 and float64: (src, dst, mask, config, {dtype: (rot and t as
    6 floats, outer iterations)})."""
    cs = _chip_smoke()
    sp, dp, sm, _ = cs.big_frame_pairs("cpu", big=6)
    src, dst, mask = sp[5].numpy(), dp[5].numpy(), sm[5].numpy()
    cfg = cs._config()
    runs = {}
    for dt in (torch.float32, torch.float64):
        rot, t, it = m.icp2d_frame_plain(
            torch.as_tensor(src, dtype=dt), torch.as_tensor(dst, dtype=dt),
            torch.as_tensor(mask), torch.as_tensor(mask),
            TT.identity(dtype=dt), cfg)
        runs[dt] = (np.concatenate([rot.numpy().reshape(4), t.numpy()]),
                    int(it))
    return src, dst, mask, cfg, runs


def test_plain_frame_loop_tracks_float64_and_jax_on_the_near_tie_pair(
        near_tie_pair):
    """The reference side of kernel 10's 64 x 1,536 case: the port's
    float32 plain frame loop on pair 5 within FRAME_TOL of its float64
    run and of the JAX package's float32 XLA icp2d, with equal outer
    iteration counts."""
    src, dst, mask, cfg, runs = near_tie_pair
    got, outer = runs[torch.float32]
    want, outer64 = runs[torch.float64]
    tol = _chip_smoke().FRAME_TOL
    assert np.abs(got - want).max() <= tol and outer == outer64
    jcfg = JaxConfig(nn_backend="xla", align_backend="xla",
                     frame_backend="off", det_rel_eps=cfg.det_rel_eps)
    jt, jst = j_icp.icp2d(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(mask), jnp.asarray(mask),
                          JT.identity(dtype=jnp.float32), jcfg,
                          return_stats=True)
    jax_t = np.concatenate([np.array(jt.rot).reshape(4), np.array(jt.t)])
    assert np.abs(got - jax_t).max() <= tol
    assert int(jst.outer_iters) == outer


@pytest.fixture(scope="module")
def jax_frame_result(near_tie_pair):
    """The JAX package's own whole-frame kernel (_icp2d_frame_kernel, in
    interpret mode) on the near-tie pair: (rot and t as 6 floats, outer
    iterations)."""
    from icp_rust_tpu.ops import align2d_pallas

    src, dst, mask, cfg, _ = near_tie_pair
    t0 = JT.identity(dtype=jnp.float32)
    rot, t, outer = align2d_pallas.icp2d_frame_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(mask), t0.rot, t0.t, huber_k=cfg.huber_k,
        det_rel_eps=cfg.det_rel_eps, tol_d2=cfg.inner_delta_sq_tol,
        inner_max_iter=cfg.inner_max_iter, outer_iters=cfg.outer_iters,
        point_scale=1.0, interpret=True)
    return (np.concatenate([np.array(rot).reshape(4), np.array(t)]),
            int(outer))


def test_jax_frame_kernel_takes_the_other_side_of_the_near_tie(
        near_tie_pair, jax_frame_result):
    """The JAX package's own whole-frame kernel on the same pair lands
    farther than FRAME_TOL from the float64 plain loop, as the port's
    frame kernels do on the card: in float32, with its rounding of the
    transform, one point's nearest neighbour at the sixth outer iteration
    is the other side of a near tie (chip_smoke.frame_trace), and the
    loop ends at another fixed point.  Not a fault of the port (ROADMAP.md
    section 3)."""
    _, _, _, _, runs = near_tie_pair
    jax_t, _ = jax_frame_result
    assert np.abs(jax_t - runs[torch.float64][0]).max() > \
        _chip_smoke().FRAME_TOL


def test_frame_gate_on_the_near_tie_pair(near_tie_pair, jax_frame_result,
                                         capsys):
    """chip_smoke.frame_gate, kernels 10 and 3's gate: a pair outside
    FRAME_TOL passes only with the plain version's outer iteration count,
    a result that is an exact fixed point of the plain outer step, and a
    result within FRAME_TOL of the plain loop with one float32
    nearest-neighbour near tie taken the other way.  It accepts the plain
    loop's own result and the JAX frame kernel's (row 467's tie at the
    seventh outer iteration, as chip_smoke.frame_trace found on the card),
    and refuses a result moved by 1e-4 m or 1e-3 m, or with another outer
    count."""
    cs = _chip_smoke()
    src, dst, mask, cfg, runs = near_tie_pair
    got, outer = runs[torch.float32]
    s, d, k = (torch.as_tensor(x)[None] for x in (src, dst, mask))
    args = (s, d, k, k, TT.identity((1,)), cfg)
    plain = (torch.as_tensor(got[:4]).reshape(1, 2, 2),
             torch.as_tensor(got[4:])[None], torch.tensor([outer]))

    def gate(six, its=outer):
        rot = torch.as_tensor(six[:4], dtype=torch.float32).reshape(1, 2, 2)
        t = torch.as_tensor(six[4:], dtype=torch.float32)[None]
        return cs.frame_gate(args, rot, t, torch.tensor([its]), plain,
                             "near-tie pair")

    assert gate(got) == (0.0, [])
    for move in (1e-4, 1e-3):
        moved = got + np.array([0, 0, 0, 0, move, 0], np.float32)
        err, failed = gate(moved)
        assert err > cs.FRAME_TOL and failed == [0]
    assert gate(got, outer + 1)[1] == [0]
    jax_t, jax_outer = jax_frame_result
    capsys.readouterr()
    err, failed = gate(jax_t, jax_outer)
    said = capsys.readouterr().out
    with capsys.disabled():
        print(f"\n# the JAX frame kernel's result on the near-tie pair: "
              f"{err:.3e} from the plain loop, {jax_outer} outer iterations "
              f"(plain {outer}); the gate "
              f"{'refuses' if failed else 'accepts'} it: {said.strip()}")
    assert err > cs.FRAME_TOL and failed == []
    assert "row 467's nearest neighbour at outer iteration 7" in said
