"""The port's scan-to-submap path (``models/submap``, ``ops/voxel``,
``ops/voxel_hash``, ``utils/metrics``, ``convert.voxel_hash_map_from_numpy``)
against the JAX package's, on the CPU.

Tolerances:
- ``voxel_downsample``, float64: centroids within 1e-12 in the same
  cell-id order, mask and ``n_cells`` exact.
- ``voxel_hash``: the key table bitwise equal slot by slot after one and
  after two inserts; ``cnt`` and ``dropped`` exact; ``psum`` within 1e-12
  in float64 (the port adds each slot's points in the JAX package's CPU
  order, so it is in fact bitwise here too).
- ``run_submap_odometry`` on tests/test_submap.py's 2D wall world (8
  frames of 400 points, voxel 0.03 m, capacity 4096): ``REFERENCE_CONFIG``
  (float64) within 1e-6 m of the JAX path, fused and re-voxelize; float32
  within F32_PATH_TOL_M.  Why that much in float32: each frame's ICP stops
  at a fixed point of its outer loop, and where float32 roundoff (sums in
  another order, FMA contraction in XLA's CPU backend) moves a stop
  decision by one outer iteration the frame moves by up to the loop's
  step tolerance, which the map then carries on.
- The port against itself: ``view_rows`` covering the occupancy bitwise
  equal to the full view; segmented within 1e-9 (bitwise in fact) of
  unsegmented; kill-and-resume bitwise.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as JAX_REFERENCE
from icp_rust_tpu.models import submap as j_submap
from icp_rust_tpu.ops import voxel as j_voxel
from icp_rust_tpu.ops import voxel_hash as j_vh
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.models import submap
from icp_rust_tpu_torch.ops import voxel, voxel_hash
from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer
from icp_rust_tpu_torch.utils.metrics import MetricsLogger

F32_PATH_TOL_M = 5e-3
KW = dict(voxel_size=0.03, capacity=4096)
KW_RESUME = dict(voxel_size=20.0, capacity=1 << 12)


def _sequence(f=9, n=256, seed=0):
    """tests/test_resume.py's mm-scale 2D sequence."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3000, 3000, (n, 2))
    frames = np.zeros((f, n, 2))
    for k in range(f):
        th = 0.01 * k
        c, s = np.cos(th), np.sin(th)
        frames[k] = base @ np.array([[c, -s], [s, c]]).T + [10.0 * k, 0]
        frames[k] += rng.normal(0, 0.5, (n, 2))
    return frames, np.ones((f, n), bool)


@pytest.fixture(scope="module")
def walls():
    """tests/test_submap.py's wall world (chip_smoke.walls_sequence): frames,
    masks, ground-truth sensor positions."""
    import chip_smoke

    pts, gt = chip_smoke.walls_sequence()
    return pts, np.ones(pts.shape[:2], bool), gt


@pytest.fixture(scope="module")
def jax_paths(walls):
    """The JAX package's runs, shared by the tests below."""
    pts, masks, _ = walls
    f32 = JaxConfig(compute_dtype=jnp.float32, det_rel_eps=1e-9)
    return {"f64": j_submap.run_submap_odometry(pts, masks, JAX_REFERENCE,
                                                **KW)[1],
            "f32": j_submap.run_submap_odometry(pts, masks, f32, **KW)[1],
            "revoxel": j_submap.run_submap_odometry(
                pts, masks, JAX_REFERENCE, fused=False, **KW)[1]}


@pytest.fixture(scope="module")
def port_f64(walls):
    pts, masks, _ = walls
    return submap.run_submap_odometry(pts, masks, REFERENCE_CONFIG,
                                      device="cpu", **KW)


# ----------------------------------------------------------------- voxel


@pytest.mark.parametrize("case", ["small", "dense", "overflow"])
def test_voxel_downsample_matches_jax_f64(case):
    rng = np.random.default_rng(0)
    if case == "small":  # tests/test_submap.py's hand-checked case
        pts = np.array([[0.01, 0.01], [0.03, 0.02], [0.12, 0.01],
                        [0.55, 0.58], [99.0, 99.0]])
        mask = np.array([True, True, True, True, False])
        vs, cap = 0.1, 8
    else:  # tests/test_submap.py:35, with a partial mask
        pts = rng.uniform(0, 1, (5000, 3))
        mask = rng.random(5000) > 0.1
        vs, cap = (0.2, 256) if case == "dense" else (0.01, 64)
    want = j_voxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), vs,
                                    cap)
    got = voxel.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask),
                                 vs, cap)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.n_cells) == int(want.n_cells)
    if case == "overflow":
        assert int(got.n_cells) > cap and int(got.mask.sum()) == cap
    if case == "small":
        np.testing.assert_allclose(got.points[:3].numpy(),
                                   [[0.02, 0.015], [0.12, 0.01],
                                    [0.55, 0.58]], atol=1e-12)


# ------------------------------------------------------------ voxel hash


def _hash_case(case):
    """(capacity, dim, origin, [(points, mask, kwargs) per insert], voxel):
    a 256-slot table that forces probe chains; more rows than compact_to
    with a nonzero salt (both compaction stages); an out-of-box point."""
    rng = np.random.default_rng(1)
    if case == "probe-chains":
        a = rng.uniform(-2, 2, (500, 3))
        b = rng.uniform(-2.5, 2.5, (300, 3))
        return 256, 3, a.min(0), [(a, np.ones(500, bool), {}),
                                  (b, np.ones(300, bool), {"salt": 3})], 0.5
    if case == "compaction":
        a = rng.uniform(-6, 6, (12000, 2))
        b = rng.uniform(-5, 5, (9000, 2))
        org = j_vh.origin_for(jnp.asarray(a), jnp.ones(12000, bool), 0.02)
        kw = {"compact_to": 3000}
        return 8192, 2, np.asarray(org), [
            (a, rng.random(12000) > 0.1, dict(kw, salt=5)),
            (b, np.ones(9000, bool), dict(kw, salt=6))], 0.02
    pts = np.array([[0.1, 0.1, 0.1], [1e5, 0.0, 0.0], [-1e12, 3e11, 0.0]])
    return 64, 3, np.zeros(3), [(pts, np.ones(3, bool), {}),
                                (pts[:1] + 0.2, np.ones(1, bool), {})], 0.5


def _assert_same_table(got, got_d, want, want_d):
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))
    np.testing.assert_array_equal(got.cnt.numpy(), np.asarray(want.cnt))
    np.testing.assert_allclose(got.psum.numpy(), np.asarray(want.psum),
                               rtol=0, atol=1e-12)
    assert int(got_d) == int(want_d)


@pytest.mark.parametrize("case", ["probe-chains", "compaction",
                                  "out-of-box"])
def test_voxel_hash_insert_matches_jax_slot_by_slot(case):
    cap, dim, org, inserts, vs = _hash_case(case)
    want = j_vh.make_map(cap, dim, jnp.asarray(org), jnp.float64)
    got = voxel_hash.make_map(cap, dim, torch.as_tensor(np.array(org)),
                                torch.float64)
    for pts, mask, kw in inserts:
        want, want_d = j_vh.insert(want, jnp.asarray(pts), jnp.asarray(mask),
                                   vs, **kw)
        got, got_d = voxel_hash.insert(got, torch.as_tensor(pts),
                                       torch.as_tensor(mask), vs, **kw)
        _assert_same_table(got, got_d, want, want_d)
    assert int((got.key != np.iinfo(np.int32).max).sum()) > 0
    if case == "out-of-box":  # dropped, never aliased into a cell
        assert int(got.cnt.gt(0).sum()) == 1 and int(got_d) == 0
    c_got, m_got = voxel_hash.centroids(got)
    c_want, m_want = j_vh.centroids(want)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))


def test_voxel_hash_helpers_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (700, 3))
    mask = rng.random(700) > 0.3
    np.testing.assert_allclose(
        voxel_hash.origin_for(torch.as_tensor(pts), torch.as_tensor(mask),
                              0.25).numpy(),
        np.asarray(j_vh.origin_for(jnp.asarray(pts), jnp.asarray(mask),
                                   0.25)), rtol=0, atol=1e-12)
    cid, ok = voxel_hash._cell_ids(torch.as_tensor(pts),
                                   torch.as_tensor(mask),
                                   torch.full((3,), -1.0,
                                              dtype=torch.float64), 0.25)
    j_cid, j_ok = j_vh._cell_ids(jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.full((3,), -1.0), 0.25)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(j_cid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    with pytest.raises(ValueError, match="power of two"):
        voxel_hash.make_map(100, 3, torch.zeros(3))


def test_voxel_hash_map_from_numpy_carries_the_state():
    """A JAX map carried across, then one port insert, gives the table of
    one JAX insert."""
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-2, 2, (600, 3)), rng.uniform(-2, 2, (400, 3))
    m = j_vh.make_map(1024, 3, jnp.asarray(a.min(0)), jnp.float64)
    m, _ = j_vh.insert(m, jnp.asarray(a), jnp.ones(600, bool), 0.3)
    carried = convert.voxel_hash_map_from_numpy(
        np.asarray(m.key), np.asarray(m.psum), np.asarray(m.cnt),
        np.asarray(m.origin))
    assert carried.psum.dtype == torch.float64
    assert carried.key.dtype == torch.int32
    want, want_d = j_vh.insert(m, jnp.asarray(b), jnp.ones(400, bool), 0.3,
                               salt=2)
    got, got_d = voxel_hash.insert(carried, torch.as_tensor(b),
                                   torch.ones(400, dtype=torch.bool), 0.3,
                                   salt=2)
    _assert_same_table(got, got_d, want, want_d)


# ------------------------------------------------------------ the runner


def test_run_submap_odometry_matches_jax_f64(walls, jax_paths, port_f64):
    _, path = port_f64
    np.testing.assert_allclose(path, jax_paths["f64"], rtol=0, atol=1e-6)
    pts, _, gt = walls
    assert np.linalg.norm(path - gt, axis=1).max() < 0.02
    assert path.dtype == np.float64 and path.shape == (len(pts) - 1, 2)


def test_run_submap_odometry_matches_jax_f32(walls, jax_paths):
    pts, masks, _ = walls
    tf, path = submap.run_submap_odometry(
        pts, masks, ICPConfig(det_rel_eps=1e-9), device="cpu", **KW)
    assert tf.t.dtype == torch.float32 and tf.rot.shape == (len(pts) - 1,
                                                            2, 2)
    np.testing.assert_allclose(path, jax_paths["f32"], rtol=0,
                               atol=F32_PATH_TOL_M)


def test_revoxelize_path_matches_jax_f64(walls, jax_paths):
    pts, masks, _ = walls
    _, path = submap.run_submap_odometry(pts, masks, REFERENCE_CONFIG,
                                         fused=False, device="cpu", **KW)
    np.testing.assert_allclose(path, jax_paths["revoxel"], rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="fused"):
        submap.run_submap_odometry(pts, masks, REFERENCE_CONFIG,
                                   fused=False, with_metrics=True,
                                   device="cpu", **KW)


def test_view_rows_exact_while_occupancy_fits(walls, port_f64):
    pts, masks, _ = walls
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        _, path = submap.run_submap_odometry(
            pts, masks, REFERENCE_CONFIG, view_rows=2048, device="cpu", **KW)
    assert not any("hid" in str(w.message) for w in wlist), wlist
    np.testing.assert_array_equal(path, port_f64[1])
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        submap.run_submap_odometry(pts, masks, REFERENCE_CONFIG,
                                   view_rows=128, device="cpu", **KW)
    assert any("hid" in str(w.message) for w in wlist)


def test_segmented_matches_unsegmented_and_logs_metrics(tmp_path):
    frames, masks = _sequence(f=9)
    want = j_submap.run_submap_odometry(frames, masks, JAX_REFERENCE,
                                        **KW_RESUME)[1]
    _, path_one = submap.run_submap_odometry(frames, masks, REFERENCE_CONFIG,
                                             device="cpu", **KW_RESUME)
    np.testing.assert_allclose(path_one, want, rtol=0, atol=1e-6)
    mpath = str(tmp_path / "m.jsonl")
    log = MetricsLogger(mpath)  # metrics forces the segmented path
    _, path_seg = submap.run_submap_odometry(
        frames, masks, REFERENCE_CONFIG, metrics=log, device="cpu",
        **KW_RESUME)
    log.close()
    np.testing.assert_allclose(path_seg, path_one, rtol=0, atol=1e-9)
    rows = [json.loads(line) for line in open(mpath)]
    assert [r["frame"] for r in rows] == list(range(1, 9))
    for r in rows:
        assert np.isfinite(r["huber_error"]) and r["seconds"] > 0
        assert 0.0 <= r["inlier_fraction"] <= 1.0
        assert r["extra"]["outer_iters"] >= 1
    assert log.summary()["frames"] == 8


def test_kill_and_resume_bitwise(tmp_path):
    """The restored carry (transform, relative motion, voxel hash map,
    view order) reproduces the rest of the trajectory bitwise against the
    uninterrupted run with the same cadence."""
    frames, masks = _sequence(f=9)
    kw = dict(config=REFERENCE_CONFIG, device="cpu", **KW_RESUME)
    _, path_ref = submap.run_submap_odometry(
        frames, masks,
        checkpoint=SequenceCheckpointer(str(tmp_path / "ref.npz"), 2), **kw)
    ck = str(tmp_path / "ck.npz")
    submap.run_submap_odometry(frames[:6], masks[:6],
                               checkpoint=SequenceCheckpointer(ck, 2), **kw)
    assert os.path.exists(ck)
    _, path_res = submap.run_submap_odometry(
        frames, masks, checkpoint=SequenceCheckpointer(ck, 2), resume=True,
        **kw)
    np.testing.assert_array_equal(path_res, path_ref)


def test_with_metrics_stats_finite_and_in_range():
    frames, masks = _sequence(f=5)
    _, path, stats = submap.run_submap_odometry(
        frames, masks, REFERENCE_CONFIG, with_metrics=True, device="cpu",
        **KW_RESUME)
    assert stats.outer_iters.shape == (4,) and path.shape == (4, 2)
    assert bool(torch.all(stats.outer_iters >= 1))
    assert bool(torch.all(torch.isfinite(stats.huber_error)))
    assert bool(torch.all(stats.mean_nn_dist >= 0))
    inl = stats.inlier_fraction
    assert bool(torch.all((inl >= 0) & (inl <= 1)))


def test_constant_velocity_warm_start_runs(walls):
    """warm_start="cv" (opt-in) on the short sequence: finite and close to
    the default's path (it diverges only on long sequences)."""
    pts, masks, _ = walls
    _, path = submap.run_submap_odometry(pts, masks, REFERENCE_CONFIG,
                                         warm_start="cv", device="cpu", **KW)
    assert np.all(np.isfinite(path)) and path.shape == (len(pts) - 1, 2)
