"""The port's full-sequence SLAM (``models/slam.py``) and checkpoints
(``utils/checkpoint.py``) against the JAX package's, on the CPU.

- ``run_slam2d`` in float64 on the loop sequence of tests/test_slam.py
  (12 scans of 200 points): equal closures, paths within 1e-6 (the two
  differ only in the order of float64 sums, ~1e-12 here).
- ``run_slam3d`` at the size of tests/test_slam3d.py's kill-and-resume
  test (10 poses of the room scene, 1024 points): in float64 equal
  closures and paths within 1e-8; in float32 equal closures and paths
  within F32_PATH_TOL_M.  Why that much in float32: each pair's ICP stops
  at a fixed point of its outer loop, and where float32 roundoff moves a
  stop decision by one outer iteration the pair's result moves by up to
  the loop's step tolerance (~1e-3 m).  The JAX package itself does that
  here: its jitted and its eager point-to-plane chains over these frames
  end one outer iteration and millimetres apart on pair 8.  With the
  same warm start the port's pairs agree with the JAX package's eager ones
  to float32 roundoff (tests/test_torch_p2l.py).
- The port's own kill-and-resume and phase checkpoints reproduce its
  uninterrupted result bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as JAX_REFERENCE
from icp_rust_tpu.models import slam as j_slam
from icp_rust_tpu.utils import checkpoint as j_checkpoint
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.models import slam
from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer, \
    load_state, save_state

F32_PATH_TOL_M = 5e-3
KW2 = dict(loop_radius=0.8, min_gap=4)
KW3 = dict(loop_radius=0.8, min_gap=4, max_loop_candidates=4,
           normals_voxel_size=0.4)


def _loop_sequence(n_frames, n_pts, seed):
    """tests/test_slam.py's scans from a pose loop that returns near its
    start (wall segments, 4 mm noise)."""
    rng = np.random.default_rng(seed)
    walls = []
    for _ in range(10):
        a = rng.uniform(-10, 10, 2)
        ang = rng.uniform(0, np.pi)
        walls.append((a, np.array([np.cos(ang), np.sin(ang)]),
                      rng.uniform(4, 9)))
    ang = np.linspace(0, 2 * np.pi, n_frames, endpoint=True)
    poses = np.column_stack([
        1.5 * np.sin(ang), 1.5 * (1 - np.cos(ang)), 0.3 * np.sin(ang)])
    frames = []
    for x, y, th in poses:
        widx = rng.integers(0, len(walls), n_pts)
        ts = rng.uniform(0, 1, n_pts)
        pw = np.stack([walls[i][0] + walls[i][1] * t * walls[i][2]
                       for i, t in zip(widx, ts)])
        c, s = np.cos(th), np.sin(th)
        local = (pw - [x, y]) @ np.array([[c, -s], [s, c]])
        local += rng.normal(0, 0.004, local.shape)
        frames.append(local)
    return frames


@pytest.fixture(scope="module")
def scans2d():
    return _loop_sequence(12, 200, seed=3)


@pytest.fixture(scope="module")
def frames3d():
    import chip_smoke

    frames, _ = chip_smoke.room_sequence(n_poses=10, n_points=1024,
                                         scene_n=2000, seed=1)
    return frames


@pytest.fixture(scope="module")
def port3d_f32(frames3d):
    """The port's uninterrupted float32 run_slam3d on the CPU."""
    return slam.run_slam3d(frames3d, ICPConfig(), device="cpu", **KW3)


def _assert_same_run(got, want, tol):
    assert got.n_loop_closures == want.n_loop_closures >= 1
    for a, b in ((got.optimized_path, want.optimized_path),
                 (got.odometry_path, want.odometry_path)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


def test_run_slam2d_float64_matches_jax(scans2d):
    want = j_slam.run_slam2d(scans2d, JAX_REFERENCE, **KW2)
    got = slam.run_slam2d(scans2d, REFERENCE_CONFIG, device="cpu", **KW2)
    _assert_same_run(got, want, 1e-6)
    np.testing.assert_allclose([got.error_before, got.error_after],
                               [want.error_before, want.error_after],
                               rtol=1e-6)
    assert got.poses.t.dtype == torch.float64
    np.testing.assert_allclose(got.poses.rot.numpy(),
                               np.asarray(want.poses.rot), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_slam3d_matches_jax(frames3d, dtype, request):
    if dtype == "float64":
        want = j_slam.run_slam3d(frames3d, JAX_REFERENCE, **KW3)
        got = slam.run_slam3d(frames3d, REFERENCE_CONFIG, device="cpu",
                              **KW3)
        tol = 1e-8
    else:
        want = j_slam.run_slam3d(frames3d,
                                 JaxConfig(compute_dtype=jnp.float32), **KW3)
        got, tol = request.getfixturevalue("port3d_f32"), F32_PATH_TOL_M
    _assert_same_run(got, want, tol)
    assert got.error_after < got.error_before
    assert got.poses.t.dtype == torch.float64  # the graph runs in float64


def test_run_slam2d_checkpoint_resume_bitwise(scans2d, tmp_path):
    """A completed phase-2 record lets a rerun skip the batched odometry
    and verification solves and reproduce the result bitwise; the JAX
    package reads the port's record."""
    ck = str(tmp_path / "slam2d.npz")
    ref = slam.run_slam2d(scans2d, REFERENCE_CONFIG, device="cpu",
                          checkpoint=SequenceCheckpointer(ck, 4), **KW2)
    state = j_checkpoint.load_state(ck)
    assert int(state["slam_phase"]) == 2
    assert state["pose_t"].shape == (len(scans2d), 2)
    res = slam.run_slam2d(scans2d, REFERENCE_CONFIG, device="cpu",
                          checkpoint=SequenceCheckpointer(ck, 4),
                          resume=True, **KW2)
    np.testing.assert_array_equal(res.optimized_path, ref.optimized_path)
    assert res.n_loop_closures == ref.n_loop_closures


def test_run_slam3d_kill_and_resume_bitwise(frames3d, port3d_f32,
                                           tmp_path):
    """A crash after 5 frames leaves a partial chain record; resuming the
    whole sequence reproduces the uninterrupted float32 run bitwise, and
    so does resuming from the completed phase-2 record."""
    cfg, ref = ICPConfig(), port3d_f32
    ck = str(tmp_path / "slam3d.npz")
    slam.run_slam3d(frames3d[:6], cfg, device="cpu",
                    checkpoint=SequenceCheckpointer(ck, 2), **KW3)
    assert load_state(ck)["rel_rot"].shape[0] == 5
    res = slam.run_slam3d(frames3d, cfg, device="cpu",
                          checkpoint=SequenceCheckpointer(ck, 2),
                          resume=True, **KW3)
    np.testing.assert_array_equal(res.optimized_path, ref.optimized_path)
    assert res.n_loop_closures == ref.n_loop_closures
    state = load_state(ck)
    assert int(state["slam_phase"]) == 2
    assert state["pose_t"].shape == (len(frames3d), 3)
    assert state["rel_rot"].shape[0] == len(frames3d) - 1
    assert "edge_i" in state and int(state["frame_cursor"]) == 9
    res2 = slam.run_slam3d(frames3d, cfg, device="cpu",
                           checkpoint=SequenceCheckpointer(ck, 2),
                           resume=True, **KW3)
    np.testing.assert_array_equal(res2.optimized_path, ref.optimized_path)


def test_checkpoint_saves_tensors_atomically_on_its_cadence(tmp_path):
    path = str(tmp_path / "state.npz")
    assert load_state(path) is None
    ck = SequenceCheckpointer(path, every=3)
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    assert not ck.maybe_save(4, {"t": t})
    assert load_state(path) is None
    assert ck.maybe_save(6, {"t": t, "phase": 1, "arr": np.ones(2)})
    state = ck.restore()
    np.testing.assert_array_equal(state["t"], t.numpy())
    assert int(state["frame_cursor"]) == 6 and int(state["phase"]) == 1
    save_state(path, {"x": torch.zeros(2, requires_grad=True)})
    assert set(load_state(path)) == {"x"}
    np.testing.assert_array_equal(j_checkpoint.load_state(path)["x"],
                                  np.zeros(2))
