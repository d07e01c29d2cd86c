"""The port's odometry runner and scan I/O against the JAX package, and a
CPU rehearsal of chip_smoke.py's phases at a tiny size.

Tolerances:
- float64 trajectories: <= 1e-9 m against the JAX run (the drivers'
  parity tolerance).
- float32: the port's kernel-structured path (sorted, survivor lists, the
  kernels' plain versions) against the JAX float32 path, which on a CPU
  is its plain unsorted XLA path: ATE <= 1e-5 m (sums over permuted
  points, compounded over the frames).
- Synthetic frames: bitwise.
"""

import os
import sys

import numpy as np
import pytest

from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.models import odometry as j_odo
from icp_rust_tpu.utils import io as j_io
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.models import odometry
from icp_rust_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthesize_frames3d_matches_hdf5_round_trip(tmp_path):
    path = os.path.join(tmp_path, "scans.hdf5")
    traj_j = j_io.synthesize_scans3d(path, n_frames=3, seed=3)
    frames_j = j_io.load_scans3d_hdf5(path)
    frames, traj = io.synthesize_frames3d(3, seed=3)
    np.testing.assert_array_equal(traj, traj_j)
    assert len(frames) == len(frames_j) == 3
    for a, b in zip(frames, frames_j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert 27000 < len(a) < 28800


def test_scan_io_helpers_match(tmp_path):
    rng = np.random.default_rng(0)
    scans = [rng.uniform(-3000, 3000, (n, 2)) for n in (411, 670, 500)]
    for i, s in enumerate(scans):
        np.savetxt(os.path.join(tmp_path, f"{i:03d}.txt"), s)
    seq = io.load_scan2d_sequence(str(tmp_path), limit=2)
    seq_j = j_io.load_scan2d_sequence(str(tmp_path), limit=2)
    assert len(seq) == 2
    for a, b in zip(seq, seq_j):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"pad_to": 768}, {"multiple": 256}):
        for a, b in zip(io.pad_points(scans, **kw),
                        j_io.pad_points(scans, **kw)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        io.pad_points(scans, pad_to=512)
    np.testing.assert_array_equal(io.ground_truth_trajectory(7),
                                  j_io.ground_truth_trajectory(7))


def _sequence(n_frames, stride):
    frames, traj = io.synthesize_frames3d(n_frames, seed=0)
    pts, mask = io.pad_points([f[::stride] for f in frames])
    c, s = np.cos(traj[0, 2]), np.sin(traj[0, 2])
    gt = (traj[1:, :2] - traj[0, :2]) @ np.array([[c, -s], [s, c]])
    return pts, mask, gt


def test_run_odometry_fused_float64_matches_jax():
    pts, mask, gt = _sequence(4, stride=32)
    tf, path = odometry.run_odometry_fused(pts, mask, REFERENCE_CONFIG,
                                           device="cpu")
    jtf, jpath = j_odo.run_odometry_fused(pts, mask, J_REF)
    assert tf.rot.shape == (3, 2, 2) and path.shape == (3, 2)
    np.testing.assert_allclose(path, jpath, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tf.rot.numpy(), np.array(jtf.rot), atol=1e-9)
    assert odometry.ate_rmse(path, gt) < 0.05
    assert odometry.ate_rmse(path, gt) == j_odo.ate_rmse(path, gt)


def test_run_odometry_fused_float32_kernel_route_matches_jax():
    pts, mask, gt = _sequence(4, stride=16)
    cfg = ICPConfig(nn_dst_tile=256, det_rel_eps=1e-9)
    tf, path, st = odometry.run_odometry_fused(pts, mask, cfg,
                                               with_metrics=True,
                                               device="cpu")
    jcfg = JaxConfig(nn_dst_tile=256, det_rel_eps=1e-9)
    _, jpath, jst = j_odo.run_odometry_fused(pts, mask, jcfg,
                                             with_metrics=True)
    assert odometry.ate_rmse(path, jpath) < 1e-5
    assert odometry.ate_rmse(path, gt) < 0.05
    assert st.outer_iters.shape == (3,)
    assert (st.outer_iters.numpy() >= 1).all()
    np.testing.assert_allclose(st.inlier_fraction.numpy(),
                               np.array(jst.inlier_fraction), atol=1e-3)


def test_run_odometry_fused_2d_frame_kernel_route():
    frames, _ = io.synthesize_frames3d(3, seed=2)
    rng = np.random.default_rng(3)
    xy = [f[rng.choice(len(f), 300, replace=False), :2] for f in frames]
    pts, mask = io.pad_points(xy)
    cfg = ICPConfig(det_rel_eps=1e-9)
    _, path = odometry.run_odometry_fused(pts, mask, cfg, device="cpu")
    _, plain = odometry.run_odometry_fused(
        pts, mask, cfg.with_(frame_backend="off", nn_backend="torch",
                             align_backend="torch"), device="cpu")
    np.testing.assert_array_equal(path, plain)


@pytest.mark.parametrize("dim", [2, 3])
def test_one_frame_sequence_gives_empty_results_as_jax(dim):
    """A one-frame sequence, (1, 128, 2) through run_odometry_fused and
    (1, 128, 3) through run_odometry_p2l_fused: an empty path, transforms
    and stats with a 0-length frame axis, as the JAX package's lax.scan
    over no frames gives."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3, 3, (1, 128, dim)).astype(np.float32)
    mask = np.ones((1, 128), bool)
    if dim == 2:
        got = odometry.run_odometry_fused(pts, mask, REFERENCE_CONFIG,
                                          with_metrics=True, device="cpu")
        want = j_odo.run_odometry_fused(pts, mask, J_REF, with_metrics=True)
        width = 2
    else:
        got = odometry.run_odometry_p2l_fused(pts, mask, REFERENCE_CONFIG,
                                              with_metrics=True,
                                              device="cpu")
        want = j_odo.run_odometry_p2l_fused(pts, mask, J_REF,
                                            with_metrics=True)
        width = 3
    (tf, path, st), (jtf, jpath, jst) = got, want
    assert path.shape == np.shape(jpath) == (0, width)
    assert tf.rot.shape == np.shape(jtf.rot) == (0, width, width)
    assert tf.t.shape == np.shape(jtf.t) == (0, width)
    for name in st._fields:
        assert tuple(getattr(st, name).shape) == np.shape(getattr(jst, name))


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(ROOT)
    return mod


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the phases' tensors are tiny, and the suite
    runs in several processes, whose thread pools would oversubscribe the
    cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_phases_rehearse_on_cpu(chip_smoke, capsys,
                                           one_torch_thread):
    """Each phase of chip_smoke.py at a tiny size on the CPU, where every
    wrapper takes its kernel's plain version."""
    recs = [
        chip_smoke.phase_nn_list("cpu", stride=24, tile=256, q_tile=64),
        *chip_smoke.phase_irls("cpu", stride=24),
        *chip_smoke.phase_frame("cpu", n=120, pad=128, n_max=256),
    ]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0  # the same code on the CPU
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    main = chip_smoke.phase_main("cpu", n_frames=3, stride=24,
                                 plain_frames=2, tile=256)
    assert main["ate"] < chip_smoke.ATE_GATE_M
    two_d = chip_smoke.phase_2d("cpu", n_frames=3, n_points=120, pad=128)
    assert two_d["ate"] < chip_smoke.ATE_GATE_M
    out = capsys.readouterr().out
    assert "bitwise equal to plain and brute force" in out
    assert "bitwise equal to the first run" in out

    # Phases 21-23: the per-frame runners against the fused ones (phase
    # 4's run above; the p2l fused run here, at the same size), the CLI
    # with the native oracle and loader, the hooks and the Schur solve.
    size = dict(n_frames=3, stride=24, tile=256)
    pts, mask, _ = chip_smoke.frames3d(3, 24)
    _, path, stats = odometry.run_odometry_p2l_fused(
        pts, mask, chip_smoke._config(nn_dst_tile=256), 0.6,
        with_metrics=True, device="cpu")
    p2l = dict(path=path, stats=stats)
    runs = chip_smoke.phase_runners("cpu", main, p2l, cut=2, every=1,
                                    voxel=0.6, **size)
    assert set(runs) == {"odometry-device", "odometry-p2l"}
    cli_runs = chip_smoke.phase_cli("cpu", n_scans=8, pad=128)
    assert set(cli_runs) == {"cli-odometry2d", "cli-odometry2d-metrics",
                             "cli-slam"}
    assert cli_runs["cli-odometry2d"]["summary"]["oracle"] == "native_cpp"
    graph = _loop_graph()
    hooks = chip_smoke.phase_hooks("cpu", graph, n_frames=3, stride=24,
                                   tile=256, iters=2)
    assert hooks["err"] <= 1e-8
    out = capsys.readouterr().out
    for line in ("odometry-device runner", "odometry-p2l runner",
                 "native loader", "cli odometry2d --metrics", "cli slam",
                 "debug_mode raised", "graph solve"):
        assert line in out, line


def _loop_graph(n=12):
    """A float64 SE(3) odometry chain with one loop closure."""
    import torch

    from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
    from icp_rust_tpu_torch.models import pose_graph as pg

    rng = np.random.default_rng(7)
    step = np.array([0.3, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n])
    chain = RigidTransform3.from_twist(torch.as_tensor(
        step + rng.normal(0, 0.01, (n - 1, 6))))
    z = RigidTransform3.from_twist(torch.as_tensor(step * 2))
    return pg.odometry_chain_graph(
        chain, extra_edges=[(0, 2, z, 10.0 * np.eye(6))])
