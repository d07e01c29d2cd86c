"""The port's user-facing surface against the JAX package's: the numpy
oracle, the native C++ oracle and scan loader (the port's own copies of
the sources, built into ``icp_rust_tpu_torch/_build/``), the HDF5 scan
I/O, the CLI and the 2D example.

Tolerances: ``oracle_np``, the native oracle, the loaders and the HDF5
writer and reader bitwise equal to the JAX package's (the native oracle
is built with the JAX package's flags, ``-march=native`` included, which
makes it bitwise on the same host); the CLI's float64 ``path_end`` within
1e-9 m of the JAX runners' on the same frames, graph errors within 1e-9
relative, and ``ate_rmse_vs_oracle`` within 1e-9 of the same figure from
the JAX runner and the JAX package's native oracle; the example bitwise
the port's ``run_odometry_fused`` call it makes.
"""

import contextlib
import filecmp
import io as std_io
import json
import os

import numpy as np
import pytest
import torch

from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.models import odometry as j_odo
from icp_rust_tpu.models.slam import run_slam2d as j_slam2d
from icp_rust_tpu.native import loader as j_loader
from icp_rust_tpu.native import oracle as j_native
from icp_rust_tpu.utils import io as j_io
from icp_rust_tpu.utils import oracle_np as j_oracle_np
from icp_rust_tpu_torch import cli
from icp_rust_tpu_torch.examples import scan2d
from icp_rust_tpu_torch.native import build, loader, oracle
from icp_rust_tpu_torch.utils import io, oracle_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    several processes, whose thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_scans(directory, n_scans=6, seed=5):
    """``n_scans`` 2D scans in the reference's text format, in mm: the xy
    of synthetic frames, 150-230 points each."""
    frames, _ = io.synthesize_frames3d(n_scans, seed=seed)
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for k, f in enumerate(frames):
        n = int(rng.integers(150, 231))
        xy = f[rng.choice(len(f), n, replace=False), :2] * 1000.0
        np.savetxt(os.path.join(directory, f"{k:03d}.txt"), xy)
    return directory


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    return _write_scans(str(tmp_path_factory.mktemp("scans2d")))


def _main(argv) -> dict:
    """Run ``cli.main`` in-process; return its JSON summary line."""
    out = std_io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_native_sources_are_the_jax_packages():
    for name in ("icp_oracle", "scan_loader"):
        assert filecmp.cmp(build.SRC / f"{name}.cpp",
                           os.path.join(ROOT, "icp_rust_tpu", "native",
                                        "src", f"{name}.cpp"), shallow=False)
        assert build.lib_path(name).parent == build.BUILD_DIR
    assert "icp_rust_tpu_torch" in str(build.BUILD_DIR)


def _oracle_inputs():
    """tests/test_native_oracle.py's three cases."""
    rng = np.random.default_rng(0)
    src = rng.uniform(-10, 10, (80, 2))
    t_true = oracle_np.Transform.from_twist([0.5, -0.7, 0.12])
    est = (src, t_true.apply(src) + rng.normal(0, 0.02, (80, 2)))
    rng = np.random.default_rng(1)
    src = rng.uniform(-5, 5, (150, 2))
    t_true = oracle_np.Transform.from_twist([0.05, -0.02, 0.03])
    icp2 = (src, t_true.apply(src) + rng.normal(0, 0.005, (150, 2)))
    rng = np.random.default_rng(2)
    src2 = rng.uniform(-3, 3, (200, 2))
    z = rng.uniform(0, 2, 200)
    t_true = oracle_np.Transform.from_twist([0.04, 0.01, -0.02])
    icp3 = (np.column_stack([src2, z]),
            np.column_stack([t_true.apply(src2), z])
            + rng.normal(0, 0.002, (200, 3)))
    return est, icp2, icp3


def test_native_oracle_bitwise_equal_to_jax_packages():
    assert oracle.available() and j_native.available()
    est, icp2, icp3 = _oracle_inputs()
    np.testing.assert_array_equal(oracle.estimate_transform(*est),
                                  j_native.estimate_transform(*est))
    np.testing.assert_array_equal(oracle.icp2d_estimate(*icp2),
                                  j_native.icp2d_estimate(*icp2))
    np.testing.assert_array_equal(oracle.icp3d_estimate(*icp3),
                                  j_native.icp3d_estimate(*icp3))
    with pytest.raises(ValueError):
        oracle.icp2d_estimate(icp3[0], icp3[1])


def test_oracles_run_odometry_bitwise_equal_to_jax_packages(scans):
    frames = io.load_scan2d_sequence(scans)
    for mine, theirs in ((oracle_np, j_oracle_np), (oracle, j_native)):
        np.testing.assert_array_equal(mine.run_odometry2d(frames)[1],
                                      theirs.run_odometry2d(frames)[1])
    est, _, icp3 = _oracle_inputs()
    a = oracle_np.estimate_transform(*est)
    b = j_oracle_np.estimate_transform(*est)
    np.testing.assert_array_equal(a.rot, b.rot)
    np.testing.assert_array_equal(a.t, b.t)
    frames3 = [icp3[0], icp3[1], icp3[1] + [0.01, 0.0, 0.0]]
    for mine, theirs in ((oracle_np, j_oracle_np), (oracle, j_native)):
        np.testing.assert_array_equal(mine.run_odometry3d(frames3)[1],
                                      theirs.run_odometry3d(frames3)[1])


@pytest.mark.parametrize("kw", [{}, {"limit": 4, "pad_multiple": 256}])
def test_native_loader_matches_python_loader(scans, kw):
    pts, mask = loader.load_scan2d_padded(scans, **kw)
    frames = io.load_scan2d_sequence(scans, limit=kw.get("limit"))
    assert pts.shape[0] == len(frames) and pts.shape[1] % kw.get(
        "pad_multiple", 128) == 0
    want_pts, want_mask = io.pad_points(
        frames, multiple=kw.get("pad_multiple", 128))
    np.testing.assert_array_equal(pts, want_pts.astype(np.float32))
    np.testing.assert_array_equal(mask, want_mask)
    j_pts, j_mask = j_loader.load_scan2d_padded(scans, **kw)
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_array_equal(mask, j_mask)


def test_hdf5_writer_and_reader_bitwise_equal_to_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    a, b = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    np.testing.assert_array_equal(io.synthesize_scans3d(a, 2, seed=3),
                                  j_io.synthesize_scans3d(b, 2, seed=3))
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        assert len(fa.keys()) == 2 * io.PACKETS_PER_FRAME
        for k in fa.keys():
            np.testing.assert_array_equal(fa[k][()], fb[k][()])
    for filt in (True, False):
        for x, y in zip(io.load_scans3d_hdf5(a, filt),
                        j_io.load_scans3d_hdf5(b, filt)):
            np.testing.assert_array_equal(x, y)
    frames, traj = io.ensure_scans3d(str(tmp_path / "e.hdf5"), 2, seed=3)
    j_frames, j_traj = j_io.ensure_scans3d(b, 2, seed=3)
    np.testing.assert_array_equal(traj, j_traj)
    for x, y in zip(frames, j_frames):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_odometry2d(scans):
    """The JAX runner and the JAX native oracle on the CLI's frames."""
    frames = j_io.load_scan2d_sequence(scans)[1:]
    pts, mask = j_io.pad_points(frames)
    _, path = j_odo.run_odometry_device(pts, mask, J_REF)
    path = np.asarray(path)
    _, path_o = j_native.run_odometry2d(frames)
    return path, j_odo.ate_rmse(path, path_o)


def test_cli_odometry2d_matches_jax(scans, jax_odometry2d, tmp_path):
    path, ate = jax_odometry2d
    m, ck = str(tmp_path / "m.jsonl"), str(tmp_path / "ck.npz")
    s = _main(["odometry2d", "--scans", scans, "--device", "cpu",
               "--compare-oracle", "--metrics", m, "--checkpoint", ck,
               "--every", "2"])
    assert s["frames"] == len(path) and s["oracle"] == "native_cpp"
    np.testing.assert_allclose(s["path_end"], path[-1], atol=1e-9, rtol=0)
    assert abs(s["ate_rmse_vs_oracle"] - ate) < 1e-9
    assert len(open(m).readlines()) == len(path)
    # A resume from the last checkpoint lands on the same end.
    s2 = _main(["odometry2d", "--scans", scans, "--device", "cpu",
                "--checkpoint", ck, "--every", "2", "--resume"])
    assert s2["path_end"] == s["path_end"]


def test_cli_odometry3d_p2l_matches_jax(tmp_path):
    """A small HDF5 file in the reader's schema: 75 packets of 4 points a
    frame, the terrain frames of tests/test_resume.py."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    base = rng.uniform(-2, 2, (300, 3))
    base[:, 2] = 0.2 * np.sin(base[:, 0]) + 0.1 * base[:, 1] + 1.0
    path_h5 = str(tmp_path / "small.hdf5")
    with h5py.File(path_h5, "w") as f:
        for k in range(4):
            th = 0.02 * k
            c, s = np.cos(th), np.sin(th)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            pts = base @ rot.T + [0.05 * k, 0.02 * k, 0.0]
            for p in range(io.PACKETS_PER_FRAME):
                f.create_dataset(f"{k * 75 + p:06d}",
                                 data=pts[4 * p:4 * p + 4].reshape(2, 2, 3))
    s = _main(["odometry3d", "--hdf5", path_h5, "--device", "cpu", "--p2l",
               "--normals-voxel", "1.0"])
    frames = j_io.load_scans3d_hdf5(path_h5)
    pts, mask = j_io.pad_points(frames)
    _, jpath = j_odo.run_odometry_p2l(pts, mask, J_REF,
                                      normals_voxel_size=1.0)
    assert s["frames"] == 3
    np.testing.assert_allclose(s["path_end"], np.asarray(jpath)[-1],
                               atol=1e-9, rtol=0)


def test_cli_slam_matches_jax(scans):
    s = _main(["slam", "--scans", scans, "--device", "cpu",
               "--loop-radius", "1000", "--loop-gap", "2"])
    frames = j_io.load_scan2d_sequence(scans)[1:]
    res = j_slam2d(frames, J_REF, loop_radius=1000.0, min_gap=2)
    assert s["loop_closures"] == res.n_loop_closures
    assert s["graph_error_after"] <= s["graph_error_before"]
    for key, want in (("graph_error_before", res.error_before),
                      ("graph_error_after", res.error_after)):
        np.testing.assert_allclose(s[key], float(want), rtol=1e-9,
                                   atol=1e-12)


def test_cli_refuses_float64_on_the_card(scans):
    with pytest.raises(SystemExit, match="--f32"):
        cli.main(["odometry2d", "--scans", scans, "--device", "cuda"])


def test_example_scan2d_on_synthetic_scans(scans, tmp_path):
    """The example is ``run_odometry_fused`` on all the scans with the
    float32 mm config: bitwise that call, and it writes its plot."""
    from icp_rust_tpu_torch.config import ICPConfig
    from icp_rust_tpu_torch.models.odometry import run_odometry_fused

    out = str(tmp_path / "traj.png")
    path = scan2d.main(["--scans", scans, "--frames", "3", "--device",
                        "cpu", "--out", out])
    frames = io.load_scan2d_sequence(scans, limit=3)
    pts, mask = io.pad_points(frames)
    _, want = run_odometry_fused(pts, mask, ICPConfig(
        compute_dtype=torch.float32, point_scale=3000.0, det_rel_eps=1e-9),
        device="cpu")
    assert path.shape == (len(frames) - 1, 2)
    np.testing.assert_array_equal(path, want)
    assert os.path.exists(out)
