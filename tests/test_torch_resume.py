"""The port's per-frame odometry runners (``run_odometry``,
``run_odometry_device``, ``run_odometry_p2l``) against the JAX package's,
on ``tests/test_resume.py``'s inputs: kill-and-resume bitwise, the JSONL
metrics rows, the fused runners' stats equal to the per-frame loop's, and
a resume from a checkpoint that the JAX runner wrote.

Tolerances: float64 trajectories within 1e-9 m of the JAX runners' (the
drivers' parity tolerance); resumed runs bitwise equal to the
uninterrupted run of the same runner; the metrics rows' mean NN
distance within 1e-9 m of JAX's, outer iterations equal; the fused runner's stats equal to
the per-frame loop's (outer iterations exact, errors rtol 1e-12, as
``tests/test_resume.py`` holds JAX's).
"""

import json
import os

import numpy as np
import pytest
import torch

from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.models import odometry as j_odo
from icp_rust_tpu.utils.checkpoint import SequenceCheckpointer as JCkpt
from icp_rust_tpu_torch.config import REFERENCE_CONFIG
from icp_rust_tpu_torch.models import odometry
from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer
from icp_rust_tpu_torch.utils.metrics import MetricsLogger

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    several processes, whose thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequence(f=9, n=256, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-3000, 3000, (n, 2))
    frames = np.zeros((f, n, 2))
    for k in range(f):
        th = 0.01 * k
        c, s = np.cos(th), np.sin(th)
        frames[k] = base @ np.array([[c, -s], [s, c]]).T + [10.0 * k, 0]
        frames[k] += rng.normal(0, 0.5, (n, 2))
    return frames, np.ones((f, n), bool)


def _sequence3d(f=7, n=256, seed=1):
    """Gentle 3D terrain scans (normals well-defined for p2l)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2, 2, (n, 3))
    base[:, 2] = 0.2 * np.sin(base[:, 0]) + 0.1 * base[:, 1]
    frames = np.zeros((f, n, 3))
    for k in range(f):
        th = 0.02 * k
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        frames[k] = base @ rot.T + [0.05 * k, 0.02 * k, 0.0]
    return frames, np.ones((f, n), bool)


RUNNERS = {
    "se2": (odometry.run_odometry_device, j_odo.run_odometry_device,
            _sequence, {}),
    "p2l": (odometry.run_odometry_p2l, j_odo.run_odometry_p2l,
            _sequence3d, {"normals_voxel_size": 1.0}),
}


@pytest.fixture(scope="module")
def jax_paths():
    """The JAX runners' uninterrupted float64 paths, once per module."""
    out = {}
    for kind, (_, jrun, seq, kw) in RUNNERS.items():
        frames, masks = seq()
        out[kind] = np.asarray(jrun(frames, masks, J_REF, **kw)[1])
    return out


@pytest.mark.parametrize("kind", ["se2", "p2l"])
def test_kill_and_resume_bitwise_and_matches_jax(kind, tmp_path, jax_paths):
    run, _, seq, kw = RUNNERS[kind]
    frames, masks = seq()
    ck = str(tmp_path / "ck.npz")
    transforms, path_ref = run(frames, masks, REFERENCE_CONFIG, **kw, **CPU)
    assert len(transforms) == len(frames) - 1
    np.testing.assert_allclose(path_ref, jax_paths[kind], atol=1e-9, rtol=0)
    # "Crash" after frame 5 (3 in 3D): checkpoints every 2 frames.
    cut = 6 if kind == "se2" else 4
    run(frames[:cut], masks[:cut], REFERENCE_CONFIG,
        checkpoint=SequenceCheckpointer(ck, every=2), **kw, **CPU)
    assert os.path.exists(ck)
    saved = int(np.load(ck)["frame_cursor"])
    tf_res, path_res = run(frames, masks, REFERENCE_CONFIG,
                           checkpoint=SequenceCheckpointer(ck, every=2),
                           resume=True, **kw, **CPU)
    np.testing.assert_array_equal(path_res, path_ref)
    # Frames before the cursor are not recomputed.
    assert len(tf_res) == len(frames) - 1 - saved
    assert len(path_res) - len(tf_res) == saved


@pytest.mark.parametrize("kind", ["se2", "p2l"])
def test_resume_from_a_jax_checkpoint(kind, tmp_path, jax_paths):
    """State carried across: the port resumes from the npz that the JAX
    runner wrote (the same keys) and lands on JAX's uninterrupted run."""
    run, jrun, seq, kw = RUNNERS[kind]
    frames, masks = seq()
    ck = str(tmp_path / "jck.npz")
    cut = 6 if kind == "se2" else 4
    jrun(frames[:cut], masks[:cut], J_REF, checkpoint=JCkpt(ck, every=2),
         **kw)
    _, path = run(frames, masks, REFERENCE_CONFIG,
                  checkpoint=SequenceCheckpointer(ck, every=2), resume=True,
                  **kw, **CPU)
    np.testing.assert_allclose(path, jax_paths[kind], atol=1e-9, rtol=0)


@pytest.mark.parametrize("kind", ["se2", "p2l"])
def test_metrics_rows_populated_and_match_jax(kind, tmp_path):
    run, jrun, seq, kw = RUNNERS[kind]
    frames, masks = seq(f=5 if kind == "se2" else 4)
    mpath = str(tmp_path / "m.jsonl")
    log = MetricsLogger(mpath)
    _, path = run(frames, masks, REFERENCE_CONFIG, metrics=log, **kw, **CPU)
    log.close()
    jlog = MetricsLogger(None)
    _, jpath = jrun(frames, masks, J_REF, metrics=jlog, **kw)
    np.testing.assert_allclose(path, np.asarray(jpath), atol=1e-9, rtol=0)
    rows = [json.loads(line) for line in open(mpath)]
    assert [r["frame"] for r in rows] == list(range(1, len(frames)))
    for r, j in zip(rows, jlog.records):
        assert np.isfinite(r["huber_error"])
        assert np.isfinite(r["mean_nn_dist"]) and r["mean_nn_dist"] >= 0
        assert 0.0 <= r["inlier_fraction"] <= 1.0
        assert r["extra"]["outer_iters"] == j.extra["outer_iters"] >= 1
        assert r["seconds"] > 0
        np.testing.assert_allclose(r["mean_nn_dist"], j.mean_nn_dist,
                                   atol=1e-9, rtol=0)
        np.testing.assert_allclose(r["inlier_fraction"], j.inlier_fraction,
                                   rtol=1e-12)


@pytest.mark.parametrize("kind", ["se2", "p2l"])
def test_fused_runner_metrics_match_per_frame_loop(kind):
    run, _, seq, kw = RUNNERS[kind]
    fused = (odometry.run_odometry_fused if kind == "se2"
             else odometry.run_odometry_p2l_fused)
    frames, masks = seq(f=5)
    log = MetricsLogger(None)
    _, path_d = run(frames, masks, REFERENCE_CONFIG, metrics=log, **kw,
                    **CPU)
    _, path_f, stats = fused(frames, masks, REFERENCE_CONFIG, **kw,
                             with_metrics=True, **CPU)
    np.testing.assert_array_equal(path_f, path_d)
    assert len(log.records) == len(frames) - 1
    for i, rec in enumerate(log.records):
        assert int(stats.outer_iters[i]) == rec.extra["outer_iters"]
        np.testing.assert_allclose(float(stats.huber_error[i]),
                                   rec.huber_error, rtol=1e-12)
        np.testing.assert_allclose(float(stats.mean_nn_dist[i]),
                                   rec.mean_nn_dist, rtol=1e-12)


def test_run_odometry_ragged_frames_match_jax():
    """``run_odometry`` pads a list of ragged scans itself."""
    frames, _ = _sequence(f=4)
    ragged = [f[: 256 - 40 * k] for k, f in enumerate(frames)]
    tf, path = odometry.run_odometry(ragged, REFERENCE_CONFIG,
                                     pad_multiple=64, **CPU)
    jtf, jpath = j_odo.run_odometry(ragged, J_REF, pad_multiple=64)
    assert len(tf) == len(jtf) == 3 and path.shape == (3, 2)
    np.testing.assert_allclose(path, jpath, atol=1e-9, rtol=0)
    for a, b in zip(tf, jtf):
        np.testing.assert_allclose(a.rot.numpy(), np.asarray(b.rot),
                                   atol=1e-12)
