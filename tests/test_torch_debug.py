"""The port's ``utils/debug`` and ``utils/profiling`` against the JAX
package's ``utils/debug`` (the cases of ``tests/test_debug.py``, each also
run through the JAX function on the same inputs), plus smoke tests of
``trace``, ``annotate`` and ``debug_mode``.

Tolerances: ``deterministic_repeat``'s nearest neighbours against
``nn_xla``'s: indices bitwise, float32 distances rtol 1e-6 (XLA's CPU
backend contracts into multiply-adds); the drift gate's float32-vs-float64 drift below 1e-3 (its
gate), and within 1e-5 of the JAX package's drift on the same pair.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.utils import debug as j_debug
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.utils import debug, profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    several processes, whose thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_assert_all_finite_passes_and_raises():
    tree = {"a": torch.ones(3), "b": [np.zeros(2)],
            "t": RigidTransform2.identity()}
    debug.assert_all_finite(tree)
    j_debug.assert_all_finite({"a": jnp.ones(3), "b": [np.zeros(2)]})
    for bad in (torch.tensor([1.0, float("nan")]),
                {"t": RigidTransform2(torch.eye(2),
                                      torch.tensor([0.0, float("inf")]))}):
        with pytest.raises(FloatingPointError, match="non-finite"):
            debug.assert_all_finite(bad)
    with pytest.raises(FloatingPointError, match="non-finite"):
        j_debug.assert_all_finite(jnp.asarray([1.0, np.nan]))
    # Integer and bool leaves are not scanned.
    debug.assert_all_finite([torch.arange(3), torch.ones(2, dtype=bool)])


def test_checked_wrapper():
    @debug.checked
    def bad(x):
        return x / 0.0

    @j_debug.checked
    def j_bad(x):
        return x / 0.0

    with pytest.raises(FloatingPointError):
        bad(torch.ones(2))
    with pytest.raises(FloatingPointError):
        j_bad(jnp.ones(2))
    assert torch.equal(debug.checked(torch.abs)(torch.ones(2)),
                       torch.ones(2))


def test_deterministic_repeat():
    from icp_rust_tpu.ops.nn import nn_xla
    from icp_rust_tpu_torch.ops.nn import nn_torch

    rng = np.random.default_rng(0)
    q = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    d = rng.uniform(-1, 1, (128, 2)).astype(np.float32)
    got = debug.deterministic_repeat(
        lambda: nn_torch(torch.as_tensor(q), torch.as_tensor(d)))
    want = j_debug.deterministic_repeat(
        lambda: nn_xla(jnp.asarray(q), jnp.asarray(d)))
    # Indices bitwise; float32 distances within the few ulps of XLA's
    # CPU multiply-add contraction.
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-6)
    calls = iter(range(10))
    with pytest.raises(AssertionError, match="nondeterministic"):
        debug.deterministic_repeat(lambda: torch.tensor(next(calls)))


def _pair():
    rng = np.random.default_rng(1)
    src = rng.uniform(-2, 2, (256, 2))
    c, s = np.cos(0.05), np.sin(0.05)
    dst = src @ np.array([[c, s], [-s, c]]) + [0.1, -0.05]
    return src, dst, np.ones(256, bool)


def test_drift_gate_alignment():
    """float32 vs float64 alignment drift on a synthetic pair stays tiny,
    as in the JAX package."""
    from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT2
    from icp_rust_tpu.models.icp2d import icp2d as j_icp2d
    from icp_rust_tpu_torch.models.icp2d import icp2d

    src, dst, mask = _pair()

    def run(cfg):
        t = icp2d(src, dst, mask, mask,
                  RigidTransform2.identity(dtype=cfg.compute_dtype), cfg,
                  device="cpu")
        return (torch.cat([t.t.ravel(), t.rot.ravel()]),)

    def j_run(cfg):
        t = j_icp2d(jnp.asarray(src, cfg.compute_dtype),
                    jnp.asarray(dst, cfg.compute_dtype), jnp.asarray(mask),
                    jnp.asarray(mask), JT2.identity(dtype=cfg.compute_dtype),
                    cfg)
        return (np.concatenate([np.asarray(t.t).ravel(),
                                np.asarray(t.rot).ravel()]),)

    drift = debug.drift_gate(run, ICPConfig(), REFERENCE_CONFIG, atol=1e-3)
    j_drift = j_debug.drift_gate(
        j_run, JaxConfig(compute_dtype=jnp.float32), J_REF, atol=1e-3)
    assert drift < 1e-3
    assert abs(drift - j_drift) < 1e-5
    with pytest.raises(AssertionError, match="drift"):
        debug.drift_gate(run, ICPConfig(), REFERENCE_CONFIG, atol=0.0)


def test_trace_writes_the_range(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("odometry"):
            torch.ones(64).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "odometry" in names
    assert "odometry" in {e.key for e in prof.key_averages()}


def test_debug_mode_raises_on_nan_only_and_restores():
    with profiling.debug_mode():
        torch.tensor([1.0, float("inf")]) * 2.0   # inf is not checked
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.tensor(0.0) / 0
    # Outside the scope NaN passes again.
    assert torch.isnan(torch.tensor(0.0) / 0)
