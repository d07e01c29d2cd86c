"""The port's robust SE(2) solver and its two solver kernels' plain
versions against the JAX package, on the same inputs.

Tolerances:
- float64: <= 1e-12 against the JAX XLA path and the NumPy oracle (same
  formulas; sums in another order cost a few ulp of the result).
- irls_loop's plain version (float32) against
  ``estimate_transform_pallas(..., interpret=True)``: 1e-6, the JAX
  package's own tolerance for that kernel against its XLA loop (sums over
  a few hundred points taken in another order).
- icp2d_frame's plain version (float32) against
  ``icp2d_frame_pallas(..., interpret=True)``: 1e-5, the JAX package's own
  tolerance for that kernel against its unfused icp2d (the in-kernel
  transform is a mul-add where icp2d runs an einsum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT
from icp_rust_tpu.ops import align2d as j_align
from icp_rust_tpu.ops import align2d_pallas as j_pallas
from icp_rust_tpu.utils import oracle_np as oracle
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2 as TT
from icp_rust_tpu_torch.models.icp2d import icp2d_frame_plain
from icp_rust_tpu_torch.ops import align2d, align2d_cuda

F64_TOL = 1e-12
IRLS_TOL = 1e-6
FRAME_TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _problem(seed=0, n=384, masked=True, dtype=np.float64):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (n, 2))
    c, s = np.cos(0.15), np.sin(0.15)
    dst = src @ np.array([[c, -s], [s, c]]).T + np.array([0.3, -0.2])
    dst += rng.normal(0, 0.05, dst.shape)
    dst[::17] += 3.0  # outliers exercise the Huber branch
    mask = (rng.random(n) > 0.2) if masked else np.ones(n, bool)
    return src.astype(dtype), dst.astype(dtype), mask


@pytest.mark.parametrize("seed,th", [(0, 0.0), (3, -0.4), (5, 2.5)])
def test_weighted_gn_update_float64(seed, th):
    src, dst, mask = _problem(seed)
    c, s = np.cos(th), np.sin(th)
    rot, t = np.array([[c, -s], [s, c]]), np.array([0.4, 0.1])
    got = align2d.weighted_gauss_newton_update(
        TT(_t(rot), _t(t)), _t(src), _t(dst), _t(mask), 1.345)
    want = j_align.weighted_gauss_newton_update(
        JT(jnp.asarray(rot), jnp.asarray(t)), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(mask), 1.345)
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_allclose(got.delta.numpy(), np.array(want.delta),
                               rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got.err.numpy(), np.array(want.err),
                               rtol=F64_TOL)
    j = align2d.jacobian(_t(rot), _t(src))
    np.testing.assert_allclose(
        j.numpy(), np.array(j_align.jacobian(jnp.asarray(rot),
                                             jnp.asarray(src))),
        rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_estimate_transform_float64_matches_jax_and_oracle(masked):
    src, dst, mask = _problem(1, n=50, masked=masked)
    got = align2d.estimate_transform(_t(src), _t(dst), _t(mask),
                                     REFERENCE_CONFIG)
    want = j_align.estimate_transform(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(mask),
                                      JaxConfig(compute_dtype=jnp.float64))
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=F64_TOL, rtol=0)
    t_o = oracle.estimate_transform(src[mask], dst[mask])
    np.testing.assert_allclose(got.rot.numpy(), t_o.rot, atol=F64_TOL)
    np.testing.assert_allclose(got.t.numpy(), t_o.t, atol=F64_TOL)


def test_estimate_transform_point_scale_is_equivariant():
    src, dst, mask = _problem(2, n=64)
    s = 7.0
    cfg = REFERENCE_CONFIG.with_(point_scale=s)
    got = align2d.estimate_transform(_t(src / s), _t(dst / s), _t(mask), cfg)
    ref = align2d.estimate_transform(_t(src), _t(dst), _t(mask),
                                     REFERENCE_CONFIG)
    np.testing.assert_allclose(got.rot.numpy(), ref.rot.numpy(), atol=1e-9)
    np.testing.assert_allclose(got.t.numpy() * s, ref.t.numpy(), atol=1e-9)


@pytest.mark.parametrize("seed,masked", [(0, True), (7, False)])
def test_irls_plain_matches_pallas_interpret(seed, masked):
    src, dst, mask = _problem(seed, masked=masked, dtype=np.float32)
    cfg = ICPConfig(det_rel_eps=1e-9)  # align "auto": the kernel route
    rot, t, it = align2d_cuda.irls_loop(
        _t(src), _t(dst), _t(mask), cfg.huber_k, cfg.det_rel_eps,
        cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    jrot, jt = j_pallas.estimate_transform_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), cfg.huber_k,
        cfg.det_rel_eps, cfg.inner_delta_sq_tol, cfg.inner_max_iter,
        cfg.point_scale, interpret=True)
    np.testing.assert_allclose(rot.numpy(), np.array(jrot), atol=IRLS_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.numpy(), np.array(jt), atol=IRLS_TOL,
                               rtol=0)
    assert 1 <= it <= cfg.inner_max_iter
    # estimate_transform dispatches to the same routine on "auto"/float32.
    via = align2d.estimate_transform(_t(src), _t(dst), _t(mask), cfg)
    assert torch.equal(via.rot, rot) and torch.equal(via.t, t)


@pytest.mark.parametrize("n_valid", [None, 1, 0])
def test_irls_plain_degenerate_is_identity(n_valid):
    """Perfect fit (sigma 0), a single point or no point: no update, the
    Option::None semantics of the reference (src/lib.rs:186-189,236-247)."""
    src = np.random.default_rng(1).uniform(-1, 1, (128, 2)).astype(
        np.float32)
    mask = np.ones(128, bool)
    dst = src.copy()
    if n_valid is not None:
        mask[n_valid:] = False
        dst = dst + np.float32(0.1)
    rot, t, _ = align2d_cuda.irls_loop(_t(src), _t(dst), _t(mask), 1.345,
                                       1e-9, 1e-6, 200, 1.0)
    jrot, jt = j_pallas.estimate_transform_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), 1.345, 1e-9,
        1e-6, 200, 1.0, interpret=True)
    np.testing.assert_array_equal(rot.numpy(), np.eye(2, dtype=np.float32))
    np.testing.assert_array_equal(t.numpy(), np.zeros(2, np.float32))
    np.testing.assert_array_equal(np.array(jrot), rot.numpy())
    np.testing.assert_array_equal(np.array(jt), t.numpy())


def test_batched_inner_loop_is_not_ported_on_the_kernel_route():
    """One pair axis takes the batched kernel route (its plain version on
    the CPU); more than one batch axis is not ported there: "cuda"
    refuses it, and "auto" takes the plain loop, as the JAX package's
    "pallas" takes its XLA loop."""
    src, dst, mask = _problem(0, n=128, dtype=np.float32)
    b = lambda x: _t(np.stack([x, x]))  # noqa: E731
    with pytest.raises(NotImplementedError, match="_inner_loop_batched"):
        align2d.estimate_transform(b(b(src)), b(b(dst)), b(b(mask)),
                                   ICPConfig(align_backend="cuda"))
    two = align2d.estimate_transform(b(b(src)), b(b(dst)), b(b(mask)),
                                     ICPConfig())
    plain = align2d.estimate_transform(b(b(src)), b(b(dst)), b(b(mask)),
                                       ICPConfig(align_backend="torch"))
    assert torch.equal(two.rot, plain.rot) and torch.equal(two.t, plain.t)
    out = align2d.estimate_transform(b(src), b(dst), b(mask), ICPConfig())
    plain = align2d.estimate_transform(b(src), b(dst), b(mask),
                                       ICPConfig(align_backend="torch"))
    assert out.rot.shape == (2, 2, 2)
    assert torch.equal(out.rot[0], out.rot[1])
    assert torch.equal(out.rot, plain.rot) and torch.equal(out.t, plain.t)


def _pad(a, n):
    out = np.zeros((n, 2), np.float32)
    out[: len(a)] = a
    msk = np.zeros(n, bool)
    msk[: len(a)] = True
    return out, msk


def _frame_pair(seed, n=600, m=560, pad=768, theta=0.05, t=(0.1, -0.05)):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]], np.float32)
    dst = src @ rot.T + np.asarray(t, np.float32)
    dst = dst[rng.permutation(n)][:m]
    return _pad(src, pad) + _pad(dst, pad)


@pytest.mark.parametrize("seed,warm", [(0, None), (3, 0.25)])
def test_frame_plain_matches_pallas_interpret(seed, warm):
    if warm is None:
        sp, sm, dp, dm = _frame_pair(seed)
        rot0, t0 = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
    else:
        sp, sm, dp, dm = _frame_pair(seed, theta=0.3, t=(0.4, 0.2))
        c, s = np.cos(warm), np.sin(warm)
        rot0 = np.array([[c, -s], [s, c]], np.float32)
        t0 = np.array([0.35, 0.15], np.float32)
    cfg = ICPConfig(det_rel_eps=1e-9)
    rot, t, it = icp2d_frame_plain(_t(sp), _t(dp), _t(sm), _t(dm),
                                   TT(_t(rot0), _t(t0)), cfg)
    jrot, jt, jit = j_pallas.icp2d_frame_pallas(
        jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm), jnp.asarray(dm),
        jnp.asarray(rot0), jnp.asarray(t0), huber_k=cfg.huber_k,
        det_rel_eps=cfg.det_rel_eps, tol_d2=cfg.inner_delta_sq_tol,
        inner_max_iter=cfg.inner_max_iter, outer_iters=cfg.outer_iters,
        point_scale=1.0, interpret=True)
    np.testing.assert_allclose(rot.numpy(), np.array(jrot), atol=FRAME_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.numpy(), np.array(jt), atol=FRAME_TOL,
                               rtol=0)
    assert 1 <= it <= cfg.outer_iters and 1 <= int(jit) <= cfg.outer_iters


def test_estimate_transform_over_two_batch_axes_matches_jax():
    """float32 src/dst (2, 2, 256, 2) with the default config: the port's
    "auto" and the JAX package's "pallas" both take their plain loops
    (the kernels serve at most one pair axis)."""
    rng = np.random.default_rng(21)
    lanes = [_problem(seed, n=256, dtype=np.float32)
             for seed in rng.integers(0, 1000, 4)]
    src, dst, mask = (np.stack([lane[k] for lane in lanes]).reshape(
        2, 2, *lanes[0][k].shape) for k in range(3))
    got = align2d.estimate_transform(_t(src), _t(dst), _t(mask), ICPConfig())
    want = j_align.estimate_transform(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(mask), JaxConfig())
    assert got.rot.shape == (2, 2, 2, 2) and got.t.shape == (2, 2, 2)
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=IRLS_TOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=IRLS_TOL, rtol=0)
