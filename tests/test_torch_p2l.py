"""The port's SE(3) point-to-plane slice against the JAX package, on the
same inputs (made with numpy from a seed): SO(3)/SE(3) and
RigidTransform3, the closed-form 3x3 eigensolver, k-NN and normals, the
p2l GN update and inner loop, the two kernels' plain versions,
``icp_point_to_plane`` and ``run_odometry_p2l_fused``.

Tolerances:
- Geometry and the eigensolver, float64: 1e-12 on the same inputs (the
  same formulas in the same op order; libm's transcendentals may differ
  in the last ulp, which arccos' slope amplifies near pi when the inputs
  differ).
- k-NN: identical indices; distances within 2 ulp (XLA's CPU backend
  contracts the squared-difference sum into FMAs, ROADMAP.md §3).
  Normals: identical validity; 1e-12 in float64, 1e-5 in float32.
- ``weighted_gn_update_p2l`` and ``estimate_transform_p2l`` ("torch")
  against JAX ``align_backend="xla"``, float64: 1e-9.
- ``p2l_stats_plain`` against ``p2l_stats_pallas(..., interpret=True)``:
  each of the 27 sums and the error within 1e-5 of the Cauchy-Schwarz
  bound of its absolute terms (f32 sums in another order), the count
  exact, sigma within 1e-6 relative (an exact order statistic).
- ``p2l_loop_plain`` against ``estimate_transform_p2l_pallas(...,
  interpret=True)``, degenerate systems included: 1e-6, the JAX package's
  own tolerance for that kernel against its XLA loop.
- ``icp_point_to_plane`` and ``run_odometry_p2l_fused`` against JAX,
  float64 on the CPU: 1e-9.  Float32 on the kernel route (Cholesky, the
  kernels' plain versions, Morton-sorted) against the port's "torch"
  route (LU): 1e-4 in the transform and the trajectory.
"""

import dataclasses
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.geometry import se3 as j_se3
from icp_rust_tpu.geometry import so3 as j_so3
from icp_rust_tpu.geometry.transform3d import RigidTransform3 as JT
from icp_rust_tpu.models import odometry as j_odo
from icp_rust_tpu.ops import align3d as j_align3d
from icp_rust_tpu.ops import align3d_pallas as j_pallas
from icp_rust_tpu.ops import linalg as j_linalg
from icp_rust_tpu.ops import normals as j_normals
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry import se3, so3
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3 as TT
from icp_rust_tpu_torch.models import icp_p2l, odometry
from icp_rust_tpu_torch.ops import align3d, align3d_cuda, cuda_build, \
    linalg, normals

GEOM_TOL = 1e-12
F64_TOL = 1e-9
LOOP_TOL = 1e-6
STATS_TOL = 1e-5
SIGMA_TOL = 1e-6
F32_TOL = 1e-4
CPU = {"device": "cpu"}
KERNEL_CFG = ICPConfig(det_rel_eps=1e-9, nn_dst_tile=128)  # "auto" f32
j_icp_p2l = importlib.import_module("icp_rust_tpu.models.icp_p2l")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.array(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _box_cloud(n_per_face=200, seed=0):
    """Points on three orthogonal faces of a box (tests/test_p2l.py:16):
    well constrained for point-to-plane in all 6 DoF."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2, (n_per_face, 2))
    fx = np.column_stack([np.zeros(n_per_face), u])
    fy = np.column_stack([u[:, :1], np.zeros(n_per_face), u[:, 1:]])
    fz = np.column_stack([u, np.zeros(n_per_face)])
    return np.concatenate([fx, fy, fz], axis=0)


# ------------------------------------------------------------ geometry


def _axis_angles(regime, seed=0, n=16):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = {"generic": rng.uniform(0.05, 3.0, n),
             "small": np.concatenate([[0.0, 1e-9], rng.uniform(0, 1e-4,
                                                               n - 2)]),
             "near_pi": np.pi - rng.uniform(0, 5e-4, n)}[regime]
    return axis * theta[:, None]


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
def test_so3_exp_log_match_jax(regime):
    w = _axis_angles(regime)
    rot = so3.exp(torch.as_tensor(w))
    j_rot = j_so3.exp(jnp.asarray(w))
    np.testing.assert_allclose(rot.numpy(), _np(j_rot), atol=GEOM_TOL,
                               rtol=0)
    # log of the same input in both (near pi, arccos' slope 1/sin(theta)
    # would amplify exp's last-ulp differences).
    got = so3.log(_t(j_rot))
    np.testing.assert_allclose(got.numpy(), _np(j_so3.log(j_rot)),
                               atol=GEOM_TOL, rtol=0)
    if regime != "near_pi":  # the near-pi branch is approximate in both
        np.testing.assert_allclose(so3.exp(got).numpy(), rot.numpy(),
                                   atol=1e-9, rtol=0)
    np.testing.assert_array_equal(so3.vee(so3.hat(torch.as_tensor(w))), w)
    assert torch.equal(so3.identity((2,), torch.float64),
                       _t(j_so3.identity((2,), jnp.float64)))


@pytest.mark.parametrize("regime", ["generic", "small", "near_pi"])
def test_se3_exp_log_match_jax(regime):
    rng = np.random.default_rng(1)
    tw = np.concatenate([rng.uniform(-2, 2, (16, 3)), _axis_angles(regime)],
                        axis=1)
    m = se3.exp(torch.as_tensor(tw))
    j_m = j_se3.exp(jnp.asarray(tw))
    np.testing.assert_allclose(m.numpy(), _np(j_m), atol=GEOM_TOL, rtol=0)
    np.testing.assert_allclose(se3.log(_t(j_m)).numpy(), _np(j_se3.log(j_m)),
                               atol=GEOM_TOL, rtol=0)
    j_rot, j_t = j_se3.calc_rt(jnp.asarray(tw))
    rot, t = se3.calc_rt(torch.as_tensor(tw))
    np.testing.assert_allclose(rot.numpy(), _np(j_rot), atol=GEOM_TOL,
                               rtol=0)
    np.testing.assert_allclose(se3.log_rt(_t(j_rot), _t(j_t)).numpy(),
                               _np(j_se3.log_rt(j_rot, j_t)), atol=GEOM_TOL,
                               rtol=0)
    if regime != "near_pi":
        np.testing.assert_allclose(se3.log(m).numpy(), tw, atol=1e-9, rtol=0)
    w = torch.as_tensor(tw[:, 3:])
    np.testing.assert_allclose(
        (se3._v_matrix(w) @ se3._v_inverse(w)).numpy(),
        np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-9, rtol=0)
    with pytest.raises(ValueError):
        se3.calc_rt(torch.zeros(5, dtype=torch.float64))


def test_rigid_transform3_matches_jax():
    rng = np.random.default_rng(2)
    tw_a = rng.uniform(-1, 1, (4, 6))
    tw_b = rng.uniform(-1, 1, (4, 6))
    pts = rng.uniform(-3, 3, (4, 50, 3))
    a, b = TT.from_twist(torch.as_tensor(tw_a)), TT.from_twist(
        torch.as_tensor(tw_b))
    ja, jb = JT.from_twist(jnp.asarray(tw_a)), JT.from_twist(
        jnp.asarray(tw_b))
    for got, want in (
            (a.apply_points(torch.as_tensor(pts)),
             ja.apply_points(jnp.asarray(pts))),
            (a.apply(torch.as_tensor(pts[:, 0])),
             ja.apply(jnp.asarray(pts[:, 0]))),
            ((a @ b).rot, (ja @ jb).rot), ((a @ b).t, (ja @ jb).t),
            (a.inverse().rot, ja.inverse().rot),
            (a.inverse().t, ja.inverse().t), (a.log(), ja.log())):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=GEOM_TOL,
                                   rtol=0)
    ident = TT.identity((4,), torch.float64)
    assert ident.batch_shape == (4,) and ident.dtype == torch.float64
    assert torch.equal(ident.rot, _t(JT.identity((4,), jnp.float64).rot))
    assert TT.from_rt(a.rot, a.t).astype(torch.float32).dtype == \
        torch.float32
    assert a.to("cpu").device.type == "cpu"


def test_transform3_from_numpy():
    jt = JT.from_twist(jnp.asarray([0.1, -0.2, 0.3, 0.01, 0.02, -0.03]))
    t = convert.transform3_from_numpy(_np(jt.rot), _np(jt.t))
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.t.numpy(), _np(jt.t))
    with pytest.raises(ValueError):
        convert.transform3_from_numpy(np.eye(2), np.zeros(2))


# ------------------------------------------------------- eigensolver


def _sym_matrices(kind, n=40, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3, 3))
    if kind == "spd":
        return v @ v.transpose(0, 2, 1)
    if kind == "rank1":
        return v[:, :, :1] @ v[:, :, :1].transpose(0, 2, 1)
    if kind == "rank2":
        return v[:, :, :2] @ v[:, :, :2].transpose(0, 2, 1)
    scale = rng.uniform(0, 2, n)
    scale[0] = 0.0
    return scale[:, None, None] * np.eye(3)


@pytest.mark.parametrize("kind", ["spd", "rank1", "rank2", "isotropic"])
def test_sym3x3_eigh_smallest_matches_jax(kind):
    cov = _sym_matrices(kind)
    evals, vec = linalg.sym3x3_eigh_smallest(torch.as_tensor(cov))
    j_evals, j_vec = j_linalg.sym3x3_eigh_smallest(jnp.asarray(cov))
    np.testing.assert_allclose(evals.numpy(), _np(j_evals), atol=GEOM_TOL,
                               rtol=0)
    np.testing.assert_allclose(vec.numpy(), _np(j_vec), atol=GEOM_TOL,
                               rtol=0)
    # Against LAPACK: the closed form's error floor is ~sqrt(eps) of the
    # largest eigenvalue where eigenvalues repeat (rank 1).
    lam = np.linalg.eigvalsh(cov)
    err = np.abs(np.sort(evals.numpy(), axis=1) - lam)
    assert (err <= 1e-7 * np.abs(lam).max(axis=1, keepdims=True)
            + 1e-12).all()
    if kind == "isotropic":
        assert torch.equal(vec[0], torch.tensor([0.0, 0.0, 1.0],
                                                dtype=torch.float64))


# ------------------------------------------------------------ normals


DTYPES = {"f64": (np.float64, jnp.float64, torch.float64),
          "f32": (np.float32, jnp.float32, torch.float32)}


def _faces_cloud(case, dtype, n=600, seed=4):
    """Three noisy axis-aligned faces, partly masked; "far" adds points
    beyond the voxel index box (more than 1024 cells from the minimum)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 3, (n, 3))
    third = n // 3
    pts[:third, 2] = 0.0
    pts[third:2 * third, 0] = 0.0
    pts[2 * third:, 1] = 0.0
    pts += rng.normal(0, 0.002, pts.shape)
    mask = rng.random(n) > 0.1
    if case == "far":
        pts[:20] += 400.0
    return pts.astype(dtype), mask


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("tile", [128, 2048])
def test_knn_torch_matches_knn_xla(dt, tile):
    np_dt, j_dt, t_dt = DTYPES[dt]
    pts, mask = _faces_cloud("plain", np_dt, n=300)
    q = pts[:90]
    d, i = normals.knn_torch(torch.as_tensor(q), torch.as_tensor(pts), 8,
                             torch.as_tensor(mask), tile=tile)
    j_d, j_i = j_normals.knn_xla(jnp.asarray(q), jnp.asarray(pts), 8,
                                 jnp.asarray(mask), tile=tile)
    np.testing.assert_array_equal(i.numpy(), _np(j_i))
    ulp = 2 * np.finfo(np_dt).eps
    np.testing.assert_allclose(d.numpy(), _np(j_d), rtol=ulp, atol=0)
    # Fewer valid points than k: the tail is (+inf, 0), as in JAX.
    few = np.zeros(len(pts), bool)
    few[:3] = True
    d, i = normals.knn_torch(torch.as_tensor(q), torch.as_tensor(pts), 8,
                             torch.as_tensor(few), tile=tile)
    j_d, j_i = j_normals.knn_xla(jnp.asarray(q), jnp.asarray(pts), 8,
                                 jnp.asarray(few), tile=tile)
    np.testing.assert_array_equal(i.numpy(), _np(j_i))
    assert np.isinf(d.numpy()[:, 3:]).all()


def _normals_close(got, want, dt):
    (n, ok), (j_n, j_ok) = got, want
    np.testing.assert_array_equal(ok.numpy(), _np(j_ok))
    tol = GEOM_TOL if dt == "f64" else 1e-5
    np.testing.assert_allclose(n.numpy(), _np(j_n), atol=tol, rtol=0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_estimate_normals_matches_jax(dt):
    np_dt, _, _ = DTYPES[dt]
    pts, mask = _faces_cloud("plain", np_dt)
    got = normals.estimate_normals(torch.as_tensor(pts),
                                   torch.as_tensor(mask), k=8, tile=256)
    want = j_normals.estimate_normals(jnp.asarray(pts), jnp.asarray(mask),
                                      k=8, tile=256)
    _normals_close(got, want, dt)
    assert int(got[1].sum()) > 0.8 * mask.sum()


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", ["plain", "far"])
def test_estimate_normals_voxel_matches_jax(dt, case):
    np_dt, _, _ = DTYPES[dt]
    pts, mask = _faces_cloud(case, np_dt)
    got = normals.estimate_normals_voxel(torch.as_tensor(pts),
                                         torch.as_tensor(mask), 0.5)
    want = j_normals.estimate_normals_voxel(jnp.asarray(pts),
                                            jnp.asarray(mask), 0.5)
    _normals_close(got, want, dt)
    ok = got[1].numpy()
    assert ok.sum() > 0.5 * mask.sum() and not ok[~mask].any()
    if case == "far":
        assert not ok[:20].any()  # beyond the index box: invalid
    # Small capacity: points of dropped voxels are invalid in both.
    got = normals.estimate_normals_voxel(torch.as_tensor(pts),
                                         torch.as_tensor(mask), 0.5,
                                         capacity=8)
    want = j_normals.estimate_normals_voxel(jnp.asarray(pts),
                                            jnp.asarray(mask), 0.5,
                                            capacity=8)
    _normals_close(got, want, dt)


def _voxel_lanes(case, np_dt):
    """(points (..., N, 3), mask (..., N), capacity) for the batched voxel
    normals: lanes of other extents, offsets and masks; "far" puts one
    lane's first points beyond the index box; "capacity" drops voxels;
    "single" is one 2-D cloud; "grid" a (2, 3) batch."""
    rng = np.random.default_rng(11)
    n_lanes = {"single": 1, "grid": 6}.get(case, 3)
    pts, mask = [], []
    for lane in range(n_lanes):
        p, m = _faces_cloud("plain", np_dt, seed=4 + lane)
        p = p * (1.0, 0.7, 1.3, 0.85, 1.15, 1.0)[lane] + rng.uniform(-1, 1, 3)
        pts.append(p.astype(np_dt))
        mask.append(m & (rng.random(len(m)) > 0.1 * lane))
    pts, mask = np.stack(pts), np.stack(mask)
    if case == "far":
        pts[1, :20] += 600.0  # 1,200 cells from the lane's minimum
    if case == "single":
        pts, mask = pts[0], mask[0]
    elif case == "grid":
        pts, mask = pts.reshape(2, 3, *pts.shape[1:]), mask.reshape(2, 3, -1)
    return pts, mask, 8 if case == "capacity" else 1 << 15


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", ["lanes", "far", "capacity", "single",
                                  "grid"])
def test_estimate_normals_voxel_batch_is_bitwise_its_lanes(dt, case):
    """One pass over every lane: each lane bitwise the unbatched call on
    it, normals and validity; ``PASSES`` reads one pass and the batch's
    lanes; each lane still the JAX package's (``_normals_close``).

    A warm-up call comes first: in a fresh process, PyTorch's first
    multithreaded ``sqrt`` on the CPU can round one thread's chunk
    differently (seen with torch 2.13 on AVX-512, in the unbatched call
    as much as in the batched one), and this test compares bits."""
    np_dt, _, _ = DTYPES[dt]
    pts, mask, cap = _voxel_lanes(case, np_dt)
    t_pts, t_mask = torch.as_tensor(pts), torch.as_tensor(mask)
    normals.estimate_normals_voxel(t_pts, t_mask, 0.5, capacity=cap)
    normals.reset_passes()
    n_b, ok_b = normals.estimate_normals_voxel(t_pts, t_mask, 0.5,
                                               capacity=cap)
    lanes = int(np.prod(pts.shape[:-2]))
    assert normals.PASSES == {"voxel_passes": 1, "voxel_lanes": lanes}
    assert n_b.shape == t_pts.shape and ok_b.shape == t_mask.shape
    flat_p, flat_m = pts.reshape(lanes, *pts.shape[-2:]), mask.reshape(
        lanes, -1)
    n_b, ok_b = n_b.reshape(flat_p.shape), ok_b.reshape(flat_m.shape)
    for lane in range(lanes):
        p, m = torch.as_tensor(flat_p[lane]), torch.as_tensor(flat_m[lane])
        n_u, ok_u = normals.estimate_normals_voxel(p, m, 0.5, capacity=cap)
        assert torch.equal(n_b[lane], n_u), lane
        assert torch.equal(ok_b[lane], ok_u), lane
        want = j_normals.estimate_normals_voxel(
            jnp.asarray(flat_p[lane]), jnp.asarray(flat_m[lane]), 0.5,
            capacity=cap)
        _normals_close((n_b[lane], ok_b[lane]), want, dt)
    ok = ok_b.numpy()
    assert not ok[~flat_m].any() and ok.sum() > (0.05 if cap == 8 else 0.5
                                                 ) * flat_m.sum()
    if case == "far":
        assert not ok[1, :20].any()  # beyond the index box: invalid
    assert normals.PASSES["voxel_passes"] == 1 + lanes


# ------------------------------------------------------ GN and loops


def _p2l_problem(seed=5, n=256, masked=True, dtype=np.float32):
    """tests/test_p2l.py's random-normal problem: src, dst, unit normals,
    mask."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dst = src + rng.normal(0, 0.02, (n, 3)) + [0.1, -0.05, 0.03]
    mask = (rng.random(n) > 0.15) if masked else np.ones(n, bool)
    return (src.astype(dtype), dst.astype(dtype), nrm.astype(dtype), mask)


def test_weighted_gn_update_p2l_matches_jax():
    src, dst, nrm, mask = _p2l_problem(dtype=np.float64)
    tw = jnp.asarray([0.01, 0.02, -0.01, 0.01, 0.005, -0.02])
    j_upd = j_align3d.weighted_gn_update_p2l(
        JT.from_twist(tw), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(nrm), jnp.asarray(mask), 1.345)
    upd = align3d.weighted_gn_update_p2l(
        TT.from_twist(_t(tw)), torch.as_tensor(src), torch.as_tensor(dst),
        torch.as_tensor(nrm), torch.as_tensor(mask), 1.345)
    assert bool(upd.ok) and bool(j_upd.ok)
    np.testing.assert_allclose(upd.delta.numpy(), _np(j_upd.delta),
                               atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(float(upd.err), float(j_upd.err),
                               rtol=F64_TOL)
    np.testing.assert_allclose(
        float(align3d.huber_error_p2l(TT.from_twist(_t(tw)),
                                      torch.as_tensor(src),
                                      torch.as_tensor(dst),
                                      torch.as_tensor(nrm),
                                      torch.as_tensor(mask), 1.345)),
        float(j_upd.err), rtol=F64_TOL)


def test_single_plane_update_is_not_ok():
    rng = np.random.default_rng(3)
    pts = np.column_stack([rng.uniform(-1, 1, (100, 2)), np.zeros(100)])
    dst = pts + [0.0, 0.0, 0.01]
    nrm = np.broadcast_to([0.0, 0.0, 1.0], (100, 3)).copy()
    args = [torch.as_tensor(x) for x in (pts, dst, nrm)]
    upd = align3d.weighted_gn_update_p2l(
        TT.identity(dtype=torch.float64), *args,
        torch.ones(100, dtype=torch.bool), 1.345)
    j_upd = j_align3d.weighted_gn_update_p2l(
        JT.identity(dtype=jnp.float64), jnp.asarray(pts), jnp.asarray(dst),
        jnp.asarray(nrm), jnp.ones(100, bool), 1.345)
    assert not bool(upd.ok) and not bool(j_upd.ok)
    assert torch.equal(upd.delta, torch.zeros(6, dtype=torch.float64))


@pytest.mark.parametrize("seed", [5, 6])
def test_estimate_transform_p2l_matches_jax(seed):
    src, dst, nrm, mask = _p2l_problem(seed=seed, dtype=np.float64)
    j_t = j_align3d.estimate_transform_p2l(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nrm),
        jnp.asarray(mask), J_REF)
    t = align3d.estimate_transform_p2l(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(nrm),
        torch.as_tensor(mask), REFERENCE_CONFIG)
    np.testing.assert_allclose(t.rot.numpy(), _np(j_t.rot), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.t.numpy(), _np(j_t.t), atol=F64_TOL,
                               rtol=0)


def test_p2l_loop_batched_torch_route_and_kernel_route_raises():
    lanes = [_p2l_problem(seed=s, dtype=np.float64) for s in (5, 6)]
    batch = [torch.as_tensor(np.stack([lane[k] for lane in lanes]))
             for k in range(4)]
    t = align3d.estimate_transform_p2l(*batch, REFERENCE_CONFIG)
    for i, lane in enumerate(lanes):
        one = align3d.estimate_transform_p2l(
            *[torch.as_tensor(x) for x in lane], REFERENCE_CONFIG)
        np.testing.assert_allclose(t.t[i].numpy(), one.t.numpy(),
                                   atol=F64_TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="batched"):
        align3d.estimate_transform_p2l(
            *[x.to(torch.float32) if x.is_floating_point() else x
              for x in batch], KERNEL_CFG.with_(align_backend="cuda"))


def test_p2l_loop_batched_auto_route_matches_jax():
    """float32 (2, 256, 3) with the default config: "auto" takes the
    plain loop, as the JAX package's "pallas" takes its XLA loop (its
    kernel needs src.ndim == 2)."""
    lanes = [_p2l_problem(seed=s) for s in (12, 13)]
    batch = [np.stack([lane[k] for lane in lanes]) for k in range(4)]
    t = align3d.estimate_transform_p2l(
        *[torch.as_tensor(x) for x in batch], ICPConfig())
    j_t = j_align3d.estimate_transform_p2l(
        *[jnp.asarray(x) for x in batch], JaxConfig())
    assert t.rot.shape == (2, 3, 3) and t.t.shape == (2, 3)
    np.testing.assert_allclose(t.rot.numpy(), _np(j_t.rot), atol=LOOP_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.t.numpy(), _np(j_t.t), atol=LOOP_TOL,
                               rtol=0)


@pytest.mark.parametrize("masked", [True, False])
def test_p2l_stats_plain_matches_pallas_interpret(masked):
    src, dst, nrm, mask = _p2l_problem(seed=11, masked=masked)
    rot = np.eye(3, dtype=np.float32)
    t = np.array([0.1, -0.05, 0.02], np.float32)
    want = j_pallas.p2l_stats_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nrm),
        jnp.asarray(mask), jnp.asarray(rot), jnp.asarray(t), 1.345,
        interpret=True)
    got = align3d_cuda.p2l_stats(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(nrm),
        torch.as_tensor(mask), torch.as_tensor(rot), torch.as_tensor(t),
        1.345)
    rel, dn, sig_rel = align3d_cuda.stats_errors(got, _t(want))
    assert rel <= STATS_TOL and dn == 0 and sig_rel <= SIGMA_TOL
    assert float(got[28]) == mask.sum() and float(got[30]) == 0.0
    jtj, jtr, err, nf, sig = align3d_cuda.assemble_p2l(got)
    j_jtj, j_jtr, *_ = j_pallas.assemble_p2l(want)
    np.testing.assert_allclose(jtj.numpy(), _np(j_jtj), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(jtj, jtj.T) and torch.equal(jtr, got[21:27])


def test_gn_update_from_stats_matches_pallas_route():
    src, dst, nrm, mask = _p2l_problem(seed=11)
    t = np.array([0.1, -0.05, 0.02], np.float32)
    j_upd = j_align3d.weighted_gn_update_p2l_pallas(
        JT(jnp.eye(3, dtype=jnp.float32), jnp.asarray(t)), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(nrm), jnp.asarray(mask), 1.345,
        interpret=True)
    upd = align3d.weighted_gn_update_p2l_cuda(
        TT(torch.eye(3), torch.as_tensor(t)), torch.as_tensor(src),
        torch.as_tensor(dst), torch.as_tensor(nrm), torch.as_tensor(mask),
        1.345)
    assert bool(upd.ok) and bool(j_upd.ok)
    np.testing.assert_allclose(upd.delta.numpy(), _np(j_upd.delta),
                               atol=LOOP_TOL, rtol=0)
    np.testing.assert_allclose(float(upd.err), float(j_upd.err), rtol=1e-5)


def _degenerate(case, src, dst, nrm, mask):
    if case == "one-plane":
        nrm = np.broadcast_to(np.float32([0, 0, 1]), src.shape).copy()
        dst = src.copy()
        dst[:, 2] += np.float32(0.01) + np.linspace(
            0, 0.01, len(src), dtype=np.float32)
    elif case == "five-points":
        mask = np.zeros_like(mask)
        mask[:5] = True
    elif case == "sigma-0":
        dst = src.copy()
    elif case == "all-masked":
        mask = np.zeros_like(mask)
    return src, dst, nrm, mask


@pytest.mark.parametrize("case", ["generic", "one-plane", "five-points",
                                  "sigma-0", "all-masked"])
def test_p2l_loop_plain_matches_pallas_interpret(case):
    src, dst, nrm, mask = _degenerate(case, *_p2l_problem())
    cfg = JaxConfig(compute_dtype=jnp.float32)
    solver = (cfg.huber_k, cfg.inner_delta_sq_tol, cfg.inner_max_iter, 1.0)
    j_rot, j_t = j_pallas.estimate_transform_p2l_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nrm),
        jnp.asarray(mask), *solver, interpret=True)
    rot, t, it = align3d_cuda.p2l_loop(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(nrm),
        torch.as_tensor(mask), *solver)
    np.testing.assert_allclose(rot.numpy(), _np(j_rot), atol=LOOP_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.numpy(), _np(j_t), atol=LOOP_TOL, rtol=0)
    if case == "generic":
        assert int(it) > 1
    else:
        assert int(it) == 1
        assert torch.equal(rot, torch.eye(3)) and torch.equal(
            t, torch.zeros(3))


def test_p2l_kernel_route_wrappers_refuse_other_devices():
    src, dst, nrm, mask = [torch.as_tensor(x) for x in _p2l_problem()]
    meta = [x.to("meta") for x in (src, dst, nrm, mask)]
    with pytest.raises(ValueError, match="unsupported device"):
        align3d_cuda.p2l_loop(*meta, 1.345, 1e-6, 200, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        align3d_cuda.p2l_stats(*meta, torch.eye(3), torch.zeros(3), 1.345)
    assert "p2l.cuh" in cuda_build.HEADERS
    for name in ("p2l_loop", "p2l_stats"):
        assert name in cuda_build.SOURCES and name in cuda_build._SIGNATURES


# ----------------------------------------------- icp_point_to_plane


def _box_pair(seed=4, noise=5e-4):
    pts = _box_cloud()
    rng = np.random.default_rng(seed)
    tw = jnp.asarray([0.03, -0.02, 0.025, 0.015, -0.01, 0.02])
    dst = _np(JT.from_twist(tw).apply_points(jnp.asarray(pts)))
    return pts, dst + rng.normal(0, noise, pts.shape), np.ones(len(pts), bool)


def test_payload_build_and_decode_match_jax():
    rng = np.random.default_rng(8)
    dst = rng.uniform(-2, 2, (50, 3))
    nrm = rng.normal(size=(50, 3))
    valid, mask = rng.random(50) > 0.3, rng.random(50) > 0.2
    pay = icp_p2l.build_p2l_payload(*[torch.as_tensor(x) for x in
                                      (dst, nrm, valid, mask)])
    j_pay = j_icp_p2l.build_p2l_payload(jnp.asarray(dst), jnp.asarray(nrm),
                                        jnp.asarray(valid),
                                        jnp.asarray(mask), jnp.float64)
    np.testing.assert_array_equal(pay.numpy(), _np(j_pay))
    dist = np.where(rng.random(50) > 0.1, 1.0, np.inf)
    for got, want in zip(
            icp_p2l.decode_p2l_payload(pay, torch.as_tensor(dist)),
            j_icp_p2l.decode_p2l_payload(j_pay, jnp.asarray(dist))):
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("method", ["voxel", "knn"])
def test_icp_point_to_plane_float64_matches_jax(method):
    src, dst, mask = _box_pair()
    t, st = icp_p2l.icp_point_to_plane(
        src, dst, mask, mask, TT.identity(dtype=torch.float64),
        REFERENCE_CONFIG, normals_method=method, return_stats=True, **CPU)
    j_t, j_st = j_icp_p2l.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(mask), JT.identity(dtype=jnp.float64), J_REF,
        normals_method=method, return_stats=True)
    np.testing.assert_allclose(t.rot.numpy(), _np(j_t.rot), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.t.numpy(), _np(j_t.t), atol=F64_TOL,
                               rtol=0)
    assert int(st.outer_iters) == int(j_st.outer_iters)
    for f in ("huber_error", "mean_nn_dist", "inlier_fraction"):
        np.testing.assert_allclose(float(getattr(st, f)),
                                   float(getattr(j_st, f)), rtol=F64_TOL,
                                   atol=1e-15)


def test_icp_point_to_plane_dst_normals_and_scale_match_jax():
    src, dst, mask = _box_pair(seed=6)
    j_n, _ = j_normals.estimate_normals(jnp.asarray(dst), jnp.asarray(mask))
    cfg = REFERENCE_CONFIG.with_(point_scale=2.5)
    j_cfg = dataclasses.replace(J_REF, point_scale=2.5)
    warm = TT.from_twist(torch.tensor([0.01, 0, 0, 0, 0, 0.005],
                                      dtype=torch.float64))
    t = icp_p2l.icp_point_to_plane(src, dst, mask, mask, warm, cfg,
                                   dst_normals=_np(j_n), **CPU)
    j_t = j_icp_p2l.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(mask), JT(jnp.asarray(warm.rot.numpy()),
                              jnp.asarray(warm.t.numpy())), j_cfg,
        dst_normals=j_n)
    np.testing.assert_allclose(t.t.numpy(), _np(j_t.t), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.rot.numpy(), _np(j_t.rot), atol=F64_TOL,
                               rtol=0)


@pytest.mark.parametrize("method", ["voxel", "knn"])
def test_icp_point_to_plane_kernel_route_tracks_torch_route(method):
    src, dst, mask = _box_pair()
    ident = TT.identity()
    t = icp_p2l.icp_point_to_plane(src, dst, mask, mask, ident, KERNEL_CFG,
                                   normals_method=method, **CPU)
    t_plain = icp_p2l.icp_point_to_plane(
        src, dst, mask, mask, ident,
        KERNEL_CFG.with_(nn_backend="torch", align_backend="torch"),
        normals_method=method, **CPU)
    np.testing.assert_allclose(t.t.numpy(), t_plain.t.numpy(), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.rot.numpy(), t_plain.rot.numpy(),
                               atol=F32_TOL, rtol=0)
    # The recovered motion: the JAX package's own accuracy gate.
    j_t = JT.from_twist(jnp.asarray([0.03, -0.02, 0.025, 0.015, -0.01,
                                     0.02]))
    err = np.linalg.norm(t.apply_points(torch.as_tensor(src, dtype=torch.
                                                        float32)).numpy()
                         - _np(j_t.apply_points(jnp.asarray(src))), axis=1)
    assert err.max() < 5e-3


def test_icp_point_to_plane_refuses_batches_and_bad_methods():
    """A batch now runs (tests/test_torch_p2l_batched.py holds it against
    the JAX package): two copies of one pair give that pair's transform
    twice.  Bad normals methods and mismatched batch axes still raise."""
    src, dst, mask = _box_pair()
    ident = TT.identity(dtype=torch.float64)
    t = icp_p2l.icp_point_to_plane(np.stack([src, src]), np.stack([dst, dst]),
                                   np.stack([mask, mask]),
                                   np.stack([mask, mask]), ident,
                                   REFERENCE_CONFIG, **CPU)
    t1 = icp_p2l.icp_point_to_plane(src, dst, mask, mask, ident,
                                    REFERENCE_CONFIG, **CPU)
    assert t.t.shape == (2, 3)
    for i in range(2):
        np.testing.assert_allclose(t.t[i].numpy(), t1.t.numpy(),
                                   atol=GEOM_TOL, rtol=0)
    with pytest.raises(ValueError, match="same batch axes"):
        icp_p2l.icp_point_to_plane(np.stack([src, src]), dst,
                                   np.stack([mask, mask]), mask, ident,
                                   REFERENCE_CONFIG, **CPU)
    with pytest.raises(ValueError, match="normals_method"):
        icp_p2l.icp_point_to_plane(src, dst, mask, mask, ident,
                                   REFERENCE_CONFIG, normals_method="pca",
                                   **CPU)


def _box_frames():
    """tests/test_p2l.py:242-252's four box frames."""
    rng = np.random.default_rng(11)
    base = _box_cloud(120, seed=3)
    frames = []
    for i in range(4):
        th = 0.02 * i
        c, s = np.cos(th), np.sin(th)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t = np.array([0.03 * i, -0.02 * i, 0.0])
        frames.append(base @ r.T + t + rng.normal(0, 0.002, base.shape))
    pts = np.stack(frames).astype(np.float64)
    return pts, np.ones(pts.shape[:2], bool)


def test_run_odometry_p2l_fused_matches_jax():
    pts, msk = _box_frames()
    tf, path, st = odometry.run_odometry_p2l_fused(
        pts, msk, REFERENCE_CONFIG, normals_voxel_size=0.5,
        with_metrics=True, **CPU)
    j_tf, j_path = j_odo.run_odometry_p2l_fused(pts, msk, J_REF,
                                                normals_voxel_size=0.5)
    assert tf.rot.shape == (3, 3, 3) and path.shape == (3, 3)
    np.testing.assert_allclose(path, j_path, atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(tf.rot.numpy(), _np(j_tf.rot), atol=F64_TOL,
                               rtol=0)
    assert st.outer_iters.shape == (3,) and (st.outer_iters >= 1).all()


def test_run_odometry_p2l_fused_kernel_route_tracks_torch_route():
    pts, msk = _box_frames()
    pts = pts.astype(np.float32)
    _, path = odometry.run_odometry_p2l_fused(pts, msk, KERNEL_CFG, 0.5,
                                              **CPU)
    _, plain = odometry.run_odometry_p2l_fused(
        pts, msk, KERNEL_CFG.with_(nn_backend="torch", align_backend="torch"),
        0.5, **CPU)
    assert odometry.ate_rmse(path, plain) < F32_TOL
    j_cfg = JaxConfig(compute_dtype=jnp.float32, det_rel_eps=1e-9,
                      nn_dst_tile=128)
    _, j_path = j_odo.run_odometry_p2l_fused(pts, msk, j_cfg,
                                             normals_voxel_size=0.5)
    assert odometry.ate_rmse(path, j_path) < F32_TOL


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(ROOT)
    return mod


def test_chip_smoke_p2l_phases_rehearse_on_cpu(chip_smoke, capsys):
    """chip_smoke.py's phases 10-13 at a tiny size on the CPU, where every
    wrapper takes its kernel's plain version."""
    recs = [chip_smoke.phase_nn_list_p2l("cpu", stride=24, tile=256,
                                         q_tile=64),
            chip_smoke.phase_p2l_loop("cpu", stride=24),
            chip_smoke.phase_p2l_stats("cpu", stride=24)]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0  # the same code on the CPU
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    run = chip_smoke.phase_p2l("cpu", n_frames=3, stride=12, plain_frames=3,
                               tile=512, voxel=0.6)
    assert run["ate"] < chip_smoke.ATE_GATE_M
    assert run["z_max"] < chip_smoke.P2L_Z_GATE_M
    out = capsys.readouterr().out
    assert "stop at iteration 1 with the identity" in out
    assert "bitwise equal to the first run" in out
