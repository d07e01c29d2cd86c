"""The port's ``nn_method="mxu"`` against the JAX package: ``nn_torch``'s
|q|^2 + |d|^2 - 2 q.d sweep against ``nn_xla(method="mxu")``, the NN
routes (backend x method x dtype) against ``use_pallas_nn`` /
``use_pairs_nn``, the config and ``convert`` rules, and ``icp2d`` and
``icp_point_to_plane`` with "mxu".

Tolerances:
- float32: equal indices on seeded data whose nearest neighbours are well
  separated, and distances within 4 ulp of |q|^2 + |d|^2 (the cancelling
  sum's scale: the matmuls round the cross term in another order);
- float64: distances within 1e-12 of that scale, equal indices;
- the drivers, float64: 1e-9, as the direct method's parity tests.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.geometry.transform2d import RigidTransform2 as J2
from icp_rust_tpu.geometry.transform3d import RigidTransform3 as J3
from icp_rust_tpu.models import icp_p2l as j_icp_p2l
from icp_rust_tpu.ops import nn as j_nn
from icp_rust_tpu.ops import nn_pallas as j_pallas
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2 as T2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3 as T3
from icp_rust_tpu_torch.models import icp2d, icp_p2l
from icp_rust_tpu_torch.ops import nn

F64_TOL = 1e-9
CPU = {"device": "cpu"}
j_icp2d = importlib.import_module("icp_rust_tpu.models.icp2d")


def _separated(d, batch=(), n=300, m=700, seed=0, dtype=np.float32):
    """db points on a jittered grid of 0.25 m, queries within 0.05 m of a
    db point: every query's nearest neighbour is unique by a wide margin.
    A masked tenth of the db."""
    rng = np.random.default_rng(seed + d)
    side = int(np.ceil(m ** (1 / d))) + 1
    grid = np.stack(np.meshgrid(*[np.arange(side)] * d, indexing="ij"),
                    -1).reshape(-1, d)[:m] * 0.25 - 1.5
    db = np.broadcast_to(grid, (*batch, m, d)) \
        + rng.uniform(-0.02, 0.02, (*batch, m, d))
    dm = rng.random((*batch, m)) > 0.1
    pick = rng.integers(0, m, (*batch, n))
    q = np.take_along_axis(db, pick[..., None], axis=-2) \
        + rng.uniform(-0.05, 0.05, (*batch, n, d))
    return q.astype(dtype), db.astype(dtype), dm


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nn_torch_mxu_matches_nn_xla_mxu(dtype, d, batch):
    q, db, dm = _separated(d, batch, dtype=dtype)
    want = j_nn.nn_xla(jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm),
                       tile=256, method="mxu")
    got = nn.nn_torch(torch.as_tensor(q), torch.as_tensor(db),
                      torch.as_tensor(dm), tile=256, method="mxu")
    direct = nn.nn_torch(torch.as_tensor(q), torch.as_tensor(db),
                         torch.as_tensor(dm), tile=256)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got.index.numpy(), direct.index.numpy())
    nn_pts = np.take_along_axis(db, got.index.numpy()[..., None].astype(
        np.int64), axis=-2)
    scale = np.sum(q * q, -1) + np.sum(nn_pts * nn_pts, -1)
    eps = np.finfo(dtype).eps
    tol = 4 * eps * scale if dtype == np.float32 else 1e-12 * scale
    assert np.all(np.abs(got.dist_sq.numpy() - np.array(want.dist_sq))
                  <= tol)


def test_nn_torch_mxu_shared_db_and_all_masked():
    q, db, dm = _separated(3, (2,))
    got = nn.nn_torch(torch.as_tensor(q), torch.as_tensor(db[0]),
                      torch.as_tensor(dm[0]), method="mxu")
    want = nn.nn_torch(torch.as_tensor(q), torch.as_tensor(
        np.broadcast_to(db[0], db.shape).copy()), torch.as_tensor(
        np.broadcast_to(dm[0], dm.shape).copy()), method="mxu")
    assert torch.equal(got.index, want.index)
    none = nn.nn_torch(torch.as_tensor(q[0]), torch.as_tensor(db[0]),
                       torch.zeros(db.shape[1], dtype=torch.bool),
                       method="mxu")
    assert torch.isinf(none.dist_sq).all() and (none.index == 0).all()
    with pytest.raises(ValueError, match="nn method"):
        nn.nn_torch(torch.as_tensor(q[0]), torch.as_tensor(db[0]),
                    method="pca")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("method", ["direct", "mxu"])
@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_nn_routes_follow_jax(monkeypatch, backend, method, dtype):
    """The kernel route and the pair-grid route as the JAX package picks
    them on its accelerator (``nn_pallas.available`` True): "cuda" is
    JAX's "pairs" for a batch of dbs of at most 4,096 points and its
    "pallas" otherwise.  The one difference is by design: float64 on
    "cuda" runs the kernels' plain versions here, where compiled Mosaic
    refuses float64."""
    monkeypatch.setattr(j_pallas, "available", lambda: True)
    for sq, sdb in (((1000, 3), (30000, 3)), ((4, 300, 3), (4, 420, 3)),
                    ((4, 300, 3), (4, 5000, 3))):
        q = torch.zeros(sq, dtype=getattr(torch, dtype))
        db = torch.zeros(sdb, dtype=getattr(torch, dtype))
        jq = jnp.zeros(sq, dtype)
        jdb = jnp.zeros(sdb, dtype)
        small = len(sq) == 3 and sdb[-2] <= 4096
        jb = {"auto": "auto", "torch": "xla",
              "cuda": "pairs" if small else "pallas"}[backend]
        j_pairs = j_nn.use_pairs_nn(jq, jdb, jb, method)
        j_kernel = j_pairs or j_nn.use_pallas_nn(jq, jdb, jb, method)
        route = nn.route(q, db, sdb[-1], ICPConfig(nn_backend=backend,
                                                   nn_method=method))
        kernel, pairs = route.kind != "torch", route.kind == "pairs"
        if dtype == "float64" and backend == "cuda":
            assert kernel and not j_kernel
            assert pairs == small
            continue
        assert kernel == j_kernel, (sq, sdb)
        assert pairs == j_pairs, (sq, sdb)
        j_pack = j_nn.build_db_pack(jq, jdb, backend=jb, method=method)
        assert route.pack == (j_pack is not None), (sq, sdb)


def test_matched_and_unmatched_routes_take_mxu(monkeypatch):
    """"auto" with "mxu" takes ``nn_torch(method="mxu")`` on the tensor's
    device; an explicit "cuda" takes the direct kernels."""
    seen = []
    real = nn.nn_torch

    def spy(*args, **kw):
        seen.append(kw.get("method"))
        return real(*args, **kw)
    monkeypatch.setattr(nn, "nn_torch", spy)
    q, db, dm = _separated(3)
    args = (torch.as_tensor(q), torch.as_tensor(db), torch.as_tensor(dm))
    res, pay = nn.nearest_neighbor_matched(*args, method="mxu")
    assert seen == ["mxu"]
    assert torch.equal(pay, args[1][res.index.long()])
    nn.nearest_neighbor(*args, method="mxu")
    assert seen == ["mxu", "mxu"]
    direct, _ = nn.nearest_neighbor_matched(*args, backend="cuda",
                                            method="mxu")
    assert seen == ["mxu", "mxu"] and torch.equal(direct.index, res.index)


def test_config_and_convert_take_mxu():
    assert ICPConfig(nn_method="mxu").nn_method == "mxu"
    with pytest.raises(ValueError, match="nn_method"):
        ICPConfig(nn_method="bf16")
    fields = dataclasses.asdict(dataclasses.replace(J_REF, nn_method="mxu"))
    cfg = convert.config_from_fields(fields)
    assert cfg.nn_method == "mxu" and cfg.compute_dtype == torch.float64


def _scan_pair(seed=3, n=300):
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 2.0 + 0.3 * np.sin(5 * a)
    src = np.column_stack([r * np.cos(a), r * np.sin(a)])
    th, t = 0.05, np.array([0.08, -0.05])
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    dst = src @ rot.T + t + rng.normal(0, 0.003, src.shape)
    return src, dst, np.ones(n, bool)


def test_icp2d_mxu_float64_matches_jax():
    src, dst, mask = _scan_pair()
    cfg = REFERENCE_CONFIG.with_(nn_method="mxu")
    t = icp2d.icp2d(src, dst, mask, mask, T2.identity(dtype=torch.float64),
                    cfg, **CPU)
    j_t = j_icp2d.icp2d(jnp.asarray(src), jnp.asarray(dst),
                        jnp.asarray(mask), jnp.asarray(mask),
                        J2.identity(dtype=jnp.float64),
                        dataclasses.replace(J_REF, nn_method="mxu"))
    np.testing.assert_allclose(t.t.numpy(), np.array(j_t.t), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.rot.numpy(), np.array(j_t.rot),
                               atol=F64_TOL, rtol=0)


def test_icp_point_to_plane_mxu_float64_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 2, (128, 2))
    z = np.zeros(128)
    src = np.concatenate([np.column_stack([z, u]),
                          np.column_stack([u[:, :1], z, u[:, 1:]]),
                          np.column_stack([u, z])])
    tw = jnp.asarray([0.03, -0.02, 0.025, 0.015, -0.01, 0.02])
    dst = np.array(J3.from_twist(tw).apply_points(jnp.asarray(src))) \
        + rng.normal(0, 5e-4, src.shape)
    mask = np.ones(len(src), bool)
    t, st = icp_p2l.icp_point_to_plane(
        src, dst, mask, mask, T3.identity(dtype=torch.float64),
        REFERENCE_CONFIG.with_(nn_method="mxu"), return_stats=True, **CPU)
    j_t, j_st = j_icp_p2l.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
        jnp.asarray(mask), J3.identity(dtype=jnp.float64),
        dataclasses.replace(J_REF, nn_method="mxu"), return_stats=True)
    np.testing.assert_allclose(t.t.numpy(), np.array(j_t.t), atol=F64_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.rot.numpy(), np.array(j_t.rot),
                               atol=F64_TOL, rtol=0)
    assert int(st.outer_iters) == int(j_st.outer_iters)
