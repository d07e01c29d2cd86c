"""The port's batched multi-pair path against the JAX package, on the same
inputs: the pair-grid NN, the batched IRLS loop, the pair-frame loop, the
batched drivers and ``parallel.sharded.batched_icp2d``.

Tolerances:
- Pair-grid NN (the plain versions of nn_pairs / nn_pairs_list, reached
  through ``nearest_neighbor_matched`` on the kernel route) against
  ``nn_pallas_matched_pairs(..., interpret=True)``: identical indices and
  payload; float32 distances within D - 1 ulp, because XLA's CPU backend
  contracts each add of the squared-difference sum into an FMA where
  torch rounds every op (ROADMAP.md §3).
- irls_loop_batched's plain version against
  ``estimate_transform_pallas_batched(..., interpret=True)``: 1e-6, the
  JAX package's own tolerance for that kernel against its XLA loop.
- icp2d_frame_pairs' plain version against JAX ``icp2d`` with
  ``frame_backend="interpret"`` on a batch: 1e-5, the JAX package's own
  tolerance for the pair-frame kernel against its lockstep driver.
- Batched drivers, float32: 1e-5 against the JAX batched drivers and
  against the port's own unbatched call per pair (f32 roundoff of sums
  taken in another order, over a Morton-sorted point axis on the kernel
  route).  Float64 batched ``icp2d`` against JAX float64: 1e-9.
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
from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT
from icp_rust_tpu.ops import align2d_pallas as j_align_pallas
from icp_rust_tpu.ops import nn as j_nn
from icp_rust_tpu.ops import nn_pallas as j_pallas
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2 as TT
from icp_rust_tpu_torch.models import icp2d as m
from icp_rust_tpu_torch.ops import align2d_cuda, nn, nn_pairs_cuda
from icp_rust_tpu_torch.parallel import batched_icp2d

IRLS_TOL = 1e-6
FRAME_TOL = 1e-5
F32_TOL = 1e-5
F64_TOL = 1e-9
CPU = {"device": "cpu"}
KERNEL_CFG = ICPConfig(det_rel_eps=1e-9)  # "auto" f32: the kernel route
PLAIN_CFG = KERNEL_CFG.with_(nn_backend="torch", align_backend="torch",
                             frame_backend="off")
J_CFG = JaxConfig(det_rel_eps=1e-9)
j_icp = importlib.import_module("icp_rust_tpu.models.icp2d")


def _t(x):
    return torch.as_tensor(np.array(x))


# --------------------------------------------------------------- NN


def _nn_case(case, d, b=4, n=300, m=420, seed=0):
    """Queries, Morton-sorted dbs, masks and an xy payload per pair."""
    rng = np.random.default_rng(seed + d)
    q = rng.uniform(-3, 3, (b, n, d)).astype(np.float32)
    db = rng.uniform(-3, 3, (b, m, d)).astype(np.float32)
    dm = np.ones((b, m), bool)
    if case == "masked":
        dm = rng.random((b, m)) > 0.3
        dm[1] = False  # one pair with no valid db point
    if case == "ties":
        half = m // 2
        db[:, half:2 * half] = db[:, :half]  # every point twice
        q[:, :half] = db[:, :half]
    for i in range(b):
        order = np.array(j_nn.morton_order(jnp.asarray(db[i]),
                                           jnp.asarray(dm[i])))
        db[i], dm[i] = db[i][order], dm[i][order]
    return q, db, dm, db[..., :2].copy()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", ["cold", "warm", "masked", "ties"])
def test_pairs_nn_matches_jax_interpret(case, d):
    q, db, dm, pay = _nn_case(case, d)
    jargs = (jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm))
    base, _ = j_pallas.nn_pallas_matched_pairs(
        *jargs, payload=jnp.asarray(pay), interpret=True)
    qb = None
    if case == "warm":
        # The warm bound of one outer step: last distances, moved queries.
        rng = np.random.default_rng(7)
        q2 = q + rng.normal(0, 0.05, q.shape).astype(np.float32)
        move = np.linalg.norm(q2 - q, axis=-1)
        qb = ((np.sqrt(np.array(base.dist_sq)) + move) ** 2
              * np.float32(1 + 32 * np.finfo(np.float32).eps))
        q = q2
        jargs = (jnp.asarray(q),) + jargs[1:]
    want, want_p = j_pallas.nn_pallas_matched_pairs(
        *jargs, payload=jnp.asarray(pay),
        q_bound=None if qb is None else jnp.asarray(qb), interpret=True)
    assert nn.use_pairs_nn(_t(q), _t(db), "cuda")
    got, got_p = nn.nearest_neighbor_matched(
        _t(q), _t(db), _t(dm), payload=_t(pay), backend="cuda",
        q_bound=None if qb is None else _t(qb))
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    np.testing.assert_array_max_ulp(got.dist_sq.numpy(),
                                    np.array(want.dist_sq),
                                    maxulp=max(d - 1, 1))
    brute = nn.nn_torch(_t(q), _t(db), _t(dm))
    np.testing.assert_array_equal(got.index.numpy(), brute.index.numpy())
    assert torch.equal(got.dist_sq, brute.dist_sq)
    if case == "masked":
        assert torch.isinf(got.dist_sq[1]).all()
        assert (got.index[1] == 0).all() and (got_p[1] == 0).all()
    if case == "ties":
        assert (got.dist_sq[:, :210] == 0).all()


def test_static_and_list_walks_are_bitwise_equal():
    """The two plain kernels on the same warm inputs: identical results,
    and the lists walk fewer chunks than the static sweep's +inf cold."""
    q, db, dm, pay = _nn_case("masked", 2, b=3, n=384, m=512)
    qt, dbt = _t(q), _t(db)
    dbf = nn_pairs_cuda.pack_pairs(dbt, _t(dm), _t(pay))
    cbox = nn_pairs_cuda._chunk_boxes(dbf, 2)
    brute = nn.nn_torch(qt, dbt, _t(dm))
    qb = brute.dist_sq * (1.0 + 32.0 * float(np.finfo(np.float32).eps))
    lists, cnt = nn_pairs_cuda._survivor_lists(qt, cbox, qb, 2, 128, 64)
    assert lists.shape == (3, 3, 4) and lists.dtype == torch.int32
    for row, c in zip(lists.reshape(-1, 4).numpy(), cnt.reshape(-1).numpy()):
        assert (np.diff(row[:c]) > 0).all() and (row[c:] == row[0]).all()
    assert int(cnt.sum()) < cnt.numel() * 4
    a = nn_pairs_cuda.nn_pairs_list(qt, dbf, lists, cnt, 2, 128)
    s = nn_pairs_cuda.nn_pairs(
        qt, dbf, nn_pairs_cuda._query_boxes(qt, 128), cbox,
        nn_pairs_cuda._group_bounds(qb, 128), 2, 128)
    for x, y in zip(a, s):
        assert torch.equal(x, y)


def test_pairs_nn_shared_db_and_float64():
    q, db, dm, _ = _nn_case("cold", 3, b=3)
    got, got_p = nn.nearest_neighbor_matched(
        _t(q), _t(db[0]), _t(dm[0]), backend="cuda")
    want, want_p = nn.nearest_neighbor_matched(
        _t(q), _t(np.broadcast_to(db[0], db.shape)),
        _t(np.broadcast_to(dm[0], dm.shape)), backend="cuda")
    assert torch.equal(got.index, want.index) and torch.equal(got_p, want_p)
    # float64 on the kernel route runs the plain version in float64.
    g64, _ = nn.nearest_neighbor_matched(_t(q).double(), _t(db).double(),
                                         _t(dm), backend="cuda")
    b64 = nn.nn_torch(_t(q).double(), _t(db).double(), _t(dm))
    assert torch.equal(g64.index, b64.index)
    assert torch.equal(g64.dist_sq, b64.dist_sq)


def test_batched_kernel_route_refuses_large_dbs():
    q = torch.zeros((2, 256, 2))
    assert not nn.use_pairs_nn(q, torch.zeros((2, 4097, 2)), "cuda")
    assert nn.use_pairs_nn(q, torch.zeros((2, 4096, 2)), "cuda")
    assert not nn.use_pairs_nn(q, torch.zeros((2, 512, 2)), "torch")
    assert not nn.use_pairs_nn(q.double(), torch.zeros((2, 512, 2)), "auto")
    # Larger dbs leave the pair-grid route for the plain sweep with the
    # batch as a grid axis (kernel 4), as nn_pallas_matched vmaps it.
    rng = np.random.default_rng(12)
    qs = _t(rng.uniform(-3, 3, (2, 256, 2)).astype(np.float32))
    db = _t(rng.uniform(-3, 3, (2, 4097, 2)).astype(np.float32))
    got, got_p = nn.nearest_neighbor_matched(qs, db, backend="cuda",
                                             q_bound=torch.zeros(2, 256))
    want = nn.nn_torch(qs, db)
    assert torch.equal(got.index, want.index)
    assert torch.equal(got.dist_sq, want.dist_sq)
    assert torch.equal(got_p, torch.take_along_dim(
        db, want.index[..., None].long(), dim=1))
    assert nn.build_db_pack(q, torch.zeros((2, 8192, 2)),
                            backend="cuda") is None
    assert nn.build_db_pack(q, torch.zeros((2, 512, 2)),
                            backend="cuda") is None


# --------------------------------------------------------------- IRLS


def _irls_batch(b=5, n=384, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (b, n, 2)).astype(np.float32)
    th = rng.uniform(-0.15, 0.15, b)
    rot = np.stack([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    rot = rot.transpose(2, 0, 1).astype(np.float32)
    dst = np.einsum("bij,bnj->bni", rot, src) + rng.uniform(
        -0.2, 0.2, (b, 1, 2)).astype(np.float32)
    dst = (dst + rng.normal(0, 0.02, dst.shape)).astype(np.float32)
    dst[:, ::17] += np.float32(2.0)  # outliers exercise the Huber branch
    mask = rng.random((b, n)) > 0.15
    mask[3] = False  # an all-masked pair
    mask[4] = False
    mask[4, 7] = True  # a pair with one valid point
    return src, dst, mask


def test_irls_batched_plain_matches_pallas_interpret():
    src, dst, mask = _irls_batch()
    cfg = KERNEL_CFG
    args = (cfg.huber_k, cfg.det_rel_eps, cfg.inner_delta_sq_tol,
            cfg.inner_max_iter, cfg.point_scale)
    rot, t, its = align2d_cuda.irls_loop_batched(_t(src), _t(dst), _t(mask),
                                                 *args)
    jrot, jt = j_align_pallas.estimate_transform_pallas_batched(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), *args,
        interpret=True)
    np.testing.assert_allclose(rot.numpy(), np.array(jrot), atol=IRLS_TOL,
                               rtol=0)
    np.testing.assert_allclose(t.numpy(), np.array(jt), atol=IRLS_TOL,
                               rtol=0)
    # All-masked and one-point pairs stop at iteration 1 with the identity.
    for i in (3, 4):
        assert int(its[i]) == 1
        assert torch.equal(rot[i], torch.eye(2))
        assert torch.equal(t[i], torch.zeros(2))
    assert (its[:3] > 1).all()
    # Each lane as its own unbatched loop: bitwise the same transform and
    # iteration count (a done lane freezes).
    for i in range(5):
        r1, t1, it1 = align2d_cuda.irls_loop(_t(src[i]), _t(dst[i]),
                                             _t(mask[i]), *args)
        assert torch.equal(r1, rot[i]) and torch.equal(t1, t[i])
        assert it1 == int(its[i])


# --------------------------------------------------------------- frames


def _pairs2d(b=3, n=300, m=330, pad_n=384, pad_m=384, dim=2, seed=0,
             dtype=np.float32):
    """B synthetic pairs: dst = T_i(src points) + noise, T_i per pair."""
    rng = np.random.default_rng(seed)
    src = np.zeros((b, pad_n, dim))
    dst = np.zeros((b, pad_m, dim))
    sm = np.zeros((b, pad_n), bool)
    dm = np.zeros((b, pad_m), bool)
    for i in range(b):
        base = rng.uniform(-4, 4, (max(n, m), dim))
        if dim == 3:
            base[:, 2] = rng.uniform(0.2, 1.8, len(base))
        th = rng.uniform(-0.06, 0.06)
        c, s = np.cos(th), np.sin(th)
        moved = base.copy()
        moved[:, :2] = base[:, :2] @ np.array([[c, -s], [s, c]]).T \
            + rng.uniform(-0.1, 0.1, 2)
        moved += rng.normal(0, 0.005, moved.shape)
        src[i, :n] = base[:n]
        dst[i, :m] = moved[rng.permutation(len(moved))[:m]]
        sm[i, :n] = True
        dm[i, :m] = True
    return src.astype(dtype), dst.astype(dtype), sm, dm


def test_frame_pairs_plain_matches_jax_interpret():
    sp, dp, sm, dm = _pairs2d(n=320, m=300)
    sm[1, ::5] = False
    dm[2, ::7] = False
    b = sp.shape[0]
    got = m.icp2d(sp, dp, sm, dm, TT.identity((b,)),
                  KERNEL_CFG.with_(frame_backend="pairs"), **CPU)
    jcfg = J_CFG.with_(frame_backend="interpret")
    want = j_icp.icp2d(jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm),
                       jnp.asarray(dm), JT.identity((b,), jnp.float32), jcfg)
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=FRAME_TOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=FRAME_TOL, rtol=0)
    # Per-pair outer iterations: each pair to its own fixed point.
    _, _, j_its = j_align_pallas.icp2d_frame_pallas_pairs(
        jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm), jnp.asarray(dm),
        jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (b, 2, 2)),
        jnp.zeros((b, 2), jnp.float32), huber_k=jcfg.huber_k,
        det_rel_eps=jcfg.det_rel_eps, tol_d2=jcfg.inner_delta_sq_tol,
        inner_max_iter=jcfg.inner_max_iter, outer_iters=jcfg.outer_iters,
        point_scale=1.0, interpret=True)
    _, _, its = align2d_cuda.icp2d_frame_pairs(
        _t(sp), _t(dp), _t(sm), _t(dm), TT.identity((b,)), KERNEL_CFG)
    np.testing.assert_array_equal(its.numpy(), np.array(j_its))


def test_frame_gate_kinds():
    s = torch.zeros((3, 384, 2))
    assert m._use_frame_kernel(s, s, KERNEL_CFG, False) is None  # "auto"
    pairs = KERNEL_CFG.with_(frame_backend="pairs")
    assert m._use_frame_kernel(s, s, pairs, False) == "pairs"
    assert m._use_frame_kernel(s[0], s[0], pairs, False) == "single"
    assert m._use_frame_kernel(s[0], s[0], KERNEL_CFG, False) == "single"
    assert m._use_frame_kernel(s, s, pairs, True) is None
    assert m._use_frame_kernel(s, s, pairs.with_(align_backend="torch"),
                               False) is None
    assert m._use_frame_kernel(s, s[:2], pairs, False) is None


# --------------------------------------------------------------- drivers


@pytest.mark.parametrize("planar", [False, True])
def test_batched_drivers_float32_match_jax_and_unbatched(planar):
    dim = 3 if planar else 2
    sp, dp, sm, dm = _pairs2d(b=4, n=350, m=380, pad_m=512, dim=dim, seed=5)
    sm[0, ::6] = False
    b = sp.shape[0]
    port = m.icp3d_planar if planar else m.icp2d
    jfn = j_icp.icp3d_planar if planar else j_icp.icp2d
    assert m._sort_enabled(_t(sp), _t(dp), KERNEL_CFG) == "morton"
    got, st = port(sp, dp, sm, dm, TT.identity((b,)), KERNEL_CFG,
                   return_stats=True, **CPU)
    want, jst = jfn(jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm),
                    jnp.asarray(dm), JT.identity((b,), jnp.float32), J_CFG,
                    return_stats=True)
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=F32_TOL, rtol=0)
    assert st.outer_iters.shape == (b,)
    assert (st.outer_iters == st.outer_iters[0]).all()
    for f in ("mean_nn_dist", "inlier_fraction"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.array(getattr(jst, f)), rtol=1e-4)
    for i in range(b):
        one = port(sp[i], dp[i], sm[i], dm[i], TT.identity(), PLAIN_CFG,
                   **CPU)
        np.testing.assert_allclose(got.rot[i].numpy(), one.rot.numpy(),
                                   atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(got.t[i].numpy(), one.t.numpy(),
                                   atol=F32_TOL, rtol=0)


def test_batched_icp2d_float64_matches_jax():
    sp, dp, sm, dm = _pairs2d(b=3, n=200, m=220, pad_n=256, pad_m=256,
                              seed=9, dtype=np.float64)
    b = sp.shape[0]
    got = m.icp2d(sp, dp, sm, dm, TT.identity((b,), torch.float64),
                  REFERENCE_CONFIG, **CPU)
    want = j_icp.icp2d(jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm),
                       jnp.asarray(dm), JT.identity((b,), jnp.float64), J_REF)
    np.testing.assert_allclose(got.rot.numpy(), np.array(want.rot),
                               atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=F64_TOL, rtol=0)


def test_batched_icp2d_entry_point_and_shared_db():
    sp, dp, sm, dm = _pairs2d(b=3, seed=11)
    b = sp.shape[0]
    t0 = TT.identity((b,))
    out = batched_icp2d(sp, dp, sm, dm, t0, KERNEL_CFG, **CPU)
    direct = m.icp2d(sp, dp, sm, dm, t0, KERNEL_CFG, **CPU)
    assert torch.equal(out.rot, direct.rot) and torch.equal(out.t, direct.t)
    # A shared (M, 2) db and an unbatched warm start broadcast to the
    # batch: the same as passing them per pair.
    for cfg in (KERNEL_CFG, KERNEL_CFG.with_(frame_backend="pairs")):
        shared = batched_icp2d(sp, dp[0], sm, dm[0], TT.identity(), cfg,
                               **CPU)
        tiled = batched_icp2d(
            sp, np.ascontiguousarray(np.broadcast_to(dp[0], dp.shape)), sm,
            np.ascontiguousarray(np.broadcast_to(dm[0], dm.shape)), t0, cfg,
            **CPU)
        assert torch.equal(shared.rot, tiled.rot)
        assert torch.equal(shared.t, tiled.t)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        batched_icp2d(sp, dp, sm, dm, t0, KERNEL_CFG, mesh=object(), **CPU)


def test_per_lane_fixed_point_and_lane_counts():
    """A lane that is fixed stays bitwise unchanged while the others run;
    the loop's count is the largest lane count."""
    sp, dp, sm, dm = _pairs2d(b=3, seed=13)
    dp[1], dm[1] = sp[1], sm[1]  # perfect fit: fixed at iteration 1
    b = sp.shape[0]
    t, it, lane_it = m._icp2d_solver(_t(sp), _t(dp), _t(sm), _t(dm),
                                     TT.identity((b,)), PLAIN_CFG)
    assert int(lane_it[1]) == 1 and it == int(lane_it.max()) > 1
    assert torch.equal(t.rot[1], torch.eye(2))
    assert torch.equal(t.t[1], torch.zeros(2))
    ident = TT.identity((2,))
    moved = TT(ident.rot, ident.t + torch.tensor([[0.0, 0.0], [0.0, 1e-30]]))
    assert m._is_identity(moved).tolist() == [True, False]


def test_convert_maps_pair_backends():
    for jb, want in (("pairs", "cuda"), ("pallas", "cuda"), ("xla", "torch")):
        cfg = convert.config_from_fields(
            dataclasses.asdict(JaxConfig(nn_backend=jb)))
        assert cfg.nn_backend == want
    for jf, want in (("auto", "auto"), ("off", "off"), ("pairs", "pairs"),
                     ("interpret", "pairs")):
        cfg = convert.config_from_fields({"frame_backend": jf})
        assert cfg.frame_backend == want


def test_interpret_maps_to_the_jax_path_for_a_batch():
    """JAX's frame_backend="interpret" runs a batch through the pair-frame
    kernel; the converted config takes the pair-frame route too, and the
    two agree."""
    sp, dp, sm, dm = _pairs2d(b=2, n=250, m=260, pad_n=256, pad_m=384,
                              seed=17)
    jcfg = J_CFG.with_(frame_backend="interpret")
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert m._use_frame_kernel(_t(sp), _t(dp), cfg, False) == "pairs"
    got = m.icp2d(sp, dp, sm, dm, TT.identity((2,)), cfg, **CPU)
    want = j_icp.icp2d(jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sm),
                       jnp.asarray(dm), JT.identity((2,), jnp.float32), jcfg)
    np.testing.assert_allclose(got.t.numpy(), np.array(want.t),
                               atol=FRAME_TOL, rtol=0)


@pytest.fixture
def chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(root)
    return mod


def test_chip_smoke_batched_phases_rehearse_on_cpu(chip_smoke, capsys):
    """chip_smoke.py's batched phases at a tiny size on the CPU, where
    every wrapper takes its kernel's plain version."""
    size = {"n_scans": 4, "pad": 768}
    recs = chip_smoke.phase_nn_pairs("cpu", big_pairs=2, big_db=1024,
                                     **size)
    recs += [chip_smoke.phase_irls_batched("cpu", **size),
             chip_smoke.phase_frame_pairs("cpu", **size)]
    assert [r["name"] for r in recs] == ["nn_pairs", "nn_pairs_list",
                                         "irls_loop_batched",
                                         "icp2d_frame_pairs"]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0  # the same code on the CPU
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    run = chip_smoke.phase_batched("cpu", **size)
    assert run["max_t_err"] < chip_smoke.ATE_GATE_M
    out = capsys.readouterr().out
    assert out.count("bitwise equal to plain and brute force") == 9
