"""The port's batched point-to-plane ICP against the JAX package, on the
same inputs (made with numpy from a seed): ``icp_point_to_plane`` on a
batch of pairs, and kernels 8 and 9's plain versions at the 4-lane plane
payload [n, c = n . q].

Tolerances:
- Batched ``icp_point_to_plane`` against JAX's, float64 on the CPU: 1e-9,
  equal outer iteration counts, and the stats of every lane within 1e-9.
  Float32: 1e-4 in the transform (the single-pair test's tolerance in
  tests/test_torch_p2l.py: the port's kernel route runs Morton-sorted,
  JAX's CPU route unsorted).
- Each lane of the port's batched call against the port's own single-pair
  call on it, float64: 1e-12.
- nn_pairs' and nn_pairs_list's plain versions at D 3 / P 4, through
  ``nearest_neighbor_matched`` on the kernel route, against
  ``nn_pallas_matched_pairs(..., interpret=True)``: identical indices and
  payload (the sentinel c of invalid planes included); distances within
  D - 1 ulp (XLA's CPU backend contracts the squared-difference sum into
  FMAs, tests/test_torch_batched.py).  Their schedules' emulations
  (``pairs_items``, ``pairs_list_items``) bitwise equal to them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from icp_rust_tpu.config import ICPConfig as JaxConfig
from icp_rust_tpu.config import REFERENCE_CONFIG as J_REF
from icp_rust_tpu.geometry.transform3d import RigidTransform3 as JT
from icp_rust_tpu.models import icp_p2l as j_icp_p2l
from icp_rust_tpu.ops import nn as j_nn
from icp_rust_tpu.ops import nn_pallas as j_pallas
from icp_rust_tpu_torch.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3 as TT
from icp_rust_tpu_torch.models import icp_p2l
from icp_rust_tpu_torch.ops import nn, nn_pairs_cuda

F64_TOL = 1e-9
LANE_TOL = 1e-12
F32_TOL = 1e-4
CPU = {"device": "cpu"}
KERNEL_CFG = ICPConfig(det_rel_eps=1e-9)  # "auto" f32: the kernel route
J_CFG = JaxConfig(det_rel_eps=1e-9)
STATS = ("huber_error", "mean_nn_dist", "inlier_fraction")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread keeps six workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_cloud(n_per_face, rng):
    """Points on three orthogonal faces of a box: every DoF constrained."""
    u = rng.uniform(0, 2, (n_per_face, 2))
    return np.concatenate([np.column_stack([np.zeros(n_per_face), u]),
                           np.column_stack([u[:, :1], np.zeros(n_per_face),
                                            u[:, 1:]]),
                           np.column_stack([u, np.zeros(n_per_face)])])


def _box_pairs(b=3, n_per_face=128, seed=0):
    """B pairs of 3 x ``n_per_face`` box points, each dst the src moved by
    its own twist plus noise; pair 1's src has a masked tail."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(b):
        pts = _box_cloud(n_per_face, rng)
        tw = jnp.asarray([0.03, -0.02, 0.025, 0.015, -0.01, 0.02]) \
            * (1.0 - 0.2 * i)
        moved = np.array(JT.from_twist(tw).apply_points(jnp.asarray(pts)))
        src.append(pts)
        dst.append(moved + rng.normal(0, 5e-4, pts.shape))
    mask = np.ones((b, 3 * n_per_face), bool)
    mask[1, -40:] = False
    return np.stack(src), np.stack(dst), mask


@pytest.fixture(scope="module")
def pairs():
    return _box_pairs()


@pytest.fixture(scope="module")
def jax_runs(pairs):
    """JAX's batched calls with stats: float64 (reference config) and
    float32.  Two compiles, shared by the module."""
    src, dst, mask = pairs
    out = {}
    for key, cfg, dt in (("f64", J_REF, jnp.float64),
                         ("f32", J_CFG, jnp.float32)):
        t, st = j_icp_p2l.icp_point_to_plane(
            jnp.asarray(src, dt), jnp.asarray(dst, dt), jnp.asarray(mask),
            jnp.asarray(mask), JT.identity((src.shape[0],), dt), cfg,
            return_stats=True)
        out[key] = (np.array(t.rot), np.array(t.t),
                    {f: np.array(v) for f, v in st._asdict().items()})
    return out


@pytest.fixture(scope="module")
def port_f64(pairs):
    src, dst, mask = pairs
    return icp_p2l.icp_point_to_plane(
        src, dst, mask, mask, TT.identity((3,), torch.float64),
        REFERENCE_CONFIG, return_stats=True, **CPU)


def test_batched_p2l_float64_matches_jax(jax_runs, port_f64):
    t, st = port_f64
    rot, tr, j_st = jax_runs["f64"]
    assert t.rot.shape == (3, 3, 3) and st.outer_iters.shape == (3,)
    np.testing.assert_allclose(t.rot.numpy(), rot, atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(t.t.numpy(), tr, atol=F64_TOL, rtol=0)
    np.testing.assert_array_equal(st.outer_iters.numpy(),
                                  j_st["outer_iters"])
    # Every lane reports the lockstep loop's count, as JAX's does.
    assert len(set(st.outer_iters.tolist())) == 1
    for f in STATS:
        np.testing.assert_allclose(getattr(st, f).numpy(), j_st[f],
                                   rtol=F64_TOL, atol=1e-15)


def test_batched_p2l_float32_matches_jax(pairs, jax_runs):
    src, dst, mask = pairs
    t, st = icp_p2l.icp_point_to_plane(
        src, dst, mask, mask, TT.identity((3,)), KERNEL_CFG,
        return_stats=True, **CPU)
    rot, tr, j_st = jax_runs["f32"]
    np.testing.assert_allclose(t.rot.numpy(), rot, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(t.t.numpy(), tr, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(st.mean_nn_dist.numpy(), j_st["mean_nn_dist"],
                               rtol=1e-3)
    np.testing.assert_allclose(st.inlier_fraction.numpy(),
                               j_st["inlier_fraction"], atol=1e-2)


def test_batched_p2l_two_batch_axes_match_jax(pairs, jax_runs, port_f64):
    src, dst, mask = pairs
    t, st = icp_p2l.icp_point_to_plane(
        src.reshape(1, 3, *src.shape[1:]), dst.reshape(1, 3, *dst.shape[1:]),
        mask.reshape(1, 3, -1), mask.reshape(1, 3, -1),
        TT.identity((1, 3), torch.float64), REFERENCE_CONFIG,
        return_stats=True, **CPU)
    assert t.rot.shape == (1, 3, 3, 3) and t.t.shape == (1, 3, 3)
    assert st.outer_iters.shape == (1, 3)
    assert torch.equal(t.t[0], port_f64[0].t)
    assert torch.equal(t.rot[0], port_f64[0].rot)
    rot, tr, j_st = jax_runs["f64"]
    np.testing.assert_allclose(t.t[0].numpy(), tr, atol=F64_TOL, rtol=0)
    for f in STATS:
        assert torch.equal(getattr(st, f)[0], getattr(port_f64[1], f))


@pytest.mark.parametrize("normals", ["voxel", "given"])
def test_batched_p2l_lanes_match_single_pair_calls(pairs, port_f64, normals):
    """Each lane equals the port's own single-pair call: voxel normals per
    pair (as JAX vmaps them), or per-pair ``dst_normals``; a (B,) warm
    start for the latter."""
    src, dst, mask = pairs
    kw = dict(normals_voxel_size=0.3)
    warm = TT.identity((3,), torch.float64)
    if normals == "voxel":
        t, st = port_f64
    else:
        from icp_rust_tpu_torch.ops.normals import estimate_normals

        kw["dst_normals"] = estimate_normals(torch.as_tensor(dst),
                                             torch.as_tensor(mask))[0]
        warm = TT.from_twist(torch.tensor([[0.01, 0, 0, 0, 0, 0.005]] * 3,
                                          dtype=torch.float64))
        t, st = icp_p2l.icp_point_to_plane(src, dst, mask, mask, warm,
                                           REFERENCE_CONFIG,
                                           return_stats=True, **kw, **CPU)
    for i in range(3):
        lane_kw = dict(kw)
        if "dst_normals" in kw:
            lane_kw["dst_normals"] = kw["dst_normals"][i]
        t1, st1 = icp_p2l.icp_point_to_plane(
            src[i], dst[i], mask[i], mask[i],
            TT(warm.rot[i], warm.t[i]), REFERENCE_CONFIG, return_stats=True,
            **lane_kw, **CPU)
        np.testing.assert_allclose(t.t[i].numpy(), t1.t.numpy(),
                                   atol=LANE_TOL, rtol=0)
        np.testing.assert_allclose(t.rot[i].numpy(), t1.rot.numpy(),
                                   atol=LANE_TOL, rtol=0)
        assert int(st1.outer_iters) <= int(st.outer_iters[i])
        for f in STATS:
            np.testing.assert_allclose(float(getattr(st, f)[i]),
                                       float(getattr(st1, f)),
                                       rtol=LANE_TOL, atol=1e-15)


def test_batched_p2l_kernel_route_takes_the_pair_grid(pairs, monkeypatch):
    """On the kernel route a batch of dbs of at most 4,096 points takes
    kernel 8 on the cold iteration and kernel 9 on every warm one (their
    plain versions here), and a batched kernel-route inner loop raises."""
    src, dst, mask = pairs
    seen = []
    for name in ("nn_pairs", "nn_pairs_list"):
        real = getattr(nn_pairs_cuda, name)

        def spy(*args, _real=real, _name=name):
            seen.append((_name, args[1].shape[1] - args[0].shape[-1]))
            return _real(*args)
        monkeypatch.setattr(nn_pairs_cuda, name, spy)
    _, st = icp_p2l.icp_point_to_plane(src, dst, mask, mask,
                                       TT.identity((3,)), KERNEL_CFG,
                                       return_stats=True, **CPU)
    k = int(st.outer_iters[0])
    assert seen == [("nn_pairs", 4)] + [("nn_pairs_list", 4)] * (k - 1)
    with pytest.raises(NotImplementedError, match="batched"):
        icp_p2l.icp_point_to_plane(src, dst, mask, mask, TT.identity((3,)),
                                   KERNEL_CFG.with_(align_backend="cuda"),
                                   **CPU)


def _plane_case(case, b=3, n=300, m=420, seed=0):
    """Queries, Morton-sorted dbs and masks with the p2l payload [n, c]:
    some invalid normals (the sentinel c), a masked db tail and, for
    "warm", the bound of one outer step."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    db = rng.uniform(-3, 3, (b, m, 3)).astype(np.float32)
    dm = rng.random((b, m)) > 0.2
    for i in range(b):
        order = np.array(j_nn.morton_order(jnp.asarray(db[i]),
                                           jnp.asarray(dm[i])))
        db[i], dm[i] = db[i][order], dm[i][order]
    nrm = rng.normal(size=(b, m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    n_valid = rng.random((b, m)) > 0.3
    pay = np.array(j_icp_p2l.build_p2l_payload(
        jnp.asarray(db), jnp.asarray(nrm), jnp.asarray(n_valid),
        jnp.asarray(dm), jnp.float32))
    qb = None
    if case == "warm":
        base, _ = j_pallas.nn_pallas_matched_pairs(
            jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm),
            payload=jnp.asarray(pay), interpret=True)
        q2 = q + rng.normal(0, 0.05, q.shape).astype(np.float32)
        move = np.linalg.norm(q2 - q, axis=-1)
        qb = ((np.sqrt(np.array(base.dist_sq)) + move) ** 2
              * np.float32(1 + 32 * np.finfo(np.float32).eps))
        q = q2
    return q, db, dm, pay, qb


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_pairs_nn_at_the_plane_payload_matches_jax_interpret(case):
    q, db, dm, pay, qb = _plane_case(case)
    want, want_p = j_pallas.nn_pallas_matched_pairs(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm),
        payload=jnp.asarray(pay),
        q_bound=None if qb is None else jnp.asarray(qb), interpret=True)
    t = torch.as_tensor
    assert nn.route(t(q), t(db), 4, ICPConfig(nn_backend="cuda")).kind \
        == "pairs"
    got, got_p = nn.nearest_neighbor_matched(
        t(q), t(db), t(dm), payload=t(pay), backend="cuda",
        q_bound=None if qb is None else t(qb))
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    np.testing.assert_array_max_ulp(got.dist_sq.numpy(),
                                    np.array(want.dist_sq), maxulp=2)
    # The sentinel c of invalid planes comes back as it went in.
    c = got_p[..., 3]
    assert bool((c == np.float32(icp_p2l._C_INVALID)).any())
    assert set(np.unique(c.numpy()[np.abs(c.numpy()) > 1e18])) == {
        np.float32(icp_p2l._C_INVALID)}


@pytest.mark.parametrize("item", [1, 2, 3])
def test_pairs_schedule_emulations_at_the_plane_payload(item):
    q, db, dm, pay, _ = _plane_case("cold", m=520)
    t = torch.as_tensor
    brute = nn.nn_torch(t(q), t(db), t(dm))
    qb = brute.dist_sq * (1.0 + 32.0 * float(np.finfo(np.float32).eps))
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(t(q), t(db), t(dm),
                                                     t(pay), qb, 128)
    assert dbf.shape[1] == 7
    qbox = nn_pairs_cuda._query_boxes(query_p, 128)
    args8 = (query_p, dbf, qbox, cbox, nn_pairs_cuda._group_bounds(qb_p, 128),
             3, 128)
    plain8 = nn_pairs_cuda.nn_pairs(*args8)
    emul8 = nn_pairs_cuda.pairs_items(*args8, item=item)
    lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, 3, 128,
                                               64)
    args9 = (query_p, dbf, lists, cnt, 3, 128, qb_p, cbox)
    plain9 = nn_pairs_cuda.nn_pairs_list(*args9)
    emul9 = nn_pairs_cuda.pairs_list_items(*args9, item=item)
    for a, b in zip(plain8, emul8[:3]):
        assert torch.equal(a, b)
    for a, b in zip(plain9, emul9[:3]):
        assert torch.equal(a, b)
    n = q.shape[1]
    for a, b in zip(plain8, plain9):
        assert torch.equal(a[:, :n], b[:, :n])
    assert torch.equal(plain9[1][:, :n], brute.index)


def _wide_pairs(seed=3):
    """Two pairs of 500 box queries (a masked tail on pair 0: 512 rows
    padded) against dbs of 4,224 points: pair 0's db every point twice
    (exact ties), pair 1's fully masked.  Each src is its dst's box moved
    by one twist."""
    rng = np.random.default_rng(seed)
    half = _box_cloud(704, rng)
    dst = np.stack([np.concatenate([half, half]), _box_cloud(1408, rng)])
    tw = torch.tensor([[0.03, -0.02, 0.025, 0.015, -0.01, 0.02]] * 2,
                      dtype=torch.float64)
    src = torch.as_tensor(np.stack([_box_cloud(167, rng)[:500]
                                    for _ in range(2)]))
    src = TT.from_twist(tw).inverse().apply_points(src)
    smask = np.ones((2, 500), bool)
    smask[0, -37:] = False
    dmask = np.ones((2, 4224), bool)
    dmask[1] = False
    return (src.numpy().astype(np.float32), dst.astype(np.float32), smask,
            dmask)


def test_batched_p2l_warm_searches_above_4096_points_take_kernel_8(
        monkeypatch):
    """Dbs of more than 4,096 points and 3 tiles or more (a 1,408-point
    tile): the cold search takes kernel 4 (its plain version here), every
    warm one kernel 8's seed-pruned static sweep, each search's (dist,
    idx, payload) bitwise kernel 4's plain version on the same inputs, and
    the transforms bitwise those of the call with every search on kernel
    4."""
    from icp_rust_tpu_torch.ops import nn_cuda, nn_sweep_cuda

    src, dst, smask, dmask = _wide_pairs()
    cfg = KERNEL_CFG.with_(nn_dst_tile=1408)
    seen, searches = [], []
    for mod, name in ((nn_sweep_cuda, "nn_matched"),
                      (nn_pairs_cuda, "nn_pairs")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            walk = (nn_pairs_cuda._box_lower_bound(args[2], args[3], 3)
                    <= args[4][..., None]) if _name == "nn_pairs" else None
            seen.append((_name, walk))
            return _real(*args)
        monkeypatch.setattr(mod, name, spy)
    real_search = nn.NNIndex.search

    def search_spy(index, query, q_bound=None, warm=None):
        out = real_search(index, query, q_bound, warm)
        searches.append((query, index.db, index.db_mask, index.payload, out))
        return out
    monkeypatch.setattr(nn.NNIndex, "search", search_spy)

    def run():
        seen.clear()
        return icp_p2l.icp_point_to_plane(src, dst, smask, dmask,
                                          TT.identity((2,)), cfg,
                                          return_stats=True, **CPU)
    t, st = run()
    k = int(st.outer_iters[0])
    assert k >= 3 and len(searches) == k
    assert [n for n, _ in seen] == ["nn_matched"] + ["nn_pairs"] * (k - 1)
    # The seeds prune chunks of pair 0; pair 1's +inf bounds walk all.
    assert all(bool(w[1].all()) and not bool(w[0].all())
               for _, w in seen[1:])
    for query, db, db_mask, pay, (res, got_pay) in searches:
        query_p = torch.zeros((2, 512, 3))
        query_p[:, :500] = query
        dbf = nn_cuda._dbf_cm_matched(db, db_mask, pay, 4224)
        dist, idx, want_pay = nn_sweep_cuda.nn_matched_plain(query_p, dbf, 3)
        assert torch.equal(res.index, idx[:, :500])
        assert torch.equal(res.dist_sq, nn_cuda._trim_sentinel(dist[:, :500]))
        assert torch.equal(got_pay, want_pay[:, :500])
    # Pair 1 has no valid point; each winner of pair 0 is the lower index
    # of its two copies.
    _, db, _, _, (res, _) = searches[-1]
    assert torch.isinf(res.dist_sq[1]).all()
    win = res.index[0].long()
    same = (db[0][None] == db[0][win][:, None]).all(-1)
    assert bool((same.sum(1) == 2).all())
    assert torch.equal(torch.argmax(same.to(torch.int8), dim=1), win)
    real_route = nn.route
    monkeypatch.setattr(nn, "route", lambda *a, **kw: real_route(
        *a, **kw)._replace(pruned_warm=False))
    t4, st4 = run()
    assert [n for n, _ in seen] == ["nn_matched"] * k
    assert torch.equal(t4.rot, t.rot) and torch.equal(t4.t, t.t)
    assert torch.equal(st4.outer_iters, st.outer_iters)


def test_pairs_plain_versions_sweep_in_row_blocks_bitwise(monkeypatch):
    """Above ``_PLAIN_PAIRS`` distances the plain versions sweep blocks of
    (pair, subtile) rows: bitwise the one-piece sweep, for kernel 8's
    subtiles and kernel 9's warp groups."""
    q, db, dm, pay, _ = _plane_case("cold", m=520)
    t = torch.as_tensor
    brute = nn.nn_torch(t(q), t(db), t(dm))
    qb = brute.dist_sq * (1.0 + 32.0 * float(np.finfo(np.float32).eps))
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(t(q), t(db), t(dm),
                                                     t(pay), qb, 128)
    args8 = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, 128), cbox,
             nn_pairs_cuda._group_bounds(qb_p, 128), 3, 128)
    lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, 3, 128,
                                               64)
    args9 = (query_p, dbf, lists, cnt, 3, 128, qb_p, cbox)
    whole = (nn_pairs_cuda.nn_pairs_plain(*args8),
             nn_pairs_cuda.nn_pairs_list_plain(*args9))
    for pairs in (1, 2 * 128 * 640):
        monkeypatch.setattr(nn_pairs_cuda, "_PLAIN_PAIRS", pairs)
        got = (nn_pairs_cuda.nn_pairs_plain(*args8),
               nn_pairs_cuda.nn_pairs_list_plain(*args9))
        for g, w in zip(got, whole):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
