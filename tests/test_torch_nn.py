"""The port's exact 1-NN against the JAX package, on the same inputs.

- ``nn_torch`` (the plain tiled sweep) against ``nn_xla``: identical
  indices; float32 distances within D - 1 ulp (2 in 3D), because XLA's
  CPU backend contracts each add of the squared-difference sum into an
  FMA where torch rounds every op.
- The survivor-list path (pack, center bound, lists, the plain version of
  the nn_list kernel), taken by ``nn_backend="cuda"`` on a CPU tensor,
  against ``nn_pallas_matched(..., interpret=True, prune=True, q_bound=...)``
  on the cases of tests/test_nn_pallas.py: identical indices and payload,
  distances within D - 1 ulp for the same reason.
- Morton and azimuth orders: identical permutations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.ops import nn as j_nn
from icp_rust_tpu.ops import nn_pallas as j_pallas
from icp_rust_tpu_torch.ops import nn, nn_cuda, nn_sweep_cuda

F32_EPS = float(np.finfo(np.float32).eps)


def _ulps(d: int) -> int:
    # One rounding per add that XLA fuses into an FMA: D - 1 of them.
    return max(d - 1, 1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("q,m,tile", [(256, 512, 256), (300, 700, 2048),
                                      (300, 700, 128)])
def test_nn_torch_matches_nn_xla(d, q, m, tile):
    rng = np.random.default_rng(q + m + d)
    query = rng.uniform(-3, 3, (q, d)).astype(np.float32)
    db = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    db_mask = rng.random(m) > 0.15
    got = nn.nn_torch(_t(query), _t(db), _t(db_mask), tile=tile)
    want = j_nn.nn_xla(jnp.asarray(query), jnp.asarray(db),
                       jnp.asarray(db_mask), tile=tile)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_max_ulp(got.dist_sq.numpy(),
                                    np.array(want.dist_sq), maxulp=_ulps(d))


def test_nn_torch_float64_and_ties():
    rng = np.random.default_rng(4)
    query = rng.uniform(-3, 3, (200, 3))
    db = np.concatenate([rng.uniform(-3, 3, (300, 3))] * 2)  # every point twice
    query[:50] = db[:50]
    got = nn.nn_torch(_t(query), _t(db), tile=256)
    want = j_nn.nn_xla(jnp.asarray(query), jnp.asarray(db), tile=256)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_allclose(got.dist_sq.numpy(), np.array(want.dist_sq),
                               rtol=1e-12, atol=0)
    assert (got.index.numpy()[:50] == np.arange(50)).all()  # lowest wins
    all_masked = nn.nn_torch(_t(query), _t(db), torch.zeros(600, dtype=bool))
    assert torch.isinf(all_masked.dist_sq).all()
    assert (all_masked.index == 0).all()


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_morton_and_azimuth_orders_identical(prec):
    npt = np.float32 if prec == "f32" else np.float64
    rng = np.random.default_rng(80)
    pts = rng.uniform(-5, 5, (1000, 3)).astype(npt)
    mask = rng.random(1000) > 0.2
    for fn, jfn in ((nn.morton_order, j_nn.morton_order),
                    (nn.azimuth_order, j_nn.azimuth_order)):
        got = fn(_t(pts), _t(mask)).numpy()
        want = np.array(jfn(jnp.asarray(pts), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        nn.spatial_order(_t(pts), _t(mask), "hilbert")


def _morton_sorted_db(rng, m, d, keep=0.9):
    db = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    dm = rng.random(m) < keep
    order = np.array(j_nn.morton_order(jnp.asarray(db), jnp.asarray(dm)))
    return db[order], dm[order]


def _compare_list_path(q, db, dm, pay, qb, q_tile=128, db_tile=256):
    want, want_p = j_pallas.nn_pallas_matched(
        jnp.asarray(q), jnp.asarray(db),
        None if dm is None else jnp.asarray(dm),
        payload=None if pay is None else jnp.asarray(pay), q_tile=q_tile,
        db_tile=db_tile, interpret=True, prune=True,
        q_bound=jnp.asarray(qb))
    got, got_p = nn.nearest_neighbor_matched(
        _t(q), _t(db), None if dm is None else _t(dm),
        payload=None if pay is None else _t(pay), backend="cuda",
        tile=db_tile, q_tile=q_tile, q_bound=_t(qb))
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    np.testing.assert_array_max_ulp(got.dist_sq.numpy(),
                                    np.array(want.dist_sq),
                                    maxulp=_ulps(q.shape[1]))
    # and the unpruned exact sweep agrees on the winners
    brute = nn.nn_torch(_t(q), _t(db), None if dm is None else _t(dm))
    np.testing.assert_array_equal(got.index.numpy(), brute.index.numpy())
    return got


def test_list_path_warm_matches_jax():
    rng = np.random.default_rng(77)
    q = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    db, dm = _morton_sorted_db(rng, 2048, 3)
    brute = nn.nn_torch(_t(q), _t(db), _t(dm))
    qb = brute.dist_sq.numpy() * np.float32(1 + 32 * F32_EPS)
    _compare_list_path(q, db, dm, db[:, :2], qb)


def test_list_path_overflow_full_sweep_matches_jax():
    rng = np.random.default_rng(78)
    q = rng.uniform(-3, 3, (256, 2)).astype(np.float32)
    db = rng.uniform(-3, 3, (1536, 2)).astype(np.float32)
    qb = np.full((256,), 1e30, np.float32)  # finite: warm, every chunk
    _compare_list_path(q, db, None, None, qb)


@pytest.mark.parametrize("keep", [1.0, 0.05])
def test_list_path_cold_matches_jax(keep):
    rng = np.random.default_rng(79)
    q = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    db = rng.uniform(-3, 3, (1536, 3)).astype(np.float32)
    dm = None if keep == 1.0 else rng.random(1536) < keep
    qb = np.full((256,), np.inf, np.float32)  # iteration 1: center bound
    _compare_list_path(q, db, dm, None, qb)


def test_pack_db_and_center_bound_match_jax():
    rng = np.random.default_rng(123)
    m, db_tile = 2900, 512
    query = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    db = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    mask = rng.random(m) >= 0.5
    pack = nn_cuda.pack_db(_t(db), _t(mask), _t(db[:, :2]), db_tile=db_tile)
    jpack = j_pallas.pack_db(jnp.asarray(db), jnp.asarray(mask),
                             jnp.asarray(db[:, :2]), db_tile=db_tile)
    np.testing.assert_array_equal(pack.dbf_cm.numpy(), np.array(jpack.dbf_cm))
    np.testing.assert_array_equal(pack.cbox.numpy(), np.array(jpack.cbox))
    qb = nn_cuda._center_bound(_t(query), pack.cbox, 3).numpy()
    jqb = np.array(j_pallas._center_bound(jnp.asarray(query), jpack.cbox, 3))
    np.testing.assert_array_max_ulp(qb, jqb, maxulp=2)
    true_d = nn.nn_torch(_t(query), _t(db), _t(mask)).dist_sq.numpy()
    assert not np.isnan(qb).any() and (qb >= true_d).all()


def test_survivor_lists_are_ascending_and_padded():
    rng = np.random.default_rng(5)
    db, dm = _morton_sorted_db(rng, 4096, 3)
    pack = nn_cuda.pack_db(_t(db), _t(dm), db_tile=512)
    q = _t(db[:1024] + np.float32(0.01))
    qb = nn_cuda._center_bound(q, pack.cbox, 3)
    lists, cnt = nn_cuda._survivor_lists(q, pack.cbox, qb, 3, 128, 16)
    assert lists.dtype == torch.int32 and lists.shape == (8, 16)
    for row, c in zip(lists.numpy(), cnt.numpy()):
        k = min(int(c), 16)
        assert (np.diff(row[:k]) > 0).all()
        assert (row[k:] == row[0]).all()


def test_kernel_path_refuses_what_is_not_ported():
    """Every NN route of the JAX package has a kernel now: a db of fewer
    than 3 tiles (kernel 4), a batch over dbs of more than 4096 points
    (kernel 4) and an unseeded search (kernel 6) run and agree with the
    plain sweep.  A payload width no kernel instance serves is refused by
    name before any launch."""
    rng = np.random.default_rng(6)
    q = _t(rng.uniform(-3, 3, (128, 3)).astype(np.float32))
    for db, qb in ((rng.uniform(-3, 3, (1000, 3)), torch.zeros(128)),
                   (rng.uniform(-3, 3, (8192, 3)), None)):
        db = _t(db.astype(np.float32))
        res, matched = nn.nearest_neighbor_matched(q, db, backend="cuda",
                                                   q_bound=qb)
        want = nn.nn_torch(q, db)
        assert torch.equal(res.index, want.index)
        assert torch.equal(res.dist_sq, want.dist_sq)
        assert torch.equal(matched, db[want.index.long()])
    qs = _t(rng.uniform(-3, 3, (2, 128, 3)).astype(np.float32))
    dbs = _t(rng.uniform(-3, 3, (2, 4097, 3)).astype(np.float32))
    res, _ = nn.nearest_neighbor_matched(qs, dbs, backend="cuda",
                                         q_bound=torch.zeros(2, 128))
    assert torch.equal(res.index, nn.nn_torch(qs, dbs).index)
    # "auto" on float64 takes the plain sweep, as on the TPU.
    small_db = torch.zeros((1000, 3))
    res, matched = nn.nearest_neighbor_matched(q.double(), small_db.double())
    assert matched.shape == (128, 3)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="payload width 5"):
        nn_sweep_cuda.nn_matched(torch.zeros((128, 3), device=meta),
                                 torch.zeros((8, 2048), device=meta), 3)


def test_wrapper_launches_or_raises_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device reaches
    the kernel path or raises (no fallback)."""
    dev = torch.device("meta")
    q = torch.zeros((256, 3), device=dev)
    dbf = torch.zeros((5, 2048), device=dev)
    lists = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    cnt = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported device"):
        nn_cuda.nn_list(q, dbf, lists, cnt, 3, 256, 16)
