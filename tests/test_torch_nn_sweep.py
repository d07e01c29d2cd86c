"""The port's NN sweeps without survivor lists (``ops/nn_sweep_cuda.py``:
kernels 4, 5 and 6 through their plain versions, which a CPU tensor
takes) and the routes of ``ops/nn.nearest_neighbor`` /
``nearest_neighbor_matched`` that reach them, against the JAX package's
``nn_pallas`` functions in interpret mode and ``nn_xla``.

Tolerances: indices and payloads identical; float32 distances within
D - 1 ulp (XLA's CPU backend contracts each add of the squared-difference
sum into an FMA, where torch rounds every op; ROADMAP §3).  The db tile
is 512, so 3 tiles (the pruned kernel's threshold) cost ~1.5k points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.ops import nn as j_nn
from icp_rust_tpu.ops import nn_pallas as j_pallas
from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.ops import nn, nn_cuda, nn_sweep_cuda as sw

DB_TILE = 512
F32_EPS = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got_d, want_d, d):
    np.testing.assert_array_max_ulp(np.asarray(got_d), np.array(want_d),
                                    maxulp=max(d - 1, 1))


def _cloud(seed, q, m, d, keep=0.85, sort=False):
    rng = np.random.default_rng(seed)
    db = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    dm = rng.random(m) < keep
    if sort:
        order = np.array(j_nn.morton_order(jnp.asarray(db), jnp.asarray(dm)))
        db, dm = db[order], dm[order]
    if sort:  # spatially ordered queries: near the db's own order
        query = (db[::2][:q] + rng.normal(0, 0.02, (q, d))).astype(
            np.float32)
    else:
        query = rng.uniform(-3, 3, (q, d)).astype(np.float32)
        query[: q // 2] = db[: q // 2] + rng.normal(0, 0.02, (q // 2, d))
    pay = rng.normal(size=(m, 4)).astype(np.float32)
    return query, db, dm, pay


def _packed(query, db, dm, pay, q_tile, db_tile=DB_TILE):
    """(query_p, dbf_cm) as nn_pallas_matched builds them."""
    q_pad = -(-len(query) // q_tile) * q_tile
    m_pad = -(-len(db) // db_tile) * db_tile
    qp = np.zeros((q_pad, query.shape[1]), np.float32)
    qp[: len(query)] = query
    dbf = j_pallas._dbf_cm_matched(jnp.asarray(db), jnp.asarray(dm),
                                   jnp.asarray(pay), m_pad)
    return qp, np.array(dbf)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f_dim", [0, 2, 4])
def test_sweep_plain_matches_nn_matched_2d(d, f_dim):
    """Kernels 4 (f_dim > 0) and 5 (f_dim 0): the plain sweep against
    _nn_matched_2d / _nn_pallas_2d on the same packed inputs."""
    query, db, dm, pay = _cloud(10 + d + f_dim, 300, 1000, d)
    qp, dbf = _packed(query, db, dm, pay[:, :f_dim], 256)
    if f_dim:
        want = j_pallas._nn_matched_2d(jnp.asarray(qp), jnp.asarray(dbf),
                                       d_dim=d, q_tile=256, db_tile=DB_TILE,
                                       interpret=True)
        got = sw.nn_matched(_t(qp), _t(dbf), d)
        np.testing.assert_array_equal(got[2].numpy(), np.array(want[2]))
    else:
        want = j_pallas._nn_pallas_2d(jnp.asarray(qp), jnp.asarray(dbf),
                                      q_tile=256, db_tile=DB_TILE,
                                      interpret=True)
        got = sw.nn_sweep(_t(qp), _t(dbf))
    np.testing.assert_array_equal(got[1].numpy(), np.array(want[1]))
    _close(got[0].numpy(), want[0], d)


@pytest.mark.parametrize("d,f_dim,q_tile,seeds", [
    (2, 0, 512, "inf"), (3, 4, 256, "inf"), (2, 4, 256, "tight"),
    (3, 0, 512, "tight")])
def test_pruned_plain_matches_nn_pruned_2d(d, f_dim, q_tile, seeds):
    """Kernel 6: zig-zag order, prune test and lexicographic carry against
    _nn_pruned_2d on a Morton-sorted db in 12 tiles of 256 (where tiles do
    prune), unseeded and with tight seeds."""
    db_tile = 256
    query, db, dm, pay = _cloud(20 + d, 700, 3000, d, sort=True)
    qp, dbf = _packed(query, db, dm, pay[:, :f_dim], q_tile, db_tile)
    qb = np.full(len(qp), np.inf, np.float32)
    if seeds == "tight":
        true = j_nn.nn_xla(jnp.asarray(qp), jnp.asarray(db),
                           jnp.asarray(dm)).dist_sq
        qb = np.array(true) * np.float32(1 + 32 * F32_EPS)
        qb[len(query):] = -np.inf
    want = j_pallas._nn_pruned_2d(jnp.asarray(qp), jnp.asarray(dbf),
                                  jnp.asarray(qb), d_dim=d, q_tile=q_tile,
                                  db_tile=db_tile, interpret=True)
    q_t, dbf_t = _t(qp), _t(dbf)
    qbox = sw._query_boxes(q_t, q_tile)
    bbox = nn_cuda._tile_boxes(dbf_t[:d], db_tile)
    qbt = sw._qb_tile(_t(qb), q_tile)
    got = sw.nn_pruned(q_t, dbf_t, qbox, bbox, qbt, d, q_tile, db_tile)
    np.testing.assert_array_equal(got[1].numpy(), np.array(want[1]))
    _close(got[0].numpy(), want[0], d)
    if f_dim:
        np.testing.assert_array_equal(got[2].numpy(), np.array(want[2]))
    # The glue is the JAX package's, and the sweep does prune.
    np.testing.assert_array_equal(
        qbox.numpy(), np.array(j_pallas._query_boxes(jnp.asarray(qp),
                                                     q_tile)))
    np.testing.assert_array_equal(
        bbox.numpy(), np.array(j_pallas._tile_boxes(jnp.asarray(dbf[:d]),
                                                    db_tile)))
    walked = sw.tiles_walked(q_t, dbf_t, qbox, bbox, qbt, d, q_tile,
                             db_tile)
    assert 0 < walked < (len(qp) // sw.SUB) * (dbf.shape[1] // db_tile)


@pytest.mark.parametrize("case,d,f_dim,q_tile,item", [
    ("sorted", 3, 4, 256, 3), ("unsorted", 2, 2, 512, 1),
    ("ties", 3, 0, 256, 2), ("tight", 3, 0, 128, 4)])
def test_pruned_items_merge_bitwise(case, d, f_dim, q_tile, item):
    """Kernel 6's schedule (``pruned_items``): each query group's zig-zag
    order cut into work items of ``item`` tiles, each item with its own
    carry and threshold, the items merged lexicographically, the payload
    read at the winner.  Bitwise equal to the plain version (one walk of
    the whole order) and to a brute-force sweep, and to _nn_pruned_2d in
    interpret mode (distances within D - 1 ulp): Morton-sorted tiles that
    prune, unsorted ones, exact ties whose copies lie in different items,
    and tight seeds.  Every item is swept from its first position only
    where the prune test lets it, position 0 always."""
    db_tile = 256
    query, db, dm, pay = _cloud(80 + d, 1024, 2048, d,
                                sort=case in ("sorted", "tight"))
    if case == "ties":  # every point twice, 4 tiles apart
        db = np.concatenate([db[:1024], db[:1024]])
        dm = np.ones(2048, bool)
        query = db[np.random.default_rng(5).permutation(1024)]
    qp, dbf = _packed(query, db, dm, pay[:, :f_dim], q_tile, db_tile)
    qb = np.full(len(qp), np.inf, np.float32)
    if case == "tight":
        true = j_nn.nn_xla(jnp.asarray(qp), jnp.asarray(db),
                           jnp.asarray(dm)).dist_sq
        qb = np.array(true) * np.float32(1 + 32 * F32_EPS)
    want = j_pallas._nn_pruned_2d(jnp.asarray(qp), jnp.asarray(dbf),
                                  jnp.asarray(qb), d_dim=d, q_tile=q_tile,
                                  db_tile=db_tile, interpret=True)
    q_t, dbf_t = _t(qp), _t(dbf)
    args = (q_t, dbf_t, sw._query_boxes(q_t, q_tile),
            nn_cuda._tile_boxes(dbf_t[:d], db_tile),
            sw._qb_tile(_t(qb), q_tile), d, q_tile, db_tile)
    *got, sweeps = sw.pruned_items(*args, item_tiles=item)
    for a, b in zip(got, sw.nn_pruned_plain(*args)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[1].numpy(), np.array(want[1]))
    _close(got[0].numpy(), want[0], d)
    if f_dim:
        np.testing.assert_array_equal(got[2].numpy(), np.array(want[2]))
    brute = nn.nn_torch(_t(query), _t(db), _t(dm))
    assert torch.equal(got[1][:len(query)], brute.index)
    assert torch.equal(nn_cuda._trim_sentinel(got[0][:len(query)]),
                       brute.dist_sq)
    if case == "ties":
        assert bool((got[1] < 1024).all())
    threads, q = sw._block_shape(q_tile, sw.QUERIES_PER_THREAD)
    n_groups, n_db = len(qp) // (threads * q), 2048 // db_tile
    assert len(sweeps) == -(-n_db // item)
    assert sweeps[0] >= n_groups
    assert all(s <= n_groups * item for s in sweeps)
    if case in ("sorted", "tight"):
        assert sum(sweeps) < n_groups * n_db  # the items do prune


@pytest.mark.parametrize("d,f_dim", [(2, 2), (2, 4), (3, 2), (3, 4),
                                     (2, 0), (3, 0)])
def test_matched_items_merge_bitwise(d, f_dim):
    """Kernels 4 and 5's schedule (``matched_items``; kernel 5 with F =
    0): the db cut into work items of 1, 2, 3 and 5 chunks of 128, each
    swept ascending, the items merged lexicographically, the payload read
    at the winner.  Bitwise equal to the plain version (one ascending
    sweep; ``nn_sweep_plain`` for F = 0) and to brute force, and to
    _nn_matched_2d (F = 0: _nn_pallas_2d) in interpret mode (distances
    within D - 1 ulp), on a batch of two pairs: one whose db holds every
    point twice, 320 apart, so that ties straddle item boundaries, and one
    fully masked."""
    rng = np.random.default_rng(90 + 4 * d + f_dim)
    base = rng.uniform(-3, 3, (320, d)).astype(np.float32)
    db = np.stack([np.concatenate([base, base]),
                   rng.uniform(-3, 3, (640, d)).astype(np.float32)])
    dm = np.stack([np.ones(640, bool), np.zeros(640, bool)])
    query = np.stack([base[rng.permutation(320)[:300]],
                      rng.uniform(-3, 3, (300, d)).astype(np.float32)])
    query[0, 150:] += rng.normal(0, 0.05, (150, d)).astype(np.float32)
    pay = rng.normal(size=(2, 640, f_dim)).astype(np.float32)
    packed = [_packed(query[k], db[k], dm[k], pay[k], 256, 640)
              for k in range(2)]
    qp = _t(np.stack([p[0] for p in packed]))
    dbf = _t(np.stack([p[1] for p in packed]))
    plain = sw.nn_matched_plain(qp, dbf, d)
    if not f_dim:
        assert all(torch.equal(a, b) for a, b in
                   zip(sw.nn_sweep_plain(qp, dbf), plain))
    for item in (1, 2, 3, 5):
        *got, n_items = sw.matched_items(qp, dbf, d, item)
        assert n_items == -(-5 // item)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    for k in range(2):
        q_k, db_k = jnp.asarray(packed[k][0]), jnp.asarray(packed[k][1])
        if f_dim:
            want = j_pallas._nn_matched_2d(q_k, db_k, d_dim=d, q_tile=256,
                                           db_tile=640, interpret=True)
            np.testing.assert_array_equal(got[2][k].numpy(),
                                          np.array(want[2]))
        else:
            want = j_pallas._nn_pallas_2d(q_k, db_k, q_tile=256,
                                          db_tile=640, interpret=True)
            assert got[2].shape[-1] == 0
        np.testing.assert_array_equal(got[1][k].numpy(), np.array(want[1]))
        _close(got[0][k].numpy(), want[0], d)
    brute = nn.nn_torch(_t(query[0]), _t(db[0]))
    assert torch.equal(got[1][0, :300], brute.index)
    assert torch.equal(got[0][0, :300], brute.dist_sq)
    assert bool((got[1][0] < 320).all())
    assert bool(torch.isinf(got[0][1]).all()) and not bool(got[1][1].any())
    assert not bool(got[2][1].any())
    # Kernel 4's work items: the fewest that give MATCHED_BLOCKS blocks,
    # or one chunk each.
    for b, qp, m_pad in ((8, 28160, 28672), (1, 3072, 4096), (1, 512, 4096),
                         (64, 4096, 4096)):
        t = sw.matched_item_chunks(b, qp, m_pad)
        blocks = b * -(-qp // (sw.MATCHED_THREADS * sw.MATCHED_Q))
        n_items = -(-(m_pad // 128) // t)
        assert t == 1 or blocks * n_items >= sw.MATCHED_BLOCKS
        assert blocks * (n_items - 1) < sw.MATCHED_BLOCKS


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("m", [900, 1500])
def test_nearest_neighbor_matches_nn_pallas_and_nn_xla(d, m):
    """The unmatched route: kernel 5 below 3 tiles, kernel 6 from 3."""
    query, db, dm, _ = _cloud(30 + d + m, 600, m, d)
    want = j_pallas.nn_pallas(jnp.asarray(query), jnp.asarray(db),
                              jnp.asarray(dm), q_tile=512, db_tile=DB_TILE,
                              interpret=True)
    got = nn.nearest_neighbor(_t(query), _t(db), _t(dm), backend="cuda",
                              tile=DB_TILE, q_tile=512)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    _close(got.dist_sq.numpy(), want.dist_sq, d)
    xla = j_nn.nn_xla(jnp.asarray(query), jnp.asarray(db), jnp.asarray(dm),
                      tile=DB_TILE)
    np.testing.assert_array_equal(got.index.numpy(), np.array(xla.index))


@pytest.mark.parametrize("case", ["unseeded-f4", "small-seeded-f2",
                                  "small-unseeded-f4"])
def test_nearest_neighbor_matched_routes_match_nn_pallas_matched(case):
    """The matched routes off the survivor lists: kernel 6 with payload
    (unseeded, 3 tiles), kernel 4 (fewer than 3 tiles, seeded or not)."""
    f_dim = 4 if case.endswith("f4") else 2
    m = 1500 if case.startswith("unseeded") else 1000
    query, db, dm, pay = _cloud(40 + m, 500, m, 3)
    pay = pay[:, :f_dim]
    qb = None
    if case.startswith("small-seeded"):
        qb = np.array(j_nn.nn_xla(jnp.asarray(query), jnp.asarray(db),
                                  jnp.asarray(dm)).dist_sq) * 1.0001
    want, want_p = j_pallas.nn_pallas_matched(
        jnp.asarray(query), jnp.asarray(db), jnp.asarray(dm),
        payload=jnp.asarray(pay), q_tile=256, db_tile=DB_TILE,
        interpret=True, q_bound=None if qb is None else jnp.asarray(qb))
    got, got_p = nn.nearest_neighbor_matched(
        _t(query), _t(db), _t(dm), payload=_t(pay), backend="cuda",
        tile=DB_TILE, q_tile=256, q_bound=None if qb is None else _t(qb))
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    _close(got.dist_sq.numpy(), want.dist_sq, 3)


@pytest.mark.parametrize("d", [2, 3])
def test_batched_routes_match_vmapped_kernels(d):
    """A batch axis: kernel 5 (unmatched) and kernel 4 (matched, off the
    pair-grid route: more than 4096 db points), one grid axis here, vmapped
    in JAX; one pair's db fully masked."""
    rng = np.random.default_rng(50 + d)
    query = rng.uniform(-3, 3, (3, 200, d)).astype(np.float32)
    db = rng.uniform(-3, 3, (3, 1000, d)).astype(np.float32)
    dm = rng.random((3, 1000)) > 0.3
    dm[1] = False
    want = j_pallas.nn_pallas(jnp.asarray(query), jnp.asarray(db),
                              jnp.asarray(dm), q_tile=256, db_tile=DB_TILE,
                              interpret=True, prune=False)
    got = nn.nearest_neighbor(_t(query), _t(db), _t(dm), backend="cuda",
                              tile=DB_TILE, q_tile=256)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    _close(got.dist_sq.numpy(), want.dist_sq, d)
    assert torch.isinf(got.dist_sq[1]).all() and (got.index[1] == 0).all()
    big = rng.uniform(-3, 3, (2, 4097, d)).astype(np.float32)
    qb = np.zeros((2, 200), np.float32)
    want, want_p = j_pallas.nn_pallas_matched(
        jnp.asarray(query[:2]), jnp.asarray(big), q_tile=256,
        db_tile=2048, interpret=True, prune=False)
    got, got_p = nn.nearest_neighbor_matched(
        _t(query[:2]), _t(big), backend="cuda", tile=2048, q_tile=256,
        q_bound=_t(qb))
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    _close(got.dist_sq.numpy(), want.dist_sq, d)
    cuda = ICPConfig(nn_backend="cuda", nn_dst_tile=2048)
    assert nn.route(_t(query), _t(db), d, cuda).kind == "pairs"
    assert nn.route(_t(query[:2]), _t(big), d, cuda).kind == "sweep"


def test_ties_pick_the_lowest_index_in_every_sweep():
    """Every db point twice, queries on db points: kernels 4, 5 and 6 (and
    the zig-zag's descending segment) all pick the first copy."""
    rng = np.random.default_rng(60)
    base = rng.uniform(-3, 3, (800, 3)).astype(np.float32)
    db = np.concatenate([base, base])
    query = base[rng.permutation(800)[:600]]
    for m, q_tile in ((1600, 512), (1600, 256), (800, 256)):
        want = j_pallas.nn_pallas(jnp.asarray(query), jnp.asarray(db[:m]),
                                  q_tile=q_tile, db_tile=DB_TILE,
                                  interpret=True)
        got = nn.nearest_neighbor(_t(query), _t(db[:m]), backend="cuda",
                                  tile=DB_TILE, q_tile=q_tile)
        np.testing.assert_array_equal(got.index.numpy(),
                                      np.array(want.index))
        assert (got.dist_sq == 0).all()
        res, pay = nn.nearest_neighbor_matched(
            _t(query), _t(db[:m]), backend="cuda", tile=DB_TILE,
            q_tile=q_tile)
        np.testing.assert_array_equal(res.index.numpy(),
                                      np.array(want.index))
        assert torch.equal(pay, _t(query))
    assert (got.index.numpy() < 800).all()


@pytest.mark.parametrize("m", [1000, 1600])
def test_all_masked_db_gives_inf_index_0_and_zero_payload(m):
    """A fully masked db: +inf, index 0 and zero payload on every route,
    as _nn_matched_kernel's epilogue gives.  _nn_pruned_kernel's
    descending segment updates on '<=', so on the TPU the query tiles that
    wrap to tile 0 carry db point 0's payload instead; the port keeps the
    zeros (ROADMAP §3)."""
    rng = np.random.default_rng(70)
    query = rng.uniform(-3, 3, (600, 3)).astype(np.float32)
    db = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    pay = rng.normal(size=(m, 4)).astype(np.float32)
    dm = np.zeros(m, bool)
    want, want_p = j_pallas.nn_pallas_matched(
        jnp.asarray(query), jnp.asarray(db), jnp.asarray(dm),
        payload=jnp.asarray(pay), q_tile=256, db_tile=DB_TILE,
        interpret=True)
    got, got_p = nn.nearest_neighbor_matched(
        _t(query), _t(db), _t(dm), payload=_t(pay), backend="cuda",
        tile=DB_TILE, q_tile=256)
    np.testing.assert_array_equal(got.index.numpy(), np.array(want.index))
    assert torch.isinf(got.dist_sq).all() and (got.index == 0).all()
    assert (got_p == 0).all()
    if m < 3 * DB_TILE:
        np.testing.assert_array_equal(got_p.numpy(), np.array(want_p))
    got = nn.nearest_neighbor(_t(query), _t(db), _t(dm), backend="cuda",
                              tile=DB_TILE)
    assert torch.isinf(got.dist_sq).all() and (got.index == 0).all()


def test_auto_dispatch_and_float64():
    """"auto" mirrors use_pallas_nn: a batched query against dbs of at most
    4096 points takes the plain sweep (batched small), float64 the plain
    sweep; "cuda" on float64 runs the plain versions in float64."""
    rng = np.random.default_rng(80)
    query = _t(rng.uniform(-3, 3, (2, 100, 2)))
    db = _t(rng.uniform(-3, 3, (2, 1600, 2)))
    got = nn.nearest_neighbor(query, db, backend="cuda", tile=DB_TILE,
                              q_tile=256)
    want = nn.nn_torch(query, db)
    assert torch.equal(got.index, want.index)
    np.testing.assert_allclose(got.dist_sq.numpy(), want.dist_sq.numpy(),
                               rtol=1e-15, atol=0)
    q1 = query[0].to(torch.float32)
    d1 = db[0].to(torch.float32)
    assert torch.equal(nn.nearest_neighbor(q1, d1, tile=DB_TILE).index,
                       nn.nn_torch(q1, d1).index)
    with pytest.raises(ValueError, match="q_tile"):
        nn.nearest_neighbor(q1, d1, backend="cuda", q_tile=200)
