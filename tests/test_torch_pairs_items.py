"""The schedules of the pair kernels' redesigns, emulated on tensors on the
CPU: kernel 8 (``nn_pairs``: each pair's chunks cut into work items over
blocks, each walking the chunks that pass its subtiles' seed prune test,
merged lexicographically), kernel 9 (``nn_pairs_list``: each subtile's
survivor-list walk cut into work items over blocks, merged
lexicographically) and kernel 10
(``icp2d_frame_pairs``: each pair's 1-NN sweep cut over a cluster's blocks
and each block's threads, limited to the rows up to the last valid ones).

Tolerance: none.  Each emulation must be bitwise equal to the one sweep it
replaces (the plain versions, which the JAX package's interpret-mode
kernels hold in tests/test_torch_batched.py) and to a brute-force
first-minimum sweep, indices, distances and payload, with the lowest index
winning ties.
"""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.ops import align2d_cuda, nn_pairs_cuda
from icp_rust_tpu_torch.ops.nn import nn_torch
from icp_rust_tpu_torch.ops.nn_cuda import _SENTINEL, _trim_sentinel

EPS = float(np.finfo(np.float32).eps)


def _pairs(case, b=3, n=300, m=700, seed=0):
    """Queries, dbs, masks and the kernel's inputs (q_sub 128) for one
    case: tight bounds over a half-masked db (one pair fully masked),
    exact ties, or subtiles with an empty list (-inf bounds) beside full
    ones (+inf)."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-3, 3, (b, n, 2)).astype(np.float32))
    db = torch.as_tensor(rng.uniform(-3, 3, (b, m, 2)).astype(np.float32))
    dm = torch.as_tensor(rng.random((b, m)) > 0.5)
    if case == "ties":
        db[:, m // 2:2 * (m // 2)] = db[:, :m // 2]
        dm[:, m // 2:2 * (m // 2)] = dm[:, :m // 2]
        q[:, :m // 2] = db[:, :min(n, m // 2)]
    if case == "half-masked":
        dm[1] = False
    brute = nn_torch(q, db, dm)
    qb = brute.dist_sq * (1.0 + 32.0 * EPS)
    if case == "empty-and-full":
        qb = torch.full_like(qb, float("inf"))
        qb[:, :128] = float("-inf")
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(q, db, dm, db, qb, 128)
    lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, 2, 128,
                                               64)
    return q, db, dm, (query_p, dbf, lists, cnt, 2, 128, qb_p, cbox)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("item", [1, 2, 3, 6])
@pytest.mark.parametrize("case", ["half-masked", "ties", "empty-and-full"])
def test_pairs_list_items_are_the_ascending_walk(case, item, grouped):
    """Kernel 9's work items, with and without its per-group test (groups
    of LIST_WARP queries skipping listed chunks that fail their own
    test): bitwise equal to the plain version, which makes the same test,
    and on the valid queries to brute force and to the plain version of
    the union lists alone."""
    q, db, dm, args = _pairs(case)
    lists, cnt = args[2], args[3]
    union = nn_pairs_cuda.nn_pairs_list_plain(*args[:6])
    if not grouped:
        args = args[:6]
    if case == "empty-and-full":
        assert not bool(cnt[:, 0].any())
        assert bool((cnt[:, 1:] == lists.shape[-1]).all())
    got = nn_pairs_cuda.pairs_list_items(*args, item=item)
    want = nn_pairs_cuda.nn_pairs_list_plain(*args)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    assert got[3] == int((-(-cnt.long() // item)).sum())
    lo = 128 if case == "empty-and-full" else 0
    n = q.shape[1]
    if lo:
        assert bool(torch.isinf(got[0][:, :lo]).all())
        assert not bool(got[1][:, :lo].any() or got[2][:, :lo].any())
    for a, b in zip(got[:3], union):
        assert torch.equal(a[:, :n], b[:, :n])
    if grouped:
        walks = nn_pairs_cuda.group_walks(*args)
        assert walks <= nn_pairs_cuda.group_walks(*args[:6])
    brute = nn_torch(q[:, lo:], db, dm)
    assert torch.equal(got[1][:, lo:n], brute.index)
    assert torch.equal(_trim_sentinel(got[0][:, lo:n]), brute.dist_sq)
    hit = torch.isfinite(brute.dist_sq)
    pay = torch.take_along_dim(db, brute.index[..., None].long(), dim=1)
    assert torch.equal(got[2][:, lo:n][hit], pay[hit])


@pytest.mark.parametrize("item", [1, 2, 3, 6])
@pytest.mark.parametrize("case", ["half-masked", "ties", "empty-and-full"])
def test_pairs_items_are_the_pruned_ascending_sweep(case, item):
    """Kernel 8's work items with its seed prune (subtiles of 128 queries,
    tight bounds over a half-masked db with one pair fully masked, exact
    ties, -inf and +inf subtiles): bitwise equal to the plain version and,
    on the valid queries, to brute force; the work items that stage a
    chunk counted per query group of 128 x Q queries."""
    q, db, dm, args = _pairs(case)
    query_p, dbf, _, _, d_dim, q_sub, qb_p, cbox = args
    kargs = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, q_sub), cbox,
             nn_pairs_cuda._group_bounds(qb_p, q_sub), d_dim, q_sub)
    want = nn_pairs_cuda.nn_pairs_plain(*kargs)
    walk = nn_pairs_cuda._box_lower_bound(kargs[2], cbox, d_dim) \
        <= kargs[4][..., None]
    n_ch = dbf.shape[2] // 128
    for qpt in (1, 2, 4):
        got = nn_pairs_cuda.pairs_items(*kargs, item=item, q_per_thread=qpt)
        for a, b in zip(got[:3], want):
            assert torch.equal(a, b)
        assert got[3] <= walk.shape[0] * -(-query_p.shape[1] // (128 * qpt)) \
            * -(-n_ch // item)
        assert (got[3] == 0) == (not bool(walk.any()))
    lo = 128 if case == "empty-and-full" else 0
    n = q.shape[1]
    if lo:
        assert bool(torch.isinf(want[0][:, :lo]).all())
        assert not bool(want[1][:, :lo].any() or want[2][:, :lo].any())
    brute = nn_torch(q[:, lo:], db, dm)
    assert torch.equal(want[1][:, lo:n], brute.index)
    assert torch.equal(_trim_sentinel(want[0][:, lo:n]), brute.dist_sq)
    hit = torch.isfinite(brute.dist_sq)
    pay = torch.take_along_dim(db, brute.index[..., None].long(), dim=1)
    assert torch.equal(want[2][:, lo:n][hit], pay[hit])


def test_pairs_item_chunks_rule():
    """Kernel 8's work items (``pairs_item_chunks``): the largest of at
    most PAIRS_ITEM_MAX chunks that gives PAIRS_BLOCKS blocks, the whole
    db where the query groups alone do and it is no larger (as at the
    batched path's cold call), one chunk where none does; at batched
    p2l's warm searches over 28,800-point dbs, PAIRS_ITEM_MAX."""
    rule = nn_pairs_cuda.pairs_item_chunks
    blocks = nn_pairs_cuda.PAIRS_BLOCKS
    cap = nn_pairs_cuda.PAIRS_ITEM_MAX
    assert rule(209, 768, 768) == 6
    assert rule(95, 28928, 28800) == cap == 64
    for b, qp, m_pad in ((209, 768, 768), (4, 768, 4096), (1, 256, 128),
                         (10 ** 4, 768, 768), (40, 768, 768),
                         (95, 28928, 28800), (8, 28928, 28800),
                         (1, 28928, 28800)):
        groups = b * -(-qp // (128 * nn_pairs_cuda.PAIRS_Q))
        item = rule(b, qp, m_pad)
        n_items = -(-(m_pad // 128) // item)
        assert 1 <= item <= min(m_pad // 128, cap)
        assert item == 1 or groups * n_items >= blocks
        assert item == min(m_pad // 128, cap) \
            or groups * -(-(m_pad // 128) // (item + 1)) < blocks


def test_list_schedule_keeps_a_warp_a_block():
    assert nn_pairs_cuda.list_schedule(256, 6) == (
        min(nn_pairs_cuda.LIST_ITEM, 6), nn_pairs_cuda.LIST_Q)
    item, q = nn_pairs_cuda.list_schedule(64, 1)
    assert item == 1 and 64 // q >= 32


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_frame_pairs_sweep_is_the_first_minimum(threads, cluster):
    """icp2d_frame_pairs' sweep (``align2d_cuda.frame_sweep``) on a cluster
    of ``cluster`` blocks of ``threads`` threads: the valid rows' matches
    bitwise those of a brute-force first-minimum sweep of all of dst, with
    trailing masked src rows and trailing sentinel dst rows left out of
    the sweep, every dst point twice (ties straddling segments) and queries
    on dst points."""
    rng = np.random.default_rng(threads + cluster)
    n, m = 640, 700
    base = rng.uniform(-3, 3, (m // 2, 2)).astype(np.float32)
    dst = torch.as_tensor(np.concatenate([base, base]))
    query = torch.as_tensor(rng.uniform(-3, 3, (n, 2)).astype(np.float32))
    query[::3] = dst[torch.as_tensor(rng.integers(0, m, len(query[::3])))]
    dst[torch.as_tensor(rng.random(m) < 0.1)] = _SENTINEL
    dst[-90:] = _SENTINEL
    smask = torch.as_tensor(rng.random(n) > 0.2)
    smask[-60:] = False
    ex = query[:, None, 0] - dst[None, :, 0]
    ey = query[:, None, 1] - dst[None, :, 1]
    want_d, want_i = torch.min(ex * ex + ey * ey, dim=1)
    got_d, got_i = align2d_cuda.frame_sweep(query, dst, cluster, threads,
                                            smask)
    n_eff = int(torch.nonzero(smask)[-1]) + 1
    assert torch.equal(got_i[:n_eff], want_i[:n_eff])
    assert torch.equal(got_d[:n_eff], want_d[:n_eff])
    assert bool(torch.isinf(got_d[n_eff:]).all()) and not got_i[n_eff:].any()
    plan = align2d_cuda.frame_sweep_plan(n_eff, m - 90, cluster, threads)
    assert sum(s_n for _, s_n, _, _ in plan) == n_eff
    # dst is cut into segments where a block's slice leaves threads idle.
    segs = max(seg for _, s_n, seg, _ in plan if s_n)
    assert segs > 1 or cluster * threads < 1024


def test_frame_pairs_shape_keeps_every_pair_resident():
    """The wrapper's (blocks a pair, threads a block): at least 3 IRLS
    points a leader thread, the most threads a pair, then the most
    blocks, all B clusters resident and 32 query rows a block."""
    def held(c, t):  # 64 registers a thread: 1,024 threads an SM
        return 132 * 1024 // (c * t)

    shape = align2d_cuda.frame_pairs_shape
    assert shape(1, 768, held) == (16, 512)
    assert shape(209, 768, held) == (2, 256)
    assert shape(64, 1536, held) == (4, 512)
    assert shape(3, 64, held) == (2, 512)
    assert shape(300, 768, held) == (1, 256)
    assert shape(10 ** 6, 768, held) == (1, 256)
