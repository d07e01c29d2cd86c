"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``; without a card each test skips.

Run on a machine with an NVIDIA Hopper card (this file imports no JAX,
and ``--noconftest`` keeps the JAX test setup out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: nn_list, nn_pairs, nn_pairs_list, nn_sweep, nn_matched and
nn_pruned are bitwise equal to their plain versions (indices, distances
and payload) and to a brute-force sweep, nn_sweep, nn_matched and
nn_pruned at every work-item split, nn_pairs and nn_pairs_list at every
schedule, nn_pairs' seed-pruned warm calls over 28,800-point dbs to
nn_matched;
icp2d_frame's result is bitwise the same at every cluster size, and
icp2d_frame_pairs' at every cluster size of one thread count.  irls_loop's medians and sigmas
are bitwise those of the exact median and of gn_stats.  irls_loop,
irls_loop_batched, icp2d_frame, icp2d_frame_pairs and p2l_loop take
their sums in another order than the plain versions: rot and t within
1e-5, equal iteration counts for p2l_loop.  p2l_stats, gn_stats and
gn_stats_batched: each sum and the error within 1e-5 of the
Cauchy-Schwarz bound of its absolute terms, the count exact, sigma within
1e-6 relative (gn_stats' and p2l_stats' bitwise the plain versions', on
every cluster size their rules pick, gn_stats_batched's on every route);
the update from gn_stats' statistics against the einsum update at the
JAX package's gate (delta rtol 2e-4, atol 1e-6).  icp2d_frame_pairs at
64 pairs of 1,536 points, and icp2d_frame on their pair 5, with equal
outer and inner iteration counts, within 1e-5 of the plain version or,
at a float32 nearest-neighbour near-tie, at an exact fixed point of its
outer step within 1e-5 of the plain loop with that tie taken the other
way (chip_smoke.frame_gate).  The voxel hash table on the
card equals the CPU's: keys, counts and drops exact, point sums to
float32 roundoff.  The per-frame odometry runners are bitwise the fused
runners on the card, and a resumed run bitwise the uninterrupted one.
The voxel normals of 95 clouds in one batched pass are bitwise the 95
unbatched calls, with no host synchronise under the normals span.
On four gloo ranks sharing the card, the ring NN is bitwise the search
over the whole cloud, and dp_sp_icp3d_planar on one 28,800-point pair is
within 1 mm of icp3d_planar.  chip_smoke.py runs the same comparisons at
the paths' full sizes.
"""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import icp2d as m_icp
from icp_rust_tpu_torch.models.driver import spatial_sort
from icp_rust_tpu_torch.models.odometry import ate_rmse, \
    run_odometry_fused, run_odometry_p2l_fused
from icp_rust_tpu_torch.ops import align2d, align2d_cuda, align3d, \
    align3d_cuda, cuda_build, nn_cuda, nn_pairs_cuda
from icp_rust_tpu_torch.parallel import batched_icp2d
from icp_rust_tpu_torch.utils import io

pytestmark = pytest.mark.cuda
SOLVER_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NVIDIA Hopper card)")
    return torch.device("cuda")


def _cloud(dev, m=4096, q=1000, seed=0):
    from icp_rust_tpu_torch.ops.nn import morton_order

    rng = np.random.default_rng(seed)
    db = torch.as_tensor(rng.uniform(-3, 3, (m, 3)), dtype=torch.float32,
                         device=dev)
    mask = torch.as_tensor(rng.random(m) > 0.1, device=dev)
    order = morton_order(db, mask).long()
    db, mask = db[order], mask[order]
    query = db[:q] + torch.as_tensor(rng.normal(0, 0.02, (q, 3)),
                                     dtype=torch.float32, device=dev)
    return query, db, mask


@pytest.mark.parametrize("bound", ["cold", "warm", "full"])
def test_nn_list_kernel_bitwise_equal_to_plain(dev, bound):
    query, db, mask = _cloud(dev)
    pack = nn_cuda.pack_db(db, mask, db[:, :2], db_tile=512)
    qp = torch.zeros((1024, 3), device=dev)
    qp[:1000] = query
    cap = pack.dbf_cm.shape[1] // 128
    if bound == "cold":
        qb = nn_cuda._center_bound(qp, pack.cbox, 3)
    elif bound == "warm":
        qb = torch.full((1024,), 0.05, device=dev)
    else:
        qb = torch.full((1024,), 1e30, device=dev)
    lists, cnt = nn_cuda._survivor_lists(qp, pack.cbox, qb, 3, 256, cap)
    before = cuda_build.LAUNCHES["nn_list"]
    got = nn_cuda.nn_list(qp, pack.dbf_cm, lists, cnt, 3, 256, cap)
    assert cuda_build.LAUNCHES["nn_list"] == before + 1
    want = nn_cuda.nn_list_plain(qp, pack.dbf_cm, lists, cnt, 3, 256, cap)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("length", ["0", "1", "S", "S+1", "all",
                                    "overflow"])
def test_nn_list_kernel_at_item_boundaries(dev, length):
    """Lists of 0, 1, S, S + 1 and every chunk (the cap lifted), and
    cnt > cap (every chunk walked): bitwise equal to the plain version,
    one launch, and two launches bitwise equal (the merge runs in item
    order, whatever order the blocks finish in)."""
    query, db, mask = _cloud(dev, m=8192, q=1000, seed=4)
    db[1::2] = db[0::2]  # exact ties between neighbouring chunks
    pack = nn_cuda.pack_db(db, mask, db[:, :2], db_tile=512)
    n_chunks = pack.dbf_cm.shape[1] // 128
    s = nn_cuda.ITEM_CHUNKS
    walk = {"0": 0, "1": 1, "S": s, "S+1": s + 1, "all": n_chunks,
            "overflow": n_chunks}[length]
    cap = s if length == "overflow" else n_chunks
    qp = torch.zeros((1024, 3), device=dev)
    qp[:1000] = query
    gen = torch.Generator(device="cpu").manual_seed(walk)
    lists = torch.zeros((4, cap), dtype=torch.int32)
    for tile in range(4):
        ids = torch.sort(torch.randperm(n_chunks, generator=gen)[:min(
            walk, cap)]).values
        lists[tile, :len(ids)] = ids.to(torch.int32)
    lists = lists.to(dev)
    cnt = torch.full((4,), cap + 1 if length == "overflow" else walk,
                     dtype=torch.int32, device=dev)
    args = (qp, pack.dbf_cm, lists, cnt, 3, 256, cap)
    before = cuda_build.LAUNCHES["nn_list"]
    got = nn_cuda.nn_list(*args)
    again = nn_cuda.nn_list(*args)
    assert cuda_build.LAUNCHES["nn_list"] == before + 2
    want = nn_cuda.nn_list_plain(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    if walk == 0:
        assert bool(torch.isinf(got[0]).all()) and not bool(got[1].any())


def test_kernels_refuse_float64(dev):
    q = torch.zeros((256, 3), dtype=torch.float64, device=dev)
    dbf = torch.zeros((5, 2048), dtype=torch.float64, device=dev)
    lists = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    cnt = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        nn_cuda.nn_list(q, dbf, lists, cnt, 3, 256, 16)
    x = torch.zeros((128, 2), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        align2d_cuda.irls_loop(x, x, torch.ones(128, dtype=torch.bool,
                                                device=dev),
                               1.345, 1e-9, 1e-6, 200, 1.0)


def _pair(dev, n=600, pad=768, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    dst = src @ np.array([[c, -s], [s, c]], np.float32).T + np.float32(0.1)
    dst = dst + rng.normal(0, 0.01, dst.shape).astype(np.float32)
    out = []
    for a in (src, dst[rng.permutation(n)]):
        p, m = io.pad_points([a], pad_to=pad)
        out += [torch.as_tensor(p[0], dtype=torch.float32, device=dev),
                torch.as_tensor(m[0], device=dev)]
    return out


def test_irls_loop_kernel_matches_plain(dev):
    sp, sm, dp, _ = _pair(dev)
    cfg = ICPConfig(det_rel_eps=1e-9)
    args = (sp, dp, sm, cfg.huber_k, cfg.det_rel_eps,
            cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    rot, t, it = align2d_cuda.irls_loop(*args)
    rot_p, t_p, it_p = align2d_cuda.irls_loop_plain(*args)
    assert int(it) == it_p
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)


@pytest.mark.parametrize("n_valid", [1000, 999])
def test_irls_loop_kernel_odd_and_even_counts(dev, n_valid):
    sp, sm, dp, _ = _pair(dev, n=1000, pad=1000, seed=2)
    sm = sm.clone()
    sm[n_valid:] = False
    args = (sp, dp, sm, 1.345, 1e-9, 1e-6, 200, 1.0)
    rot, t, it = align2d_cuda.irls_loop(*args)
    rot_p, t_p, it_p = align2d_cuda.irls_loop_plain(*args)
    assert int(it) == it_p
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)


@pytest.mark.parametrize("n_valid", [None, 1, 0])
def test_irls_loop_kernel_degenerate_is_identity(dev, n_valid):
    sp, sm, _, _ = _pair(dev, n=256, pad=256, seed=3)
    dp, sm = sp.clone(), sm.clone()
    if n_valid is not None:
        sm[n_valid:] = False
        dp += 0.1
    rot, t, _ = align2d_cuda.irls_loop(sp, dp, sm, 1.345, 1e-9, 1e-6, 200,
                                       1.0)
    assert torch.equal(rot, torch.eye(2, device=dev))
    assert torch.equal(t, torch.zeros(2, device=dev))


def _correspondences(dev, n, seed):
    """n matched points: dst = R src + t + noise, every 17th an outlier."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 2))
    c, s = np.cos(0.02), np.sin(0.02)
    dst = src @ np.array([[c, -s], [s, c]]).T + [0.15, -0.1]
    dst += rng.normal(0, 0.02, dst.shape)
    dst[::17] += 2.0
    return (torch.as_tensor(src, dtype=torch.float32, device=dev),
            torch.as_tensor(dst, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n", [0, 1, 999, 1000, 1001, 28800, 140000,
                               "strided"])
def test_irls_loop_cluster_medians_bitwise_and_counts(dev, n):
    """The cluster kernel at an all-masked input, one point, an odd and an
    even count, a count that is not a multiple of the cluster, the main
    path's 28,800 points, slices too large to stage (140,000), and
    strided views: rot and t within SOLVER_TOL of the plain loop with
    equal iterations; the first iteration's medians bitwise equal to the
    exact masked median of the residuals, its sigmas bitwise equal to
    gn_stats' at the identity (the one-block median code of irls.cuh)."""
    from icp_rust_tpu_torch.ops import robust

    size = 28800 if n == "strided" else max(n, 256 if n == 0 else 1)
    src, dst = _correspondences(dev, size, seed=size)
    mask = torch.full((size,), n != 0, dtype=torch.bool, device=dev)
    if n == "strided":
        wide = torch.zeros((size, 3), device=dev)
        wide[:, 1:] = src
        src = wide[:, 1:]
        dst = dst.T.contiguous().T
        mask = torch.ones((2 * size,), dtype=torch.bool, device=dev)[::2]
        assert not (src.is_contiguous() or dst.is_contiguous()
                    or mask.is_contiguous())
    args = (src, dst, mask, 1.345, 1e-9, 1e-6, 200, 1.0)
    out = align2d_cuda.irls_loop_out(*args)
    rot, t, it = align2d_cuda.irls_loop(*args)
    rot_p, t_p, it_p = align2d_cuda.irls_loop_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out[:7], torch.cat([rot.reshape(4), t, it[None]]))
    assert int(it) == int(it_p)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    r = (src - dst).T
    med, _ = robust.masked_median(r, mask[None].expand(r.shape))
    assert torch.equal(out[8:10], med)
    if n == 0:
        assert not bool(out[8:12].any())
        return
    ident = torch.eye(2, device=dev)
    stats = align2d_cuda.gn_stats(src, dst, mask, ident,
                                  torch.zeros(2, device=dev), 1.345)
    assert torch.equal(out[10:12], stats[12:14])


@pytest.mark.parametrize("n,pad,case", [
    pytest.param(600, 768, "plain", id="600-768"),
    pytest.param(1400, 1536, "plain", id="1400-1536"),
    pytest.param(1536, 1536, "plain", id="1536-1536"),
    pytest.param(1536, 1536, "ties", id="ties"),
    pytest.param(1200, 1536, "masked", id="masked"),
    pytest.param(600, 768, "fixed-point", id="fixed-point")])
def test_icp2d_frame_kernel_matches_plain(dev, n, pad, case):
    """Kernel 3 against its plain version within SOLVER_TOL with equal
    outer iteration counts, on its launcher's cluster and on every
    cluster size (each bitwise equal to the launcher's: the matches are
    the same and the leader runs the one IRLS loop): dst with every point
    twice ("ties"), masked src and dst rows, and a pair warm-started at
    the plain version's result, its fixed point."""
    sp, sm, dp, dm = _pair(dev, n=n, pad=pad, seed=1)
    if case == "ties":
        dp = torch.cat([dp[:pad // 2], dp[:pad // 2]])
        dm = torch.cat([dm[:pad // 2], dm[:pad // 2]])
    if case == "masked":
        gen = torch.Generator().manual_seed(3)
        sm = sm & (torch.rand(pad, generator=gen) > 0.2).to(dev)
        dm = dm & (torch.rand(pad, generator=gen) > 0.2).to(dev)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity(device=dev)
    if case == "fixed-point":
        rot_0, t_0, _ = m_icp.icp2d_frame_plain(sp, dp, sm, dm, t0, cfg)
        t0 = RigidTransform2(rot_0, t_0)
    before = cuda_build.LAUNCHES["icp2d_frame"]
    rot, t, it = align2d_cuda.icp2d_frame(sp, dp, sm, dm, t0, cfg)
    assert cuda_build.LAUNCHES["icp2d_frame"] == before + 1
    rot_p, t_p, it_p = m_icp.icp2d_frame_plain(sp, dp, sm, dm, t0, cfg)
    assert int(it) == it_p
    if case == "fixed-point":
        assert int(it) <= 2
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    ref = align2d_cuda.icp2d_frame_raw(sp, dp, sm, dm, t0, cfg)
    _, largs, out, _keep = align2d_cuda._icp2d_frame_args(sp, dp, sm, dm,
                                                          t0, cfg)
    fn = cuda_build.query("icp2d_frame_launch_cluster")
    assert cuda_build.query("icp2d_frame_cluster")(n) == 16
    for c in align2d_cuda.FRAME_CLUSTERS:
        assert fn(*largs[:-1], c, largs[-1]) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, ref), c


def test_odometry_on_the_card_tracks_the_plain_path(dev):
    frames, _ = io.synthesize_frames3d(4, seed=0)
    pts, mask = io.pad_points([f[::4] for f in frames])
    cfg = ICPConfig(nn_dst_tile=1024, det_rel_eps=1e-9)
    cuda_build.reset_launches()
    _, path = run_odometry_fused(pts, mask, cfg)
    assert cuda_build.LAUNCHES["nn_list"] > 0
    assert cuda_build.LAUNCHES["irls_loop"] > 0
    _, plain = run_odometry_fused(
        pts, mask, cfg.with_(nn_backend="torch", align_backend="torch"))
    assert ate_rmse(path, plain) < 1e-3


def _pair_clouds(dev, b=5, n=700, m=900, d=2, seed=4):
    """Per-pair queries and Morton-sorted, partly masked dbs."""
    rng = np.random.default_rng(seed)
    db = torch.as_tensor(rng.uniform(-3, 3, (b, m, d)), dtype=torch.float32,
                         device=dev)
    mask = torch.as_tensor(rng.random((b, m)) > 0.2, device=dev)
    mask[1] = False
    db, mask, _ = spatial_sort(db, mask)
    query = db[:, :n] + torch.as_tensor(rng.normal(0, 0.05, (b, n, d)),
                                        dtype=torch.float32, device=dev)
    return query, db, mask


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_nn_pairs_kernels_bitwise_equal_to_plain(dev, d, warm):
    from icp_rust_tpu_torch.ops.nn import nn_torch

    query, db, mask = _pair_clouds(dev, d=d)
    qb = None
    if warm:
        qb = nn_torch(query, db, mask).dist_sq * 1.0001
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(query, db, mask,
                                                     db[..., :2], qb)
    if warm:
        lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, d,
                                                   256, 64)
        args = (query_p, dbf, lists, cnt, d, 256)
        fn, plain, name = (nn_pairs_cuda.nn_pairs_list,
                           nn_pairs_cuda.nn_pairs_list_plain,
                           "nn_pairs_list")
    else:
        args = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, 256), cbox,
                nn_pairs_cuda._group_bounds(qb_p, 256), d, 256)
        fn, plain, name = (nn_pairs_cuda.nn_pairs,
                           nn_pairs_cuda.nn_pairs_plain, "nn_pairs")
    before = cuda_build.LAUNCHES[name]
    got = fn(*args)
    assert cuda_build.LAUNCHES[name] == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,f_dim", [(2, 2), (2, 3), (2, 4), (3, 2), (3, 3),
                                     (3, 4)])
@pytest.mark.parametrize("bounds", ["cold", "tight", "empty-and-full"])
def test_nn_pairs_schedules_bitwise(dev, d, f_dim, bounds):
    """Kernel 8 at its wrapper's schedule and at work items of 1, 3, 6 and
    32 chunks (the whole 4,096-point db) with 1, 2 and 4 queries a thread
    (700 queries: a ragged last group at 4): bitwise equal to its plain
    version, to its schedule's emulation and to brute force; exact ties
    (the db's first half twice), one pair's db fully masked; +inf
    bounds, tight ones, and a -inf subtile beside +inf ones."""
    from icp_rust_tpu_torch.ops.nn import nn_torch

    rng = np.random.default_rng(40 + 4 * d + f_dim)
    b, n, m = 3, 700, 4096
    half = torch.as_tensor(rng.uniform(-3, 3, (b, m // 2, d)),
                           dtype=torch.float32, device=dev)
    db = torch.cat([half, half], dim=1)
    mask = torch.as_tensor(rng.random((b, m)) > 0.3, device=dev)
    mask[1] = False
    query = db[:, :n] + torch.as_tensor(rng.normal(0, 0.05, (b, n, d)),
                                        dtype=torch.float32, device=dev) \
        * (torch.arange(n, device=dev)[None, :, None] % 2)
    pay = torch.as_tensor(rng.normal(size=(b, m, f_dim)),
                          dtype=torch.float32, device=dev)
    brute = nn_torch(query, db, mask)
    qb = {"cold": None,
          "tight": brute.dist_sq * (1.0 + 32.0 * 1.2e-7),
          "empty-and-full": torch.full((b, n), float("inf"), device=dev)}[
        bounds]
    if bounds == "empty-and-full":
        qb[:, :256] = float("-inf")
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(query, db, mask, pay,
                                                     qb)
    args = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, 256), cbox,
            nn_pairs_cuda._group_bounds(qb_p, 256), d, 256)
    before = cuda_build.LAUNCHES["nn_pairs"]
    got = nn_pairs_cuda.nn_pairs(*args)
    assert cuda_build.LAUNCHES["nn_pairs"] == before + 1
    want = nn_pairs_cuda.nn_pairs_plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    for item in (1, 3, 6, 32):
        emul = nn_pairs_cuda.pairs_items(*args, item=item)[:3]
        for q in (1, 2, 4):
            largs, out, _keep = nn_pairs_cuda._nn_pairs_args(
                *args, item=item, q_per_thread=q)
            assert cuda_build.launcher("nn_pairs")(*largs) == 0
            torch.cuda.synchronize()
            for a, w, e in zip(out, want, emul):
                assert torch.equal(a, w) and torch.equal(a, e)
    lo = 256 if bounds == "empty-and-full" else 0
    hit = torch.isfinite(brute.dist_sq[:, lo:])
    assert torch.equal(got[1][:, lo:n], brute.index[:, lo:])
    assert torch.equal(nn_cuda._trim_sentinel(got[0][:, lo:n]),
                       brute.dist_sq[:, lo:])
    want_pay = torch.take_along_dim(pay, brute.index[..., None].long(),
                                    dim=1)[:, lo:]
    assert torch.equal(got[2][:, lo:n][hit], want_pay[hit])
    assert bool(torch.isinf(got[0][1]).all()) and not bool(got[1][1].any())
    if lo:
        assert bool(torch.isinf(got[0][:, :lo]).all())


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("item", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["warm", "ties", "empty-and-full"])
def test_nn_pairs_list_schedules_bitwise(dev, case, item, q, grouped):
    """Kernel 9 at work items of 1 to all list entries and 1, 2 and 4
    queries a thread, with and without its per-group test: bitwise equal
    to its plain version and to its schedule's emulation; with valid
    lists also to brute force.  Cases: warm bounds over partly masked dbs
    (one pair fully masked), exact ties, and subtiles whose lists are
    empty (-inf bounds) beside full ones (+inf bounds)."""
    from icp_rust_tpu_torch.ops.nn import nn_torch

    query, db, mask = _pair_clouds(dev, m=1000)
    if case == "ties":
        db = torch.cat([db[:, :500], db[:, :500]], dim=1)
        mask = torch.cat([mask[:, :500], mask[:, :500]], dim=1)
        query = db[:, :700].clone()
    brute = nn_torch(query, db, mask)
    qb = brute.dist_sq * 1.0001
    if case == "empty-and-full":
        qb = torch.full_like(qb, float("inf"))
        qb[:, :256] = float("-inf")
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(query, db, mask,
                                                     db[..., :2], qb)
    lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, 2, 256,
                                               64)
    if case == "empty-and-full":
        assert not bool(cnt[:, 0].any()) and bool((cnt[:, 1:] == 8).all())
    args = (query_p, dbf, lists, cnt, 2, 256)
    if grouped:
        args += (qb_p, cbox)
    largs, got, _part = nn_pairs_cuda._nn_pairs_list_args(
        *args, item=item, q_per_thread=q)
    before = cuda_build.LAUNCHES["nn_pairs_list"]
    assert cuda_build.launcher("nn_pairs_list")(*largs) == 0
    assert cuda_build.LAUNCHES["nn_pairs_list"] == before
    torch.cuda.synchronize()
    want = nn_pairs_cuda.nn_pairs_list_plain(*args)
    emul = nn_pairs_cuda.pairs_list_items(*args, item=item)
    for a, b, c in zip(got, want, emul):
        assert torch.equal(a, b) and torch.equal(a, c)
    if case == "empty-and-full":
        assert bool(torch.isinf(got[0][:, :256]).all())
        query, brute = query[:, 256:], nn_torch(query[:, 256:], db, mask)
        got = [x[:, 256:] for x in got]
    n = query.shape[1]
    assert torch.equal(got[1][:, :n], brute.index)
    assert torch.equal(nn_cuda._trim_sentinel(got[0][:, :n]), brute.dist_sq)


@pytest.mark.parametrize("b,n", [(6, 768), (1, 768), (3, 1536), (1, 1536)])
def test_icp2d_frame_pairs_settings_match_plain(dev, b, n):
    """Kernel 10 on the wrapper's (blocks a pair, threads a block) and on
    every setting the card holds all B clusters of: rot and t within 1e-5
    of the plain version with equal outer iterations per pair, bitwise
    equal at one thread count whatever the cluster size; one pair (B = 1)
    and the 1,536-point limit included."""
    sp, sm, dp, dm = _pair_batch(dev, b=b, n=n - 100, pad=n)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity((b,), device=dev)
    args = (sp, dp, sm, dm, t0, cfg)
    before = cuda_build.LAUNCHES["icp2d_frame_pairs"]
    rot, t, its = align2d_cuda.icp2d_frame_pairs(*args)
    assert cuda_build.LAUNCHES["icp2d_frame_pairs"] == before + 1
    rot_p, t_p, its_p = m_icp.icp2d_frame_pairs_plain(*args)
    assert torch.equal(its.to(torch.int32), its_p)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    by_threads = {}
    for c, threads in align2d_cuda.PAIRS_SHAPES:
        if (c > 1 and n < 32 * c) or align2d_cuda._frame_resident(
                n, n, c, threads) < b:
            continue
        _, largs, out, _keep = align2d_cuda._icp2d_frame_args(
            *args, shape=(c, threads))
        assert cuda_build.launcher("icp2d_frame_pairs")(*largs) == 0
        torch.cuda.synchronize()
        assert torch.equal(out[:, 6].to(torch.int32), its_p)
        torch.testing.assert_close(out[:, :4].reshape(b, 2, 2), rot_p,
                                   atol=SOLVER_TOL, rtol=0)
        torch.testing.assert_close(out[:, 4:6], t_p, atol=SOLVER_TOL,
                                   rtol=0)
        ref = by_threads.setdefault(threads, out.clone())
        assert torch.equal(out, ref), (c, threads)
    assert len(by_threads) >= 2


@pytest.fixture(scope="module")
def big_pairs():
    """chip_smoke.py's 64 consecutive pairs of 1,536 synthetic points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NVIDIA Hopper card)")
    import chip_smoke

    return chip_smoke.big_frame_pairs(torch.device("cuda"))


def _plain_inner_iterations(src, dst, smask, dmask, t0, cfg):
    """The plain frame loop's inner iterations on one pair, summed over its
    outer loop."""
    inner = []
    real = align2d.irls_loop_torch

    def spy(*a, **kw):
        res = real(*a, **kw)
        inner.append(int(res[2]))
        return res

    align2d.irls_loop_torch = spy
    try:
        m_icp.icp2d_frame_plain(src, dst, smask, dmask, t0, cfg)
    finally:
        align2d.irls_loop_torch = real
    return sum(inner)


@pytest.mark.parametrize("kernel", ["icp2d_frame_pairs", "icp2d_frame"])
def test_frame_kernels_match_plain_at_1536_points(dev, big_pairs, kernel):
    """Kernel 10 at chip_smoke.py's 64 pairs of 1,536 points, and kernel 3
    on their pair 5 alone, held to chip_smoke.frame_gate: equal outer
    iteration counts per pair, rot and t within 1e-5 (FRAME_TOL) of the
    plain version, or, at a float32 nearest-neighbour near-tie (pair 5,
    ROADMAP.md section 3), a result that is an exact fixed point of the
    plain outer step and within 1e-5 of the plain loop with that tie
    taken the other way; on pair 5 equal inner iteration counts."""
    import chip_smoke

    sp, dp, sm, dm = big_pairs
    cfg = chip_smoke._config()
    pair = 5
    if kernel == "icp2d_frame_pairs":
        t0 = RigidTransform2.identity((sp.shape[0],), device=dev)
        args = (sp, dp, sm, dm, t0, cfg)
        row = pair
    else:
        t0 = RigidTransform2.identity(device=dev)
        args = (sp[pair], dp[pair], sm[pair], dm[pair], t0, cfg)
        row = 0
    out = align2d_cuda.icp2d_frame_raw(*args).reshape(-1, 8)
    plain = m_icp.icp2d_frame_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 6].to(torch.int32), plain[2].reshape(-1))
    _, failed = chip_smoke.frame_gate(args, out[:, :4].reshape(-1, 2, 2),
                                      out[:, 4:6], out[:, 6], plain, kernel)
    assert failed == []
    one = RigidTransform2.identity(device=dev)
    assert int(out[row, 7]) == _plain_inner_iterations(
        sp[pair], dp[pair], sm[pair], dm[pair], one, cfg)


def test_irls_loop_batched_kernel_matches_plain(dev):
    rng = np.random.default_rng(6)
    b, n = 70, 768
    src = torch.as_tensor(rng.uniform(-3, 3, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    dst = src @ torch.tensor([[0.999, 0.04], [-0.04, 0.999]], device=dev) \
        + 0.1 + torch.as_tensor(rng.normal(0, 0.01, (b, n, 2)),
                                dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.2, device=dev)
    mask[3] = False
    mask[4] = False
    mask[4, 0] = True
    args = (src, dst, mask, 1.345, 1e-9, 1e-6, 200, 1.0)
    rot, t, its = align2d_cuda.irls_loop_batched(*args)
    rot_p, t_p, its_p = align2d_cuda.irls_loop_batched_plain(*args)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    assert its[3] == 1 and its[4] == 1
    assert torch.equal(rot[3], torch.eye(2, device=dev))


def _irls_pairs(dev, b, n, seed=11):
    """B pairs of n points with their own rotations and noise (so that
    they stop after different iteration counts), ~20 % masked; the last
    two pairs all-masked and one-point."""
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.uniform(-3, 3, (b, n, 2)), dtype=torch.float32,
                          device=dev)
    th = torch.as_tensor(rng.uniform(-0.2, 0.2, b), dtype=torch.float32,
                         device=dev)
    rot = torch.stack([torch.stack([torch.cos(th), -torch.sin(th)], -1),
                       torch.stack([torch.sin(th), torch.cos(th)], -1)], -2)
    noise = torch.as_tensor(rng.uniform(0.001, 0.05, (b, 1, 1)),
                            dtype=torch.float32, device=dev)
    dst = src @ rot.transpose(-1, -2) + 0.1 + noise * torch.as_tensor(
        rng.normal(size=(b, n, 2)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random((b, n)) > 0.2, device=dev)
    mask[-2] = False
    mask[-1] = False
    mask[-1, n // 2] = True
    return src, dst, mask


@pytest.mark.parametrize("b,n,route", [
    (70, 768, "one block a pair"), (5, 5000, "small clusters"),
    (11, 28160, "clusters of 8"), (1, 28160, "clusters of 16"),
    (3, 140000, "slices in place")])
def test_irls_loop_batched_routes_match_plain(dev, b, n, route):
    """Kernel 7 on each route the wrapper picks (batched_cluster), and on
    one block a pair and every cluster size the card can place: rot and t
    within 1e-5 of the
    plain loop with equal iterations per pair, pairs of unequal counts,
    the all-masked and one-point pairs at the identity after 1
    iteration.  src and dst are strided views, the mask is bool."""
    src, dst, mask = _irls_pairs(dev, b + 2, n)
    both = torch.cat([src, dst], dim=-1)  # read in place, strided
    args = (both[..., :2], both[..., 2:], mask, 1.345, 1e-9, 1e-6, 200, 1.0)
    before = cuda_build.LAUNCHES["irls_loop_batched"]
    rot, t, its = align2d_cuda.irls_loop_batched(*args)
    assert cuda_build.LAUNCHES["irls_loop_batched"] == before + 1
    rot_p, t_p, its_p = align2d_cuda.irls_loop_batched_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(its.to(torch.int32), its_p.to(torch.int32))
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    assert its[-2] == 1 and its[-1] == 1
    assert torch.equal(rot[-2:], torch.eye(2, device=dev).expand(2, 2, 2))
    assert not bool(t[-2:].any())
    if b > 1:
        assert len(set(its[:-2].tolist())) > 1
    routes = [c for c in align2d_cuda.BATCHED_CLUSTERS
              if align2d_cuda._resident(n, c) >= 1]
    if n <= align2d_cuda._BLOCK_ROUTE_MAX_POINTS:
        routes.append(0)
    for c in routes:
        largs, out, _scratch = align2d_cuda._irls_loop_batched_args(
            *args, cluster=c)
        assert cuda_build.launcher("irls_loop_batched")(*largs) == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out[:, :4].reshape(-1, 2, 2), rot_p,
                                   atol=SOLVER_TOL, rtol=0)
        torch.testing.assert_close(out[:, 4:6], t_p, atol=SOLVER_TOL,
                                   rtol=0)


def test_irls_loop_batched_picks_resident_clusters(dev):
    """The wrapper's cluster size keeps every pair's cluster resident at
    once, and at least BATCHED_MIN_POINTS points a block; small pairs take
    one block each."""
    for b, n in ((211, 768), (11, 28160), (1, 28160), (40, 28160)):
        c = align2d_cuda.batched_cluster(
            b, n, lambda k: align2d_cuda._resident(n, k))
        assert (c == 0) == (n <= align2d_cuda.BATCHED_BLOCK_MAX_POINTS)
        assert c <= 1 or (align2d_cuda._resident(n, c) >= b
                          and n >= c * align2d_cuda.BATCHED_MIN_POINTS)
    assert align2d_cuda.batched_cluster(
        11, 28160, lambda k: align2d_cuda._resident(28160, k)) >= 4


def _pair_batch(dev, b=6, n=600, pad=768):
    pairs = [_pair(dev, n=n, pad=pad, seed=10 + i) for i in range(b)]
    return [torch.stack([p[k] for p in pairs]) for k in range(4)]


def test_icp2d_frame_pairs_kernel_matches_plain(dev):
    sp, sm, dp, dm = _pair_batch(dev)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity((sp.shape[0],), device=dev)
    rot, t, its = align2d_cuda.icp2d_frame_pairs(sp, dp, sm, dm, t0, cfg)
    rot_p, t_p, its_p = m_icp.icp2d_frame_pairs_plain(sp, dp, sm, dm, t0,
                                                      cfg)
    assert torch.equal(its.to(torch.int32), its_p)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)


def test_batched_icp2d_on_the_card_tracks_the_plain_path(dev):
    sp, sm, dp, dm = _pair_batch(dev, b=8)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity((sp.shape[0],), device=dev)
    cuda_build.reset_launches()
    out = batched_icp2d(sp, dp, sm, dm, t0, cfg)
    assert cuda_build.LAUNCHES["nn_pairs"] == 1
    k = cuda_build.LAUNCHES["irls_loop_batched"]
    assert k > 1 and cuda_build.LAUNCHES["nn_pairs_list"] == k - 1
    plain = batched_icp2d(sp, dp, sm, dm, t0,
                          cfg.with_(nn_backend="torch", align_backend="torch"))
    torch.testing.assert_close(out.t, plain.t, atol=1e-3, rtol=0)
    cuda_build.reset_launches()
    frame = batched_icp2d(sp, dp, sm, dm, t0, cfg.with_(frame_backend="pairs"))
    assert cuda_build.LAUNCHES["icp2d_frame_pairs"] == 1
    torch.testing.assert_close(frame.t, out.t, atol=1e-3, rtol=0)


def test_frame_launch_span_encloses_the_pair_frame_launch(dev):
    """Under the profiler, a pair-frame ``batched_icp2d`` call opens one
    ``icp.frame_launch`` inside one ``icp.icp2d``, and the runtime launch
    of its one kernel 10 (the host event correlated with the kernel) lies
    inside it; no ``icp.`` range reaches the device timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sp, sm, dp, dm = _pair_batch(dev, b=4)
    cfg = ICPConfig(det_rel_eps=1e-9, frame_backend="pairs")
    t0 = RigidTransform2.identity((sp.shape[0],), device=dev)
    batched_icp2d(sp, dp, sm, dm, t0, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batched_icp2d(sp, dp, sm, dm, t0, cfg)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    host = [e for e in evs if e.device_type() == DeviceType.CPU]
    on_dev = [e for e in evs if e.device_type() != DeviceType.CPU]
    assert not [e.name() for e in on_dev if e.name().startswith("icp.")]

    def bounds(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    (span,) = [bounds(e) for e in host if e.name() == "icp.frame_launch"]
    (entry,) = [bounds(e) for e in host if e.name() == "icp.icp2d"]
    assert entry[0] <= span[0] and span[1] <= entry[1]
    (kernel,) = [e for e in on_dev if "frame_kernel" in e.name()]
    launch = [bounds(e) for e in host if "Launch" in e.name()
              and e.correlation_id() == kernel.correlation_id()]
    assert len(launch) == 1
    assert span[0] <= launch[0][0] and launch[0][1] <= span[1]


def test_batched_kernels_refuse_float64(dev):
    x = torch.zeros((2, 256, 2), dtype=torch.float64, device=dev)
    m = torch.ones((2, 256), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        align2d_cuda.irls_loop_batched(x, x, m, 1.345, 1e-9, 1e-6, 200, 1.0)
    qp, dbf, cbox, qb = nn_pairs_cuda.prepare(x, x, m)
    lists, cnt = nn_pairs_cuda._survivor_lists(qp, cbox, qb, 2, 256, 64)
    with pytest.raises(TypeError):
        nn_pairs_cuda.nn_pairs_list(qp, dbf, lists, cnt, 2, 256)


def _p2l_problem(dev, n=3000, seed=5):
    """Random unit normals, a shifted noisy dst and a partial mask."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dst = src + rng.normal(0, 0.02, (n, 3)) + [0.1, -0.05, 0.03]
    mask = rng.random(n) > 0.15
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (src, dst, nrm)] + [torch.as_tensor(mask, device=dev)]


@pytest.mark.parametrize("case", ["generic", "one-plane", "five-points",
                                  "sigma-0", "all-masked"])
def test_p2l_loop_kernel_matches_plain(dev, case):
    src, dst, nrm, mask = _p2l_problem(dev)
    if case == "one-plane":
        nrm = torch.zeros_like(nrm)
        nrm[:, 2] = 1.0
        dst = src.clone()
        dst[:, 2] += 0.01 + torch.linspace(0, 0.01, src.shape[0], device=dev)
    elif case == "five-points":
        mask = torch.zeros_like(mask)
        mask[:5] = True
    elif case == "sigma-0":
        dst = src.clone()
    elif case == "all-masked":
        mask = torch.zeros_like(mask)
    args = (src, dst, nrm, mask, 1.345, 1e-6, 200, 1.0)
    before = cuda_build.LAUNCHES["p2l_loop"]
    rot, t, it = align3d_cuda.p2l_loop(*args)
    assert cuda_build.LAUNCHES["p2l_loop"] == before + 1
    rot_p, t_p, it_p = align3d_cuda.p2l_loop_plain(*args)
    assert int(it) == int(it_p)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    if case != "generic":
        assert int(it) == 1 and torch.equal(rot, torch.eye(3, device=dev))


# Kernels 12 and 14 at one point, an odd and an even count, SLAM small's
# 3,072, the paths' 28,800, slices too large to stage (140,000) and no
# valid point, beside the first cases' 3,000.
STATS_SIZES = [1, 999, 1000, 3072, 28800, 140000, "all-masked"]


@pytest.mark.parametrize("warm,n", [(False, 3000), (True, 3000)]
                         + [(True, n) for n in STATS_SIZES])
def test_p2l_stats_kernel_matches_plain(dev, warm, n):
    """Kernel 14 through weighted_gn_update_p2l_cuda and alone, on the
    wrapper's cluster and on every cluster size its rule picks
    (align3d_cuda.p2l_cluster): each sum and the error within 1e-5 of its
    Cauchy-Schwarz bound, the count exact, sigma bitwise the plain
    version's (the exact median and MAD of the same residuals)."""
    size = 3000 if n == "all-masked" else n
    src, dst, nrm, mask = _p2l_problem(dev, n=size)
    if n == "all-masked":
        mask[:] = False
    t = RigidTransform3.identity(device=dev)
    if warm:
        t = RigidTransform3.from_twist(torch.tensor(
            [0.09, -0.04, 0.03, 0.01, -0.005, 0.002], device=dev))
    before = cuda_build.LAUNCHES["p2l_stats"]
    upd = align3d.weighted_gn_update_p2l_cuda(t, src, dst, nrm, mask, 1.345)
    assert cuda_build.LAUNCHES["p2l_stats"] == before + 1
    assert bool(upd.ok) == (n not in (1, "all-masked"))
    want = align3d_cuda.p2l_stats_plain(src, dst, nrm, mask, t.rot, t.t,
                                        1.345)
    outs = [align3d_cuda.p2l_stats(src, dst, nrm, mask, t.rot, t.t, 1.345)]
    for c in sorted({align3d_cuda.p2l_cluster(1),
                     align3d_cuda.p2l_cluster(1 << 30)}):
        args, out, _keep = align3d_cuda._p2l_stats_args(
            src, dst, nrm, mask, t.rot, t.t, 1.345, cluster=c)
        assert cuda_build.launcher("p2l_stats")(*args) == 0
        torch.cuda.synchronize()
        outs.append(out)
    for got in outs:
        rel, dn, sig_rel = align3d_cuda.stats_errors(got, want)
        assert rel <= 1e-5 and dn == 0 and sig_rel <= 1e-6
        assert torch.equal(got[29], want[29])
    if n == "all-masked":
        assert not bool(outs[0].any())


def test_p2l_odometry_on_the_card_tracks_the_plain_path(dev):
    frames, _ = io.synthesize_frames3d(4, seed=0)
    pts, mask = io.pad_points([f[::4] for f in frames])
    cfg = ICPConfig(nn_dst_tile=1024, det_rel_eps=1e-9)
    cuda_build.reset_launches()
    _, path = run_odometry_p2l_fused(pts, mask, cfg, 0.45)
    assert cuda_build.LAUNCHES["nn_list"] > 0
    assert cuda_build.LAUNCHES["p2l_loop"] == cuda_build.LAUNCHES["nn_list"]
    _, again = run_odometry_p2l_fused(pts, mask, cfg, 0.45)
    assert np.array_equal(path, again)  # deterministic on the card
    _, plain = run_odometry_p2l_fused(
        pts, mask, cfg.with_(nn_backend="torch", align_backend="torch"), 0.45)
    assert ate_rmse(path, plain) < 1e-3


def test_voxel_normals_batch_is_one_pass_bitwise_its_lanes(dev):
    """vlp16's 95 destination clouds (``synthesize_frames3d(96, seed=0)``'s
    frames 1-95, padded to 28,800) in one voxel-normal pass: each lane
    bitwise the unbatched call on it, one pass of 95 lanes; and the
    ``icp.normals`` span (``models/icp_p2l``'s) holds no host synchronise,
    read from the profiler's trace as ``bench_port/spans.py`` reads the
    cell's (a pageable copy in a span of its own shows the reader sees
    one)."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port import spans, tracing
    from icp_rust_tpu_torch.ops import normals
    from icp_rust_tpu_torch.utils.profiling import annotate

    frames, _ = io.synthesize_frames3d(96, seed=0)
    pts, mask = io.pad_points(frames[1:], 28800)
    dst = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    dmask = torch.as_tensor(mask, device=dev)
    normals.estimate_normals_voxel(dst, dmask, 0.3)  # warm-up
    torch.cuda.synchronize()
    normals.reset_passes()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with annotate("icp.normals"):
            n_b, ok_b = normals.estimate_normals_voxel(dst, dmask, 0.3)
        with annotate("icp.control"):
            torch.tensor(1.0, device=dev)
        torch.cuda.synchronize()
    assert normals.PASSES == {"voxel_passes": 1, "voxel_lanes": 95}
    trace = tracing.collect(prof)
    by_span = spans.syncs(trace, spans.pieces(trace))
    assert by_span.get("icp.control", 0) >= 1, by_span
    assert by_span.get("icp.normals", 0) == 0, by_span
    for lane in range(95):
        n_u, ok_u = normals.estimate_normals_voxel(dst[lane], dmask[lane],
                                                   0.3)
        assert torch.equal(n_b[lane], n_u), lane
        assert torch.equal(ok_b[lane], ok_u), lane
    assert int(ok_b.sum()) > 0.9 * int(dmask.sum())


def test_p2l_kernels_refuse_float64(dev):
    x = torch.zeros((256, 3), dtype=torch.float64, device=dev)
    m = torch.ones(256, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        align3d_cuda.p2l_loop(x, x, x, m, 1.345, 1e-6, 200, 1.0)
    with pytest.raises(TypeError):
        align3d_cuda.p2l_stats(x, x, x, m, torch.eye(3, device=dev),
                               torch.zeros(3, device=dev), 1.345)


@pytest.mark.parametrize("n", [0, 5, 6, 999, 1000, 3072, 28800, 140000])
def test_p2l_loop_cluster_medians_bitwise_and_counts(dev, n):
    """The cluster kernel at no valid point, 5 (too few: identity), 6, an
    odd and an even count, SLAM small's 3,072 points, the p2l path's
    28,800 and slices too large to stage (140,000): rot and t within
    SOLVER_TOL of the plain loop with equal iterations; the first
    iteration's median and MAD bitwise equal to the exact masked median
    (torch.kthvalue), its sigma bitwise equal to p2l_stats' at the
    identity (the one-block median code of p2l.cuh)."""
    import chip_smoke

    size = max(n, 256)
    src, dst, nrm, mask = _p2l_problem(dev, n=size, seed=size)
    mask = torch.arange(size, device=dev) < n
    args = (src, dst, nrm, mask, 1.345, 1e-6, 200, 1.0)
    out = align3d_cuda.p2l_loop_out(*args)
    rot, t, it = align3d_cuda.p2l_loop(*args)
    rot_p, t_p, it_p = align3d_cuda.p2l_loop_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out[:13], torch.cat([rot.reshape(9), t, it[None]]))
    assert int(it) == int(it_p)
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    if n < 6:
        assert int(it) == 1 and torch.equal(rot, torch.eye(3, device=dev))
    if n == 0:
        assert not bool(out[13:16].any())
        return
    assert chip_smoke.p2l_first_stats(src, dst, nrm, mask, 1.345)


def test_p2l_loop_reads_strided_views_and_a_bool_mask(dev):
    """src, dst and normals as columns of one (N, 9) tensor and a strided
    bool mask give bitwise the output of contiguous inputs and a float
    mask."""
    src, dst, nrm, mask = _p2l_problem(dev, n=28800, seed=9)
    wide = torch.cat([src, dst, nrm], dim=1)
    views = (wide[:, 0:3], wide[:, 3:6], wide[:, 6:9])
    strided = torch.zeros(2 * mask.shape[0], dtype=torch.bool, device=dev)
    strided[::2] = mask
    assert not any(v.is_contiguous() for v in views)
    got = align3d_cuda.p2l_loop_out(*views, strided[::2], 1.345, 1e-6, 200,
                                    1.0)
    want = align3d_cuda.p2l_loop_out(src, dst, nrm, mask.float(), 1.345,
                                     1e-6, 200, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _sweep_cloud(dev, b=None, q=700, m=1500, d=3, seed=5, sort=False):
    """Queries near a partly masked db (optionally Morton-sorted), with a
    4-row payload; a leading batch axis of ``b``."""
    rng = np.random.default_rng(seed)
    shape = () if b is None else (b,)
    db = torch.as_tensor(rng.uniform(-3, 3, (*shape, m, d)),
                         dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random((*shape, m)) > 0.2, device=dev)
    if sort:
        db, mask, _ = spatial_sort(db, mask)
    query = db[..., :q, :] + torch.as_tensor(
        rng.normal(0, 0.05, (*shape, q, d)), dtype=torch.float32, device=dev)
    pay = torch.as_tensor(rng.normal(size=(*shape, m, 4)),
                          dtype=torch.float32, device=dev)
    return query, db, mask, pay


def _brute_equal(got_idx, got_dist, got_pay, query, db, mask, pay):
    from icp_rust_tpu_torch.ops.nn import nn_torch

    want = nn_torch(query, db, mask)
    assert torch.equal(got_idx, want.index)
    assert torch.equal(got_dist, want.dist_sq)
    if got_pay is not None:
        hit = torch.isfinite(want.dist_sq)
        want_pay = torch.take_along_dim(pay, want.index[..., None].long(),
                                        dim=-2)
        assert torch.equal(got_pay[hit], want_pay[hit])
        assert bool(torch.all(got_pay[~hit] == 0))


@pytest.mark.parametrize("d,f_dim", [(2, 0), (3, 0), (2, 2), (3, 2),
                                     (3, 3), (3, 4)])
@pytest.mark.parametrize("batched", [False, True])
def test_nn_sweep_and_matched_kernels_bitwise_equal_to_plain(dev, d, f_dim,
                                                             batched):
    """Kernels 5 (no payload) and 4 against their plain versions and brute
    force; one pair's db fully masked when batched."""
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    query, db, mask, pay = _sweep_cloud(dev, b=3 if batched else None, d=d)
    if batched:
        mask[1] = False
    pay = pay[..., :f_dim]
    query_p = torch.zeros((*query.shape[:-2], 768, d), device=dev)
    query_p[..., :700, :] = query
    dbf = nn_cuda._dbf_cm_matched(db, mask, pay, 2048)
    name = "nn_matched" if f_dim else "nn_sweep"
    before = cuda_build.LAUNCHES[name]
    if f_dim:
        got = nn_sweep_cuda.nn_matched(query_p, dbf, d)
        want = nn_sweep_cuda.nn_matched_plain(query_p, dbf, d)
    else:
        got = nn_sweep_cuda.nn_sweep(query_p, dbf) + (None,)
        want = nn_sweep_cuda.nn_sweep_plain(query_p, dbf) + (None,)
    assert cuda_build.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert b is None or torch.equal(a, b)
    _brute_equal(got[1][..., :700], nn_cuda._trim_sentinel(got[0][..., :700]),
                 None if not f_dim else got[2][..., :700, :], query, db, mask,
                 pay)


@pytest.mark.parametrize("d,f_dim", [(2, 2), (3, 2), (3, 3), (3, 4),
                                     (2, 0), (3, 0)])
@pytest.mark.parametrize("batched", [False, True])
def test_nn_matched_kernel_at_item_boundaries(dev, d, f_dim, batched):
    """Kernel 4's work items (kernel 5's, nn_sweep, for F = 0): the
    wrapper's, one item (the whole db), one chunk an item and 3 chunks
    (the last ragged), at 2, 4 and 8 queries a thread with a ragged last
    query group.  Bitwise equal to the plain version, to the schedule's
    emulation and to brute force, two launches bitwise equal; ties every
    640 points (on item boundaries), and with a batch axis one pair's db
    fully masked."""
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    rng = np.random.default_rng(20 + d + f_dim)
    b = 3 if batched else 1
    base = torch.as_tensor(rng.uniform(-3, 3, (b, 640, d)),
                           dtype=torch.float32, device=dev)
    db = torch.cat([base, base, base], dim=1)  # 1920 points, 15 chunks
    mask = torch.ones(db.shape[:2], dtype=torch.bool, device=dev)
    if batched:
        mask[1] = False
    query = base[:, torch.as_tensor(rng.permutation(640), device=dev)] \
        + torch.as_tensor(rng.normal(0, 0.01, (b, 640, d)),
                          dtype=torch.float32, device=dev) \
        * (torch.arange(640, device=dev)[None, :, None] % 2)
    pay = torch.as_tensor(rng.normal(size=(b, 1920, f_dim)),
                          dtype=torch.float32, device=dev)
    if not batched:
        query, db, mask, pay = query[0], db[0], mask[0], pay[0]
    query_p = torch.zeros((*query.shape[:-2], 768, d), device=dev)
    query_p[..., :640, :] = query
    dbf = nn_cuda._dbf_cm_matched(db, mask, pay, 2048)
    if f_dim:
        name, args, make = "nn_matched", (query_p, dbf, d), \
            nn_sweep_cuda._nn_matched_args
        kernel, plain = nn_sweep_cuda.nn_matched, \
            nn_sweep_cuda.nn_matched_plain
    else:
        name, args, make = "nn_sweep", (query_p, dbf), \
            nn_sweep_cuda._nn_sweep_args
        kernel, plain = nn_sweep_cuda.nn_sweep, nn_sweep_cuda.nn_sweep_plain
    before = cuda_build.LAUNCHES[name]
    got = kernel(*args)
    again = kernel(*args)
    assert cuda_build.LAUNCHES[name] == before + 2
    want = plain(*args)
    torch.cuda.synchronize()
    for a, w, c in zip(got, want, again):
        assert torch.equal(a, w) and torch.equal(a, c)
    for item in (1, 3, 16):
        emul = nn_sweep_cuda.matched_items(query_p, dbf, d, item)[:3]
        for q in (2, 4, 8):
            largs, out, _keep = make(*args, item_chunks=item, q_per_thread=q)
            assert cuda_build.launcher(name)(*largs) == 0
            torch.cuda.synchronize()
            for a, w, e in zip(out, want, emul):
                assert torch.equal(a, w) and torch.equal(a, e)
    _brute_equal(got[1][..., :640], nn_cuda._trim_sentinel(got[0][..., :640]),
                 got[2][..., :640, :] if f_dim else None, query, db, mask,
                 pay)
    assert bool((got[1][..., :640] < 640).all())
    if batched:
        assert bool(torch.isinf(got[0][1]).all()) and not bool(got[1][1].any())
        assert not f_dim or not bool(got[2][1].any())


@pytest.mark.parametrize("f_dim", [0, 4])
@pytest.mark.parametrize("seeds", ["inf", "tight"])
@pytest.mark.parametrize("sort", [False, True])
def test_nn_pruned_kernel_bitwise_equal_to_plain(dev, f_dim, seeds, sort):
    """Kernel 6 on 6 db tiles of 512: zig-zag order, pruning and the
    lexicographic carry against its plain version and brute force."""
    from icp_rust_tpu_torch.ops import nn_sweep_cuda
    from icp_rust_tpu_torch.ops.nn import nn_torch

    query, db, mask, pay = _sweep_cloud(dev, q=1200, m=3000, seed=6,
                                        sort=sort)
    qb = None
    if seeds == "tight":
        qb = nn_torch(query, db, mask).dist_sq * 1.0001
    args = nn_sweep_cuda.prepare_pruned(query, db, mask,
                                        pay[:, :f_dim] if f_dim else None,
                                        256, 512, q_bound=qb)
    before = cuda_build.LAUNCHES["nn_pruned"]
    got = nn_sweep_cuda.nn_pruned(*args, 3, 256, 512)
    assert cuda_build.LAUNCHES["nn_pruned"] == before + 1
    want = nn_sweep_cuda.nn_pruned_plain(*args, 3, 256, 512)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _brute_equal(got[1][:1200], nn_cuda._trim_sentinel(got[0][:1200]),
                 got[2][:1200] if f_dim else None, query, db, mask,
                 pay[:, :f_dim])


@pytest.mark.parametrize("case", ["shorter", "T", "T+1", "all", "ties",
                                  "all-masked"])
def test_nn_pruned_kernel_at_item_boundaries(dev, case):
    """Kernel 6's work items of T = ITEM_TILES tiles: an order shorter than
    an item, exactly one item, one item and one tile, six tiles, exact
    ties whose copies lie in different items, and a fully masked db.
    Bitwise equal to the plain version, to the schedule's emulation and
    to brute force; two launches bitwise equal (the items merge
    lexicographically, whatever order the blocks finish in)."""
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    t = nn_sweep_cuda.ITEM_TILES
    n_db, f_dim = {"shorter": (max(t - 1, 1), 0), "T": (t, 3),
                   "T+1": (t + 1, 4), "all": (6, 0), "ties": (6, 3),
                   "all-masked": (6, 4)}[case]
    m = n_db * 256
    query, db, mask, pay = _sweep_cloud(dev, q=min(600, m), m=m, seed=8)
    if case == "ties":  # copies 3 tiles apart
        db = torch.cat([db[:768], db[:768]])
        mask = torch.ones(1536, dtype=torch.bool, device=dev)
        query = db[:768][torch.randperm(768, device=dev)]
        pay = db
    elif case == "all-masked":
        mask = torch.zeros_like(mask)
    pay = pay[:, :f_dim]
    args = nn_sweep_cuda.prepare_pruned(query, db, mask,
                                        pay if f_dim else None, 256,
                                        256) + (3, 256, 256)
    before = cuda_build.LAUNCHES["nn_pruned"]
    got = nn_sweep_cuda.nn_pruned(*args)
    again = nn_sweep_cuda.nn_pruned(*args)
    assert cuda_build.LAUNCHES["nn_pruned"] == before + 2
    want = nn_sweep_cuda.nn_pruned_plain(*args)
    emul = nn_sweep_cuda.pruned_items(*args)
    torch.cuda.synchronize()
    for a, b, c, e in zip(got, want, again, emul):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, e)
    q = query.shape[0]
    _brute_equal(got[1][:q], nn_cuda._trim_sentinel(got[0][:q]),
                 got[2][:q] if f_dim else None, query, db, mask, pay)
    if case == "ties":
        assert bool((got[1][:q] < 768).all())
    if case == "all-masked":
        assert bool(torch.isinf(got[0]).all()) and not bool(got[1].any())
        assert not bool(got[2].any())


def test_nn_sweep_kernels_ties_and_all_masked_db(dev):
    """Every db point twice: all three kernels pick the first copy; a
    fully masked db gives (+inf, 0, zero payload)."""
    from icp_rust_tpu_torch.ops import nn

    rng = np.random.default_rng(7)
    base = torch.as_tensor(rng.uniform(-3, 3, (1600, 3)),
                           dtype=torch.float32, device=dev)
    db = torch.cat([base, base])
    query = base[torch.as_tensor(rng.permutation(1600)[:1000], device=dev)]
    for tile in (2048, 512):  # kernel 5 (2 tiles), kernel 6 (7 tiles)
        res = nn.nearest_neighbor(query, db, backend="cuda", tile=tile)
        assert bool(torch.all(res.index < 1600))
        assert bool(torch.all(res.dist_sq == 0))
        res, pay = nn.nearest_neighbor_matched(query, db, backend="cuda",
                                               tile=tile)
        assert bool(torch.all(res.index < 1600)) and torch.equal(pay, query)
        none = torch.zeros(3200, dtype=torch.bool, device=dev)
        res, pay = nn.nearest_neighbor_matched(query, db, none,
                                               backend="cuda", tile=tile)
        assert bool(torch.all(torch.isinf(res.dist_sq)))
        assert bool(torch.all(res.index == 0)) and bool(torch.all(pay == 0))


def test_nn_sweep_kernels_refuse_float64_and_unserved_widths(dev):
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    q = torch.zeros((128, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        nn_sweep_cuda.nn_sweep(q, torch.zeros((3, 2048), dtype=torch.float64,
                                              device=dev))
    with pytest.raises(ValueError, match="payload width 5"):
        nn_sweep_cuda.nn_matched(q.float(), torch.zeros((8, 2048),
                                                        device=dev), 3)
    with pytest.raises(ValueError, match="payload width 4"):
        nn_sweep_cuda.nn_pruned(q[:, :2].float(),
                                torch.zeros((6, 2048), device=dev),
                                torch.zeros((1, 8), device=dev),
                                torch.zeros((1, 8), device=dev),
                                torch.zeros((1,), device=dev), 2, 128, 2048)


def test_slam_on_the_card_tracks_the_plain_path(dev):
    """run_slam3d on small frames (kernels 4 and 5) and run_slam2d on wide
    scans (7,020 points over 4 tiles: kernel 4 on each batched call's cold
    search, kernel 8's seed prune on every warm one, kernel 5 with a batch
    axis) against the plain path; each warm kernel 8 call, captured, is
    bitwise kernel 4 on the same packed inputs (D 2 / P 2)."""
    import chip_smoke
    from icp_rust_tpu_torch.models.slam import run_slam2d, run_slam3d
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    frames, _ = chip_smoke.room_sequence(n_poses=12, n_points=2048,
                                         scene_n=4000, seed=2)
    cfg = ICPConfig()
    plain = cfg.with_(nn_backend="torch", align_backend="torch")
    kw = dict(loop_radius=0.8, min_gap=4, max_loop_candidates=4,
              normals_voxel_size=0.4)
    cuda_build.reset_launches()
    res = run_slam3d(frames, cfg, **kw)
    assert cuda_build.LAUNCHES["nn_matched"] > 0
    assert cuda_build.LAUNCHES["nn_sweep"] > 0
    ref = run_slam3d(frames, plain, **kw)
    assert res.n_loop_closures == ref.n_loop_closures
    assert np.abs(res.optimized_path - ref.optimized_path).max() < 1e-3
    scans, _ = io.synthesize_frames3d(6, seed=3)
    scans = [s[::4, :2] for s in scans]  # 7020 points: off the pair grid
    calls, undo = chip_smoke._capture_calls(nn_pairs_cuda, "nn_pairs")
    try:
        cuda_build.reset_launches()
        res = run_slam2d(scans, cfg, loop_radius=1.0, min_gap=3)
        launched = dict(cuda_build.LAUNCHES)
    finally:
        undo()
    assert launched["nn_matched"] > 0 and launched["nn_sweep"] > 0
    assert launched["nn_pairs"] == len(calls) > 0
    assert launched["nn_pairs_list"] == 0
    for query_p, dbf, qbox, cbox, qbound, d_dim, q_sub in calls:
        got = nn_pairs_cuda.nn_pairs(query_p, dbf, qbox, cbox, qbound,
                                     d_dim, q_sub)
        want = nn_sweep_cuda.nn_matched(query_p, dbf, d_dim)
        torch.cuda.synchronize()
        assert d_dim == 2 and dbf.shape[1] == 4 and all(
            torch.equal(a, b) for a, b in zip(got, want))
    ref = run_slam2d(scans, plain, loop_radius=1.0, min_gap=3)
    assert np.abs(res.optimized_path - ref.optimized_path).max() < 1e-3


def _gn_problem(dev, batch=(), n=3000, seed=8):
    """A rotated, shifted, noisy copy with outliers and a partial mask, at
    a small transform per pair."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, (*batch, n, 2))
    dst = src @ np.array([[0.99, -0.14], [0.14, 0.99]]).T + [0.3, -0.2]
    dst = dst + rng.normal(0, 0.05, dst.shape)
    dst[..., ::17, :] += 3.0
    mask = rng.random((*batch, n)) > 0.2
    tw = rng.normal(0, 1, (*batch, 3)) * [0.05, 0.05, 0.02]
    t = RigidTransform2.from_twist(torch.as_tensor(tw, dtype=torch.float32,
                                                   device=dev))
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (src, dst)] + [torch.as_tensor(mask, device=dev), t]


@pytest.mark.parametrize("batched,n", [(False, 3000), (True, 3000)]
                         + [(False, n) for n in STATS_SIZES])
def test_gn_stats_kernels_match_plain(dev, batched, n):
    """Kernels 12 and 13 through weighted_gn_update_cuda against the einsum
    update, and their packed stats against their plain versions: each sum
    and the error within 1e-5 of its Cauchy-Schwarz bound, the count
    exact, sigma within 1e-6; kernel 12 also on every cluster size its
    rule picks (align2d_cuda.gn_cluster), its sigmas bitwise the plain
    version's (the exact medians and MADs of the same residuals)."""
    size = 3000 if n == "all-masked" else n
    src, dst, mask, t = _gn_problem(dev, (6,) if batched else (), n=size)
    if n == "all-masked":
        mask[:] = False
    if batched:
        mask[2] = False  # a fully masked pair
        mask[3, :] = False
        mask[3, :101] = True  # an odd count
    name = "gn_stats_batched" if batched else "gn_stats"
    before = cuda_build.LAUNCHES[name]
    upd = align2d.weighted_gn_update_cuda(t, src, dst, mask, 1.345, 1e-9)
    assert cuda_build.LAUNCHES[name] == before + 1
    ref = align2d.weighted_gauss_newton_update(t, src, dst, mask, 1.345,
                                               1e-9)
    # The einsum update sums in another order; a large step (~0.4 here)
    # carries its roundoff: the JAX package's gate for this comparison.
    assert torch.equal(upd.ok, ref.ok)
    torch.testing.assert_close(upd.delta, ref.delta, atol=1e-6, rtol=2e-4)
    fn = getattr(align2d_cuda, name)
    plain = getattr(align2d_cuda, name + "_plain")
    got = fn(src, dst, mask, t.rot, t.t, 1.345)
    want = plain(src, dst, mask, t.rot, t.t, 1.345)
    rel, dn, sig_rel = align2d_cuda.gn_stats_errors(got, want)
    assert rel <= 1e-5 and dn == 0 and sig_rel <= 1e-6
    if batched:
        assert torch.equal(got[2], torch.zeros(16, device=dev))
        assert not bool(upd.ok[2]) and bool(upd.ok[3])
        return
    assert bool(upd.ok) == (n not in (1, "all-masked"))
    assert torch.equal(got[12:14], want[12:14])
    for c in sorted({align2d_cuda.gn_cluster(1),
                     align2d_cuda.gn_cluster(1 << 30)}):
        args, out, _keep = align2d_cuda._gn_stats_args(
            src, dst, mask, t.rot, t.t, 1.345, cluster=c)
        assert cuda_build.launcher("gn_stats")(*args) == 0
        torch.cuda.synchronize()
        rel, dn, _ = align2d_cuda.gn_stats_errors(out, want)
        assert rel <= 1e-5 and dn == 0
        assert torch.equal(out[12:14], want[12:14])
    if n == "all-masked":
        assert not bool(got.any())


@pytest.mark.parametrize("b,n", [(211, 768), (11, 28160), (7, 1001)])
def test_gn_stats_batched_routes_match_plain(dev, b, n):
    """Kernel 13 on every route, at 211 pairs of 768 points, 11 of 28,160
    and 7 of 1,001 (no thread count divides it): one block a pair at
    every thread count of 64-1,024 that holds the pair, and clusters of
    1-16 blocks a pair that the card can place.  Each sum and the error
    within 1e-5 of its Cauchy-Schwarz bound, the count exact, the sigmas
    bitwise the plain version's (exact medians and MADs of the same
    residuals); an all-masked pair all zeros, and an odd count."""
    src, dst, mask, t = _gn_problem(dev, (b,), n=n, seed=n)
    mask[0] = False
    mask[1, :] = False
    mask[1, :101] = True
    want = align2d_cuda.gn_stats_batched_plain(src, dst, mask, t.rot, t.t,
                                               1.345)
    got = align2d_cuda.gn_stats_batched(src, dst, mask, t.rot, t.t, 1.345)
    routes = [(0, t) for t in range(64, 1025, 64)
              if -(-n // t) <= 8 and (-(-n // t) <= 4 or t <= 512)]
    routes += [(c, None) for c in (1, 2, 4, 8, 16)
               if align2d_cuda._gn_resident(n, c) >= 1]
    assert routes
    outs = [got]
    for c, threads in routes:
        args, out, _keep = align2d_cuda._gn_batched_args(
            src, dst, mask, t.rot, t.t, 1.345, cluster=c, threads=threads)
        assert cuda_build.launcher("gn_stats_batched")(*args) == 0
        torch.cuda.synchronize()
        outs.append(out)
    for out in outs:
        rel, dn, sig_rel = align2d_cuda.gn_stats_errors(out, want)
        assert rel <= 1e-5 and dn == 0 and sig_rel == 0.0
        assert torch.equal(out[:, 12:14], want[:, 12:14])
        assert torch.equal(out[0], torch.zeros(16, device=dev))
        assert float(out[1, 11]) == 101.0


def test_irls_cuh_kernels_agree_after_the_stats_refactor(dev):
    """The four kernels that share irls.cuh with the stats kernels still
    match their plain versions, and irls_loop's first iteration takes the
    step that gn_stats' statistics give (the same block routine)."""
    sp, sm, dp, dm = _pair(dev, n=700, pad=768, seed=9)
    cfg = ICPConfig(det_rel_eps=1e-9)
    args = (sp, dp, sm, cfg.huber_k, cfg.det_rel_eps,
            cfg.inner_delta_sq_tol, cfg.inner_max_iter, cfg.point_scale)
    for fn, plain, a in (
            (align2d_cuda.irls_loop, align2d_cuda.irls_loop_plain, args),
            (align2d_cuda.irls_loop_batched,
             align2d_cuda.irls_loop_batched_plain,
             (sp[None].repeat(3, 1, 1), dp[None].repeat(3, 1, 1),
              sm[None].repeat(3, 1)) + args[3:])):
        rot, t, it = fn(*a)
        rot_p, t_p, it_p = plain(*a)
        assert torch.equal(it.to(torch.int32), it_p.to(torch.int32))
        torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
        torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    for b in ((), (3,)):
        t0 = RigidTransform2.identity(b, device=dev)
        s, d = sp.expand(*b, *sp.shape), dp.expand(*b, *dp.shape)
        ms, md = sm.expand(*b, *sm.shape), dm.expand(*b, *dm.shape)
        rot, t, _ = align2d_cuda.icp2d_frame(s, d, ms, md, t0, cfg)
        rot_p, t_p, _ = m_icp.icp2d_frame_plain(s, d, ms, md, t0, cfg)
        torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
        torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)
    ident = RigidTransform2.identity(device=dev)
    step = align2d.weighted_gn_update_cuda(ident, sp, dp, sm, cfg.huber_k,
                                           cfg.det_rel_eps)
    one = RigidTransform2.from_twist(step.delta)
    rot, t, it = align2d_cuda.irls_loop(sp, dp, sm, cfg.huber_k,
                                        cfg.det_rel_eps, 0.0, 1,
                                        cfg.point_scale)
    assert int(it) == 1
    torch.testing.assert_close(rot, one.rot, atol=1e-6, rtol=0)
    torch.testing.assert_close(t, one.t, atol=1e-6, rtol=0)


def test_voxel_hash_insert_on_the_card_matches_the_cpu(dev):
    from icp_rust_tpu_torch.ops import voxel_hash

    rng = np.random.default_rng(10)
    a = rng.uniform(-6, 6, (12000, 3)).astype(np.float32)
    b = rng.uniform(-5, 5, (9000, 3)).astype(np.float32)
    tables = {}
    for where in ("cpu", dev, dev):
        m = voxel_hash.make_map(8192, 3, torch.full((3,), -8.0, device=where))
        drops = []
        for pts, salt in ((a, 5), (b, 6)):
            x = torch.as_tensor(pts, device=where)
            ones = torch.ones(len(pts), dtype=torch.bool, device=where)
            m, d = voxel_hash.insert(m, x, ones, 0.05, compact_to=3000,
                                     salt=salt)
            drops.append(int(d))
        tables.setdefault(str(where), []).append(
            ([v.cpu() for v in (m.key, m.cnt, m.psum)], drops))
    (cpu_t, cpu_d), = tables["cpu"]
    (c1, d1), (c2, d2) = tables[str(dev)]
    assert d1 == d2 == cpu_d and sum(cpu_d) > 0
    for x, y in zip(c1, c2):  # repeatable bitwise on the card
        assert torch.equal(x, y)
    assert torch.equal(c1[0], cpu_t[0]) and torch.equal(c1[1], cpu_t[1])
    torch.testing.assert_close(c1[2], cpu_t[2], rtol=1e-6, atol=1e-5)


def test_submap_on_the_card_repeats_and_tracks_the_plain_path(dev):
    from icp_rust_tpu_torch.models.submap import run_submap_odometry

    frames, _ = io.synthesize_frames3d(5, seed=0)
    pts, mask = io.pad_points([f[::8] for f in frames])
    cfg = ICPConfig(nn_dst_tile=512, det_rel_eps=1e-9)
    kw = dict(voxel_size=0.1, capacity=1 << 14, view_rows=1 << 13)
    cuda_build.reset_launches()
    tf, path = run_submap_odometry(pts, mask, cfg, **kw)
    assert cuda_build.LAUNCHES["nn_list"] > 0
    assert cuda_build.LAUNCHES["irls_loop"] == cuda_build.LAUNCHES["nn_list"]
    tf2, again = run_submap_odometry(pts, mask, cfg, **kw)
    assert np.array_equal(path, again) and torch.equal(tf.rot, tf2.rot)
    _, plain = run_submap_odometry(
        pts, mask, cfg.with_(nn_backend="torch", align_backend="torch"), **kw)
    assert ate_rmse(path, plain) < 1e-3


@pytest.mark.parametrize("kind", ["se2", "p2l"])
def test_per_frame_runners_bitwise_the_fused_ones_and_resume(dev, kind,
                                                             tmp_path):
    """``run_odometry_device`` / ``run_odometry_p2l`` with metrics rows:
    the fused runner's path bitwise, rows equal to its stats, each outer
    iteration one launch of the NN and the solver kernel; a run killed
    after frame 3 and resumed is bitwise the uninterrupted one."""
    from icp_rust_tpu_torch.models.odometry import run_odometry_device, \
        run_odometry_p2l
    from icp_rust_tpu_torch.utils.checkpoint import SequenceCheckpointer
    from icp_rust_tpu_torch.utils.metrics import MetricsLogger

    frames, _ = io.synthesize_frames3d(6, seed=0)
    pts, mask = io.pad_points([f[::4] for f in frames])
    cfg = ICPConfig(nn_dst_tile=1024, det_rel_eps=1e-9)
    if kind == "se2":
        run, fused, solver, kw = (run_odometry_device, run_odometry_fused,
                                  "irls_loop", {})
    else:
        run, fused, solver, kw = (run_odometry_p2l, run_odometry_p2l_fused,
                                  "p2l_loop", {"normals_voxel_size": 0.45})
    _, want, stats = fused(pts, mask, cfg, with_metrics=True, **kw)
    log = MetricsLogger(None)
    cuda_build.reset_launches()
    _, path = run(pts, mask, cfg, metrics=log, **kw)
    total = int(stats.outer_iters.sum())
    assert cuda_build.LAUNCHES["nn_list"] == total
    assert cuda_build.LAUNCHES[solver] == total
    assert np.array_equal(path, want)
    for i, rec in enumerate(log.records):
        assert rec.extra["outer_iters"] == int(stats.outer_iters[i])
        assert rec.huber_error == float(stats.huber_error[i])
        assert rec.mean_nn_dist == float(stats.mean_nn_dist[i])
    ck = SequenceCheckpointer(str(tmp_path / "ck.npz"), every=2)
    run(pts[:4], mask[:4], cfg, metrics=MetricsLogger(None), checkpoint=ck,
        **kw)
    _, resumed = run(pts, mask, cfg, metrics=MetricsLogger(None),
                     checkpoint=ck, resume=True, **kw)
    assert np.array_equal(resumed, path)


def _card_world(fn, *args):
    """``fn(*args)`` on 4 gloo ranks sharing the card (NCCL refuses two
    ranks on one card); the ranks' results."""
    from icp_rust_tpu_torch.parallel import dryrun

    return [r.value for r in dryrun.spawn(fn, 4, "gloo", "cuda", 300, args)]


def test_ring_nn_on_four_ranks_is_bitwise_the_whole_cloud_search(dev):
    """parallel/ring_nn on 4 gloo ranks on the card: each rank's queries
    (its block of frame 1) against frame 0 sharded 4 ways, bitwise the
    search over the whole of frame 0 (indices, distances, payload)."""
    import torch_parallel_cases as cases

    pts, mask = cases.frame_pair()
    assert all(_card_world(cases.ring_on_card, pts, mask))


def test_dp_sp_icp3d_planar_on_four_ranks_tracks_icp3d_planar(dev):
    """parallel/sharded.dp_sp_icp3d_planar on one 28,800-point pair, its
    clouds sharded over 4 gloo ranks on the card, within 1 mm of the
    single-device icp3d_planar (another NN route and sum order; the same
    fixed point to well under a millimetre)."""
    import torch_parallel_cases as cases
    from icp_rust_tpu_torch.models.icp2d import icp3d_planar

    pts, mask = cases.frame_pair()
    got = _card_world(cases.dp_sp_pair_on_card, pts, mask)
    want = icp3d_planar(pts[0], pts[1], mask[0], mask[1],
                        RigidTransform2.identity(),
                        ICPConfig(det_rel_eps=1e-9, nn_dst_tile=2048),
                        device=dev)
    for rot, t in got:
        assert np.abs(t - want.t.cpu().numpy()).max() < 1e-3
        assert np.abs(rot - want.rot.cpu().numpy()).max() < 1e-3


def _plane_pairs(dev, b=4, n=900, m=3072, seed=50):
    """Batched p2l inputs at the pair-grid route's size: Morton-sorted dbs
    of m points with a masked tail, queries near them, and the 4-lane
    payload [n, c] of ``build_p2l_payload`` with invalid planes (the
    sentinel c) on a third of the rows."""
    from icp_rust_tpu_torch.models.icp_p2l import build_p2l_payload
    from icp_rust_tpu_torch.ops.nn import morton_order

    rng = np.random.default_rng(seed)
    db = torch.as_tensor(rng.uniform(-3, 3, (b, m, 3)), dtype=torch.float32,
                         device=dev)
    mask = torch.as_tensor(rng.random((b, m)) > 0.1, device=dev)
    order = morton_order(db, mask).long()
    db = torch.take_along_dim(db, order[..., None], dim=1)
    mask = torch.take_along_dim(mask, order, dim=1)
    query = db[:, :n] + torch.as_tensor(rng.normal(0, 0.03, (b, n, 3)),
                                        dtype=torch.float32, device=dev)
    nrm = torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(b, m, 3)), dtype=torch.float32, device=dev), dim=-1)
    n_valid = torch.as_tensor(rng.random((b, m)) > 0.33, device=dev)
    return query, db, mask, build_p2l_payload(db, nrm, n_valid, mask)


@pytest.mark.parametrize("warm", [False, True])
def test_nn_pairs_kernels_at_the_plane_payload(dev, warm):
    """Kernels 8 (cold) and 9 (warm) at D 3 / P 4 through
    ``nn_pairs_matched``: bitwise their plain versions and brute force,
    the sentinel c of invalid planes returned as it went in; kernel 9 at
    every schedule too."""
    from icp_rust_tpu_torch.models.icp_p2l import _C_INVALID
    from icp_rust_tpu_torch.ops.nn import nn_torch

    query, db, mask, pay = _plane_pairs(dev)
    brute = nn_torch(query, db, mask)
    qb = brute.dist_sq * (1.0 + 32.0 * 1.2e-7) if warm else None
    name = "nn_pairs_list" if warm else "nn_pairs"
    before = cuda_build.LAUNCHES[name]
    idx, dist, got_pay = nn_pairs_cuda.nn_pairs_matched(
        query, db, mask, pay, q_bound=qb, warm=warm)
    assert cuda_build.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    want_pay = torch.take_along_dim(pay, brute.index[..., None].long(), dim=1)
    assert torch.equal(idx, brute.index) and torch.equal(dist, brute.dist_sq)
    assert torch.equal(got_pay, want_pay)
    assert bool((got_pay[..., 3] == _C_INVALID).any())
    query_p, dbf, cbox, qb_p = nn_pairs_cuda.prepare(query, db, mask, pay, qb)
    if warm:
        lists, cnt = nn_pairs_cuda._survivor_lists(query_p, cbox, qb_p, 3,
                                                   256, 64)
        args = (query_p, dbf, lists, cnt, 3, 256, qb_p, cbox)
        want = nn_pairs_cuda.nn_pairs_list_plain(*args)
        for item in (1, 2, 3, 8):
            for q in (1, 2, 4):
                largs, out, _part = nn_pairs_cuda._nn_pairs_list_args(
                    *args, item=item, q_per_thread=q)
                assert cuda_build.launcher("nn_pairs_list")(*largs) == 0
                torch.cuda.synchronize()
                for a, w in zip(out, want):
                    assert torch.equal(a, w)
    else:
        args = (query_p, dbf, nn_pairs_cuda._query_boxes(query_p, 256), cbox,
                nn_pairs_cuda._group_bounds(qb_p, 256), 3, 256)
        want = nn_pairs_cuda.nn_pairs_plain(*args)
    n = query.shape[1]
    assert torch.equal(idx, want[1][:, :n])
    assert torch.equal(dist, nn_cuda._trim_sentinel(want[0][:, :n]))
    assert torch.equal(got_pay, want[2][:, :n])


@pytest.mark.parametrize("n_points", [3072, 6144])
def test_batched_p2l_on_the_card_tracks_the_plain_route(dev, n_points):
    """Batched ``icp_point_to_plane`` on the card: 4 consecutive pairs of
    the room frames (chip_smoke.room_sequence: floor, walls and a ramp
    constrain every DoF) from perturbed true poses; the pair-grid kernels
    at 3,072 points, kernel 4 cold and kernel 8 warm at 6,144.  Each pair
    within 1 mm of the
    batched plain route (torch NN, the plain loop) and of the single-pair
    call on it."""
    import chip_smoke
    from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane

    (src, smask, dst, dmask), _, t0 = chip_smoke.p2l_room_inputs(
        dev, n_poses=5, n_points=n_points, scene_n=2 * n_points)
    cfg = ICPConfig(det_rel_eps=1e-9)
    cuda_build.reset_launches()
    t = icp_point_to_plane(src, dst, smask, dmask, t0, cfg,
                           normals_voxel_size=0.4, device=dev)
    launched = {k for k, v in cuda_build.LAUNCHES.items() if v}
    assert launched == ({"nn_pairs", "nn_pairs_list"} if n_points <= 4096
                        else {"nn_matched", "nn_pairs"})
    plain = icp_point_to_plane(
        src, dst, smask, dmask, t0,
        cfg.with_(nn_backend="torch", align_backend="torch"),
        normals_voxel_size=0.4, device=dev)
    assert float((t.t - plain.t).abs().max()) < 1e-3
    assert float((t.rot - plain.rot).abs().max()) < 1e-3
    for i in range(4):
        one = icp_point_to_plane(src[i], dst[i], smask[i], dmask[i],
                                 RigidTransform3(t0.rot[i], t0.t[i]), cfg,
                                 normals_voxel_size=0.4, device=dev)
        assert float((t.t[i] - one.t).abs().max()) < 1e-3
        assert float((t.rot[i] - one.rot).abs().max()) < 1e-3


def test_wide_batched_p2l_warm_searches_are_kernel_8_bitwise_kernel_4(dev):
    """Batched ``icp_point_to_plane`` over 8 consecutive pairs of the
    synthetic 28,800-point frames: one kernel 4 launch (the cold search)
    and kernel 8 on every warm one; each warm call, captured with the
    outer loop's seed bounds, prunes chunks and is bitwise kernel 4 on the
    same packed inputs (dist, idx, the 4-lane payload)."""
    import chip_smoke
    from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane
    from icp_rust_tpu_torch.ops import nn_sweep_cuda

    (src, smask, dst, dmask), _ = chip_smoke.p2l_batched_inputs(dev,
                                                                n_frames=9)
    assert src.shape == (8, 28800, 3)
    calls, undo = chip_smoke._capture_calls(nn_pairs_cuda, "nn_pairs")
    try:
        cuda_build.reset_launches()
        _, st = icp_point_to_plane(
            src, dst, smask, dmask,
            RigidTransform3.identity((8,), device=dev),
            ICPConfig(det_rel_eps=1e-9), normals_voxel_size=0.3,
            return_stats=True, device=dev)
        launched = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    finally:
        undo()
    k = int(st.outer_iters[0])
    assert k >= 3 and launched == {"nn_matched": 1, "nn_pairs": k - 1}
    assert len(calls) == k - 1
    for query_p, dbf, qbox, cbox, qbound, d_dim, q_sub in calls:
        walk = (nn_pairs_cuda._box_lower_bound(qbox, cbox, d_dim)
                <= qbound[..., None])
        assert float(walk.double().mean()) < 0.5
        got = nn_pairs_cuda.nn_pairs(query_p, dbf, qbox, cbox, qbound,
                                     d_dim, q_sub)
        want = nn_sweep_cuda.nn_matched(query_p, dbf, d_dim)
        torch.cuda.synchronize()
        assert dbf.shape[1] == 7 and all(
            torch.equal(a, b) for a, b in zip(got, want))


def test_gridhash_on_the_card_is_bitwise_the_cpu(dev):
    """``ops/gridhash`` built and queried on the card: every field and
    result bitwise the same call's on the CPU (frames 0 and 1, subsampled;
    r 0.25 m, cap 32, 2^16 slots)."""
    import dataclasses

    from icp_rust_tpu_torch.ops import gridhash

    frames, _ = io.synthesize_frames3d(2, seed=0)
    db = torch.as_tensor(frames[0][::4], dtype=torch.float32)
    query = torch.as_tensor(frames[1][::4], dtype=torch.float32)
    mask = torch.ones(len(db), dtype=torch.bool)
    mask[::7] = False
    grids = [gridhash.build_grid(db.to(d), mask.to(d), 0.25,
                                 table_size=1 << 16, bucket_cap=32)
             for d in (dev, "cpu")]
    for f in dataclasses.fields(grids[0]):
        a, b = getattr(grids[0], f.name), getattr(grids[1], f.name)
        assert torch.equal(a.cpu(), b) if torch.is_tensor(a) else a == b
    res = [gridhash.nn_gridhash(query.to(g.points.device), g) for g in grids]
    assert torch.equal(res[0].index.cpu(), res[1].index)
    assert torch.equal(res[0].dist_sq.cpu(), res[1].dist_sq)


def test_mxu_on_the_card_matches_the_cpu(dev):
    """``nn_torch(method="mxu")`` on the card (full float32 matmuls: TF32
    stays off) gives the CPU's indices on well-separated data, and the
    direct method's."""
    from icp_rust_tpu_torch.ops.nn import nn_torch

    rng = np.random.default_rng(6)
    grid = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) * 0.25 - 1.5
    db = torch.as_tensor(grid + rng.uniform(-0.02, 0.02, grid.shape),
                         dtype=torch.float32)
    query = db[torch.as_tensor(rng.integers(0, len(db), 2000))] \
        + torch.as_tensor(rng.uniform(-0.05, 0.05, (2000, 3)),
                          dtype=torch.float32)
    assert not torch.backends.cuda.matmul.allow_tf32
    card = nn_torch(query.to(dev), db.to(dev), tile=512, method="mxu")
    cpu = nn_torch(query, db, tile=512, method="mxu")
    direct = nn_torch(query, db, tile=512)
    assert torch.equal(card.index.cpu(), cpu.index)
    assert torch.equal(cpu.index, direct.index)
