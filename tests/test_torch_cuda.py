"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``; without a card each test skips.

Run on a machine with an NVIDIA Hopper card (this file imports no JAX,
and ``--noconftest`` keeps the JAX test setup out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: nn_list, nn_pairs, nn_pairs_list, nn_sweep, nn_matched and
nn_pruned are bitwise equal to their plain versions (indices, distances
and payload) and to a brute-force sweep.  irls_loop,
irls_loop_batched, icp2d_frame, icp2d_frame_pairs and p2l_loop take
their sums in another order than the plain versions: rot and t within
1e-5, equal iteration counts for p2l_loop.  p2l_stats, gn_stats and
gn_stats_batched: each sum and the error within 1e-5 of the
Cauchy-Schwarz bound of its absolute terms, the count exact, sigma within
1e-6 relative; the update from gn_stats' statistics against the einsum
update at the JAX package's gate (delta rtol 2e-4, atol 1e-6).  The voxel hash table on the card equals the CPU's: keys,
counts and drops exact, point sums to float32 roundoff.  chip_smoke.py
runs the same comparisons at the paths' full sizes.
"""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
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
    n_chunks = pack.dbf_cm.shape[1] // 128
    cap = min(nn_cuda._LIST_CAP, n_chunks)
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


@pytest.mark.parametrize("n,pad", [(600, 768), (1400, 1536)])
def test_icp2d_frame_kernel_matches_plain(dev, n, pad):
    sp, sm, dp, dm = _pair(dev, n=n, pad=pad, seed=1)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity(device=dev)
    rot, t, it = align2d_cuda.icp2d_frame(sp, dp, sm, dm, t0, cfg)
    rot_p, t_p, it_p = align2d_cuda.icp2d_frame_plain(sp, dp, sm, dm, t0,
                                                      cfg)
    assert int(it) == it_p
    torch.testing.assert_close(rot, rot_p, atol=SOLVER_TOL, rtol=0)
    torch.testing.assert_close(t, t_p, atol=SOLVER_TOL, rtol=0)


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
    from icp_rust_tpu_torch.models.icp2d import _spatial_sort

    rng = np.random.default_rng(seed)
    db = torch.as_tensor(rng.uniform(-3, 3, (b, m, d)), dtype=torch.float32,
                         device=dev)
    mask = torch.as_tensor(rng.random((b, m)) > 0.2, device=dev)
    mask[1] = False
    db, mask, _ = _spatial_sort(db, mask)
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


def _pair_batch(dev, b=6, n=600, pad=768):
    pairs = [_pair(dev, n=n, pad=pad, seed=10 + i) for i in range(b)]
    return [torch.stack([p[k] for p in pairs]) for k in range(4)]


def test_icp2d_frame_pairs_kernel_matches_plain(dev):
    sp, sm, dp, dm = _pair_batch(dev)
    cfg = ICPConfig(det_rel_eps=1e-9)
    t0 = RigidTransform2.identity((sp.shape[0],), device=dev)
    rot, t, its = align2d_cuda.icp2d_frame_pairs(sp, dp, sm, dm, t0, cfg)
    rot_p, t_p, its_p = align2d_cuda.icp2d_frame_pairs_plain(sp, dp, sm, dm,
                                                             t0, cfg)
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


@pytest.mark.parametrize("warm", [False, True])
def test_p2l_stats_kernel_matches_plain(dev, warm):
    src, dst, nrm, mask = _p2l_problem(dev)
    t = RigidTransform3.identity(device=dev)
    if warm:
        t = RigidTransform3.from_twist(torch.tensor(
            [0.09, -0.04, 0.03, 0.01, -0.005, 0.002], device=dev))
    before = cuda_build.LAUNCHES["p2l_stats"]
    upd = align3d.weighted_gn_update_p2l_cuda(t, src, dst, nrm, mask, 1.345)
    assert cuda_build.LAUNCHES["p2l_stats"] == before + 1
    assert bool(upd.ok)
    got = align3d_cuda.p2l_stats(src, dst, nrm, mask, t.rot, t.t, 1.345)
    want = align3d_cuda.p2l_stats_plain(src, dst, nrm, mask, t.rot, t.t,
                                        1.345)
    rel, dn, sig_rel = align3d_cuda.stats_errors(got, want)
    assert rel <= 1e-5 and dn == 0 and sig_rel <= 1e-6


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


def test_p2l_kernels_refuse_float64(dev):
    x = torch.zeros((256, 3), dtype=torch.float64, device=dev)
    m = torch.ones(256, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        align3d_cuda.p2l_loop(x, x, x, m, 1.345, 1e-6, 200, 1.0)
    with pytest.raises(TypeError):
        align3d_cuda.p2l_stats(x, x, x, m, torch.eye(3, device=dev),
                               torch.zeros(3, device=dev), 1.345)


def _sweep_cloud(dev, b=None, q=700, m=1500, d=3, seed=5, sort=False):
    """Queries near a partly masked db (optionally Morton-sorted), with a
    4-row payload; a leading batch axis of ``b``."""
    from icp_rust_tpu_torch.models.icp2d import _spatial_sort

    rng = np.random.default_rng(seed)
    shape = () if b is None else (b,)
    db = torch.as_tensor(rng.uniform(-3, 3, (*shape, m, d)),
                         dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random((*shape, m)) > 0.2, device=dev)
    if sort:
        db, mask, _ = _spatial_sort(db, mask)
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
    scans (kernels 4 and 5 with a batch axis) against the plain path."""
    import chip_smoke
    from icp_rust_tpu_torch.models.slam import run_slam2d, run_slam3d

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
    cuda_build.reset_launches()
    res = run_slam2d(scans, cfg, loop_radius=1.0, min_gap=3)
    assert cuda_build.LAUNCHES["nn_matched"] > 0
    assert cuda_build.LAUNCHES["nn_sweep"] > 0
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


@pytest.mark.parametrize("batched", [False, True])
def test_gn_stats_kernels_match_plain(dev, batched):
    src, dst, mask, t = _gn_problem(dev, (6,) if batched else ())
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
        rot_p, t_p, _ = align2d_cuda.icp2d_frame_plain(s, d, ms, md, t0, cfg)
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
