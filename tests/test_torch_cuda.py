"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``; without a card each test skips.

Run on a machine with an NVIDIA Hopper card (this file imports no JAX,
and ``--noconftest`` keeps the JAX test setup out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: nn_list, nn_pairs and nn_pairs_list are bitwise equal to
their plain versions (indices, distances and payload).  irls_loop,
irls_loop_batched, icp2d_frame and icp2d_frame_pairs take their sums in
another order than the plain versions: rot and t within 1e-5.
chip_smoke.py runs the same comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.odometry import ate_rmse, run_odometry_fused
from icp_rust_tpu_torch.ops import align2d_cuda, cuda_build, nn_cuda, \
    nn_pairs_cuda
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
