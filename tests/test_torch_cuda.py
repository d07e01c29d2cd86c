"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Marked ``cuda``; without a card each test skips.

Run on a machine with an NVIDIA Hopper card (this file imports no JAX,
and ``--noconftest`` keeps the JAX test setup out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: nn_list is bitwise equal to its plain version (indices,
distances and payload).  irls_loop and icp2d_frame take their sums in
another order than the plain versions: rot and t within 1e-5.
chip_smoke.py runs the same comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.config import ICPConfig
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models.odometry import ate_rmse, run_odometry_fused
from icp_rust_tpu_torch.ops import align2d_cuda, cuda_build, nn_cuda
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
