"""The plain reference against the crate's semantics: the port's float64
NumPy oracle of the 2D ICP, and the port's float64 CPU path of the SE(3)
point-to-plane ICP."""

import numpy as np
import torch

from bench_port.data import frames3d, scans2d
from bench_port.reference import icp, icp2d, p2l
from bench_port.tests import checkout

ICP = dict(huber_k=1.345, mad_scale=1.482602218505602, inner_max_iter=200,
           inner_delta_sq_tol=1e-6, outer_iters=20, det_rel_eps=0.0)


def _identity(n, d):
    return (torch.eye(d, dtype=torch.float64).expand(n, d, d),
            torch.zeros(n, d, dtype=torch.float64))


def test_icp2d_is_the_crates_icp():
    from icp_rust_tpu_torch.utils import oracle_np as O

    data = scans2d.make(dict(checkout.SCAN2D["data"], scans=3, pad_to=128,
                             rays=128, min_points=100, max_points=120), 4)
    pairs = torch.tensor([[0, 1], [1, 2]])
    rot, t = icp2d.solve(data, pairs, *_identity(2, 2), ICP, {},
                         torch.float64, "cpu")
    for k in range(2):
        src = data["points"][k][data["mask"][k]].astype(np.float64)
        dst = data["points"][k + 1][data["mask"][k + 1]].astype(np.float64)
        want = O.Icp2d(dst).estimate(src, O.Transform.identity(), 20)
        assert np.abs(want.t - t[k].numpy()).max() < 1e-12
        assert np.abs(want.rot - rot[k].numpy()).max() < 1e-12
    step = icp2d.steps(data, pairs, torch.arange(2), rot, t, ICP, {}, "cpu")
    assert bool((step < 1e-3).all())


def test_p2l_is_the_ports_float64_point_to_plane_icp():
    from icp_rust_tpu_torch.config import REFERENCE_CONFIG
    from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
    from icp_rust_tpu_torch.models.icp_p2l import icp_point_to_plane

    data = frames3d.make(dict(frames=3, pad_to=1792, world_seed=0,
                              point_stride=16), 5)
    pairs = torch.tensor([[0, 1], [1, 2]])
    rot, t = p2l.solve(data, pairs, *_identity(2, 3), ICP,
                       {"voxel_size": 0.3}, torch.float64, "cpu")
    pts = torch.as_tensor(data["points"]).double()
    m = torch.as_tensor(data["mask"])
    want = icp_point_to_plane(
        pts[:-1], pts[1:], m[:-1], m[1:],
        RigidTransform3.identity((2,), dtype=torch.float64),
        REFERENCE_CONFIG, normals_voxel_size=0.3, device="cpu")
    assert float((want.t - t).abs().max()) < 1e-9
    assert float((want.rot - rot).abs().max()) < 1e-9
    step = p2l.steps(data, pairs, torch.arange(2), rot, t, ICP,
                     {"voxel_size": 0.3}, "cpu")
    assert bool((step < 1e-3).all())


def test_median_and_nearest_are_exact():
    x = torch.tensor([[3.0, 1.0, 2.0, 9.0], [4.0, 1.0, 7.0, 5.0]])
    m = torch.tensor([[True, True, True, False], [True, True, True, True]])
    med, ok = icp.masked_median(x, m)
    assert med.tolist() == [2.0, 4.5] and ok.all()
    q = torch.rand(2, 50, 3, dtype=torch.float64)
    db = torch.rand(2, 70, 3, dtype=torch.float64)
    dm = torch.rand(2, 70) > 0.3
    d, i = icp.nearest(q, db, dm, block_elems=256)
    full = torch.where(dm[:, None], ((q[:, :, None] - db[:, None]) ** 2
                                     ).sum(-1), torch.inf)
    assert torch.equal(i, full.argmin(-1))
    assert torch.equal(d, full.amin(-1))
