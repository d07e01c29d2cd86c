"""The frozen data generators and the general generator of pair
traffic."""

import json

import numpy as np

from bench_port.data import frames3d, scans2d
from bench_port.inputs import pairs
from bench_port.tests import checkout

SPEC2D = dict(json.loads(json.dumps(checkout.SCAN2D["data"])), scans=12,
              pad_to=128, rays=96, min_points=60, max_points=100)


def test_frames3d_is_the_ports_generator_bitwise():
    from icp_rust_tpu_torch.utils import io

    mine, traj = frames3d.synthesize(3, seed=2**33 + 5)
    theirs, traj2 = io.synthesize_frames3d(3, seed=2**33 + 5)
    assert np.array_equal(traj, traj2)
    assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))


def test_a_fixed_world_changes_only_the_samples():
    a, _ = frames3d.synthesize(2, seed=1, world_seed=0)
    b, _ = frames3d.synthesize(2, seed=2, world_seed=0)
    assert not np.array_equal(a[0], b[0])
    assert abs(len(a[0]) - len(b[0])) <= 2
    assert frames3d.make(dict(frames=2, pad_to=28800, world_seed=0),
                         1)["points"].shape == (2, 28800, 3)


def test_scans2d_counts_are_the_geometrys_for_every_seed():
    n1 = scans2d.make(SPEC2D, 7)["mask"].sum(1)
    d2 = scans2d.make(SPEC2D, 2**40 + 3)
    assert list(n1) == list(d2["mask"].sum(1))
    assert n1.min() >= 60 and n1.max() <= 100
    assert not np.array_equal(scans2d.make(SPEC2D, 7)["points"],
                              d2["points"])


def test_scans2d_cast_first_hits_within_range_and_raise_outside_limits():
    spec = dict(SPEC2D, noise=0.0)
    traj = frames3d.ground_truth_trajectory(spec["scans"])
    world = scans2d.make_room(spec, traj[:, :2])
    assert not scans2d.path_crosses(world, traj[:, :2]).any()
    full = frames3d.make_world(np.random.default_rng(spec["world_seed"]))
    assert scans2d.path_crosses(
        full, frames3d.ground_truth_trajectory(210)[:, :2]).any()
    scans, _ = scans2d.synthesize(spec, 0)
    phi = scans2d.beams(spec)
    for pose, scan in zip(traj[[0, -1]], (scans[0], scans[-1])):
        r = scans2d.ranges(world, pose, phi)
        assert np.allclose(np.linalg.norm(scan, axis=1),
                           r[r <= spec["max_range"]], atol=1e-12)
        # A beam's return is its nearest wall: a point a little short of it
        # is free of every wall.
        short = scan * 0.999
        c, s = np.cos(pose[2]), np.sin(pose[2])
        world_pts = short @ np.array([[c, s], [-s, c]]) + pose[:2]
        seg = np.concatenate([np.broadcast_to(pose[:2], world_pts.shape),
                              world_pts], 1).reshape(-1, 2, 2)
        for a, b in seg[::7]:
            assert not scans2d.path_crosses(world, np.stack([a, b])).any()
    try:
        scans2d.synthesize(dict(spec, max_points=10), 0)
    except ValueError as e:
        assert "outside" in str(e)
    else:
        raise AssertionError("a scan above max_points did not raise")


def test_pair_truth_maps_frame_i_onto_frame_j():
    data = frames3d.make(dict(frames=6, pad_to=1792, world_seed=0,
                              point_stride=16), 3)
    pr = np.array([[0, 1], [4, 2], [1, 5]])
    rot, t = pairs.relative_truth(data, pr)
    world = np.random.default_rng(0).normal(size=(10, 3))
    for (i, j), r, tt in zip(pr, rot, t):
        in_i = (world - data["pose_t"][i]) @ data["pose_rot"][i]
        in_j = (world - data["pose_t"][j]) @ data["pose_rot"][j]
        assert np.allclose(in_i @ r.T + tt, in_j, atol=1e-12)


def test_every_seed_sends_the_same_pairs_and_warm_starts_in_an_order():
    data = scans2d.make(SPEC2D, 0)
    traffic = dict(pairs={"gap": 3}, shuffle_pairs=True,
                   warm_start={"from": "truth", "perturb_m": 0.1,
                               "perturb_rad": 0.05, "perturb_seed": 9})
    a = pairs.make(dict(data), traffic, 1)
    b = pairs.make(dict(data), traffic, 2**40 + 2)
    assert sorted(a["pairs"].tolist()) == [[k, k + 3] for k in range(9)]
    assert a["pairs"].tolist() != b["pairs"].tolist()
    assert a["work"] == 9 and list(a["context"]["valid_src"]) == list(
        data["mask"][a["pairs"][:, 0].numpy()].sum(-1))
    key = {tuple(p): (r, t) for p, r, t in zip(
        a["pairs"].tolist(), a["rot0"], a["t0"])}
    for p, r, t in zip(b["pairs"].tolist(), b["rot0"], b["t0"]):
        assert (key[tuple(p)][0] == r).all() and (key[tuple(p)][1] == t).all()
    off = (a["t0"] - a["gt_t"]).abs()
    assert 0 < float(off.max()) <= 0.1
    ident = pairs.make(dict(data), {}, 1)
    assert ident["work"] == 11 and float(ident["t0"].abs().max()) == 0.0
