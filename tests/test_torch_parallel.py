"""The port's ``parallel/`` package on four gloo CPU ranks against the JAX
package's sharded functions on a four-device virtual mesh.

The port runs in one module-scoped world of 4 spawned gloo ranks
(``parallel/dryrun.spawn``, one torch thread a rank, a deadline), every
case in one program (``torch_parallel_cases.run_cases``); the JAX
references run in this process on ``make_mesh(..., devices=jax.devices()
[:4])`` while it runs.  Both take the same numpy inputs, at the sizes of the
JAX package's tests/test_parallel.py, test_parallel3d.py,
test_pose_graph.py, test_pose_graph3.py and test_graph_schur.py.

Tolerances: the ring's indices (and its matched rows) equal, distances
rtol 1e-12; the float64 drivers 1e-12 and the float32 ones 1e-5 (the sums
in another order); point-to-plane in float64 1e-9 of the JAX package's
sharded result (the same shards, so the same normals) and 5e-3 of the
truth; the edge-sharded graph solve within the JAX tests' 1e-5 (t) and
1e-6 (rot) of the JAX one and of the local CG solve; the segment-sharded
Schur solve 1e-10.  ``dryrun_multichip``'s programs pass their own
checks on every rank.
"""

import concurrent.futures
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_cases as cases
from icp_rust_tpu.config import REFERENCE_CONFIG, ICPConfig
from icp_rust_tpu.geometry.transform2d import RigidTransform2
from icp_rust_tpu.geometry.transform3d import RigidTransform3
from icp_rust_tpu.models import pose_graph as jpg
from icp_rust_tpu.models.graph_schur import optimize_schur
from icp_rust_tpu.parallel import make_mesh
from icp_rust_tpu.parallel import sharded as jsh
from icp_rust_tpu.parallel.dist_graph import optimize_distributed
from icp_rust_tpu.parallel.ring_nn import ring_nearest_neighbor, \
    ring_nearest_neighbor_matched
from icp_rust_tpu_torch.parallel import dryrun

F64 = jnp.float64
WORLD = 4
DEADLINE_S = 400


def _pair(n, seed, noise=0.01):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, (n, 2))
    t_true = RigidTransform2.from_twist(jnp.asarray([0.4, -0.3, 0.08], F64))
    dst = np.array(t_true.apply_points(jnp.asarray(src, F64)))
    return src, dst + rng.normal(0, noise, dst.shape)


def _pairs(b, n, seed0):
    src, dst = zip(*[_pair(n, seed0 + k) for k in range(b)])
    return np.stack(src), np.stack(dst), np.ones((b, n), bool)


def _pairs3d(b, n, seed0, noise=0.01):
    src, dst = [], []
    c, s = np.cos(0.08), np.sin(0.08)
    for k in range(b):
        rng = np.random.default_rng(seed0 + k)
        p = rng.uniform(-10, 10, (n, 3))
        q = p.copy()
        q[:, :2] = p[:, :2] @ np.array([[c, -s], [s, c]]).T + [0.4, -0.3]
        src.append(p)
        dst.append(q + rng.normal(0, noise, q.shape))
    return np.stack(src), np.stack(dst), np.ones((b, n), bool)


def _box_cloud(n, seed):
    rng = np.random.default_rng(seed)
    per = -(-n // 6)
    pts = []
    for ax in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-1, 1, (per, 3))
            p[:, ax] = sign
            pts.append(p)
    out = np.concatenate(pts)[:n]
    return out[rng.permutation(len(out))]


P2L_TRUE = [0.04, -0.03, 0.02, 0.02, -0.015, 0.025]


def _p2l_pairs(b=2, n=4096):
    t_true = RigidTransform3.from_twist(jnp.asarray(P2L_TRUE, F64))
    rng = np.random.default_rng(0)
    src = np.stack([_box_cloud(n, 30 + k) for k in range(b)])
    dst = np.array(t_true.apply_points(jnp.asarray(src, F64)))
    return src, dst + rng.normal(0, 5e-4, src.shape), np.ones((b, n), bool)


def _circle(n=30, seed=0, drift=0.03):
    rng = np.random.default_rng(seed)
    step, dth = 2 * np.pi * 5.0 / n, 2 * np.pi / n
    noisy = np.stack([np.array([step, 0.0, dth]) + rng.normal(
        [drift, 0, 0], [0.01, 0.01, 0.005]) for _ in range(n - 1)])
    gt_end = RigidTransform2.identity(dtype=F64)
    z = RigidTransform2.from_twist(jnp.asarray([step, 0.0, dth], F64))
    for _ in range(n - 1):
        gt_end = gt_end.compose(z)
    return jpg.odometry_chain_graph(
        RigidTransform2.from_twist(jnp.asarray(noisy, F64)),
        extra_edges=[(0, n - 1, gt_end, 100.0 * np.eye(3))])


def _helix(n=30, seed=0, drift=0.02):
    rng = np.random.default_rng(seed)
    step = np.array([2 * np.pi * 5.0 / n, 0.0, 0.05, 0.01, 0.015,
                     2 * np.pi / n])
    noisy = np.stack([step + rng.normal(
        [drift, 0, 0, 0, 0, 0], [0.01, 0.01, 0.01, 0.003, 0.003, 0.003])
        for _ in range(n - 1)])
    gt_end = RigidTransform3.identity(dtype=F64)
    z = RigidTransform3.from_twist(jnp.asarray(step, F64))
    for _ in range(n - 1):
        gt_end = gt_end.compose(z)
    return jpg.odometry_chain_graph(
        RigidTransform3.from_twist(jnp.asarray(noisy, F64)),
        extra_edges=[(0, n - 1, gt_end, 100.0 * np.eye(6))])


def _schur_graph(dim):
    """The graphs of tests/test_graph_schur.py."""
    cls = RigidTransform2 if dim == 2 else RigidTransform3
    n, seed = (60, 0) if dim == 2 else (40, 1)
    rng = np.random.default_rng(seed)
    if dim == 2:
        step = np.array([1.0, 0.0, 2 * np.pi / n])
        noisy = step + rng.normal(0, [0.02, 0.02, 0.01], (n - 1, 3))
        pairs, w = [(0, n - 1), (5, n // 2), (10, 3 * n // 4)], np.eye(3)
    else:
        step = np.array([1.0, 0.0, 0.05, 0.01, 0.0, 2 * np.pi / n])
        noisy = step + rng.normal(0, 0.01, (n - 1, 6))
        pairs, w = [(0, n - 1), (7, 2 * n // 3)], np.eye(6)
    gt = [cls.identity(dtype=F64)]
    z = cls.from_twist(jnp.asarray(step, F64))
    for _ in range(n - 1):
        gt.append(gt[-1].compose(z))
    extra = [(i, j, gt[i].inverse().compose(gt[j]), 50.0 * w)
             for i, j in pairs]
    return jpg.odometry_chain_graph(cls.from_twist(jnp.asarray(noisy, F64)),
                                    extra_edges=extra)


def _arrays(g):
    return tuple(np.array(x) for x in (
        g.poses.rot, g.poses.t, g.edge_i, g.edge_j, g.meas.rot, g.meas.t,
        g.info, g.edge_mask))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    ring = dict(q=rng.uniform(-5, 5, (64, 2)), db=rng.uniform(-5, 5, (128, 2)),
                dbm=rng.uniform(size=128) > 0.3)
    src, dst = _pair(256, 0)
    src2, dst2 = _pair(256, 2)
    return dict(
        ring=ring, estimate=(src, dst, np.ones(256, bool)),
        icp2d=(src2, dst2, np.ones(256, bool)),
        batched=_pairs(8, 128, 10), dp_sp_icp2d=_pairs(2, 256, 40),
        dp_sp_icp3d_planar=_pairs3d(2, 256, 20), p2l=_p2l_pairs(),
        dist2d=_arrays(_circle()), dist3d=_arrays(_helix()),
        schur2d=_arrays(_schur_graph(2)), schur3d=_arrays(_schur_graph(3)))


@pytest.fixture(scope="module")
def world(inputs):
    """The port's world, started in a thread so that it runs while this
    process compiles the JAX references (``ref``); ``port`` joins it."""
    box = {}

    def run():
        try:
            box["value"] = [r.value for r in dryrun.spawn(
                cases.run_cases, WORLD, "gloo", "cpu", DEADLINE_S, (inputs,),
                1)]
        except BaseException as e:  # raised again by ``port``
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


@pytest.fixture(scope="module")
def port(world, ref):
    """Per rank, every case's result (after ``ref``, which runs beside the
    world)."""
    thread, box = world
    thread.join(DEADLINE_S + 60)
    if "error" in box:
        raise box["error"]
    assert "value" in box, "the world did not finish"
    return box["value"]


def _jax_graph(arrays):
    rot, t, ei, ej, zr, zt, info, em = arrays
    cls = RigidTransform2 if t.shape[-1] == 2 else RigidTransform3
    return jpg.PoseGraph(cls(jnp.asarray(rot), jnp.asarray(t)),
                         jnp.asarray(ei), jnp.asarray(ej),
                         cls(jnp.asarray(zr), jnp.asarray(zt)),
                         jnp.asarray(info), jnp.asarray(em))


@pytest.fixture(scope="module")
def ref(inputs, world):
    """The JAX package's sharded results, each program jitted (its
    op-by-op execution under ``shard_map`` costs tens of seconds) and
    compiled on a few threads (XLA's compiler releases the GIL), while the
    port's world runs."""
    devs = jax.devices()[:WORLD]
    sp4 = make_mesh(("sp",), (WORLD,), devices=devs)
    dp4 = make_mesh(("dp",), (WORLD,), devices=devs)
    grid = make_mesh(("dp", "sp"), (2, 2), devices=devs)
    todo = {}

    def run(name, fn, *args, **kw):
        todo[name] = lambda: jax.block_until_ready(
            jax.jit(lambda *a: fn(*a, **kw))(*args))

    r = inputs["ring"]
    spec = P("sp")
    for name, fn in (("ring", ring_nearest_neighbor),
                     ("ring_matched", ring_nearest_neighbor_matched)):
        run(name, jax.shard_map(
            lambda q, d, m, fn=fn: fn(q, d, m, "sp"), mesh=sp4,
            in_specs=(spec,) * 3, out_specs=spec, check_vma=False),
            r["q"], r["db"], r["dbm"])
    src, dst, mask = inputs["estimate"]
    run("estimate", jsh.sharded_estimate_transform, src, dst, mask,
        config=REFERENCE_CONFIG, mesh=sp4)
    src, dst, mask = inputs["icp2d"]
    run("icp2d", jsh.sharded_icp2d, src, dst, mask, mask,
        RigidTransform2.identity(dtype=F64), config=REFERENCE_CONFIG,
        mesh=sp4)
    src, dst, mask = inputs["batched"]
    run("batched", jsh.batched_icp2d, src, dst, mask, mask,
        RigidTransform2.identity((8,), F64), config=REFERENCE_CONFIG,
        mesh=dp4)
    configs = {"f64": REFERENCE_CONFIG,
               "f32": ICPConfig(compute_dtype=jnp.float32)}
    for name in ("dp_sp_icp2d", "dp_sp_icp3d_planar"):
        src, dst, mask = inputs[name]
        for dt, cfg in configs.items():
            c = cfg.compute_dtype
            run(f"{name}-{dt}", getattr(jsh, name), jnp.asarray(src, c),
                jnp.asarray(dst, c), mask, mask,
                RigidTransform2.identity((2,), c), config=cfg, mesh=grid)
    src, dst, mask = inputs["p2l"]
    run("p2l", jsh.dp_sp_icp_p2l, src, dst, mask, mask,
        RigidTransform3.identity((2,), F64),
        config=ICPConfig(compute_dtype=F64), mesh=grid,
        normals_voxel_size=0.5)
    for name, cg in (("dist2d", 100), ("dist3d", 150)):
        run(name, optimize_distributed, _jax_graph(inputs[name]), mesh=dp4,
            iters=15, cg_iters=cg)
    for name in ("schur2d", "schur3d"):
        todo[name] = lambda name=name: optimize_schur(
            _jax_graph(inputs[name]), iters=12, mesh=dp4)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(fn) for name, fn in todo.items()}
        return {name: f.result() for name, f in futures.items()}


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _transform(port, ref, name, atol):
    for rank in port:
        rot, t = rank[name]
        _close(rot, ref[name].rot, atol)
        _close(t, ref[name].t, atol)


CASES = ["ring", "ring_matched", "estimate", "icp2d", "batched",
         "dp_sp_icp2d-f64", "dp_sp_icp2d-f32", "dp_sp_icp3d_planar-f64",
         "dp_sp_icp3d_planar-f32", "p2l", "dist2d", "dist3d", "schur2d",
         "schur3d", "dryrun"]


@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_sharded(case, inputs, port, ref):
    if case.startswith("ring"):
        idx = np.concatenate([rank[case][0] for rank in port])
        dist = np.concatenate([rank[case][1] for rank in port])
        want = ref[case][0] if case == "ring_matched" else ref[case]
        np.testing.assert_array_equal(idx, np.asarray(want.index))
        _close(dist, want.dist_sq, 0.0, 1e-12)
        if case == "ring_matched":
            matched = np.concatenate([rank[case][2] for rank in port])
            np.testing.assert_array_equal(matched, np.asarray(ref[case][1]))
            np.testing.assert_array_equal(matched, inputs["ring"]["db"][idx])
    elif case in ("estimate", "icp2d", "batched") or case.endswith("f64"):
        _transform(port, ref, case, 1e-12)
    elif case.endswith("f32"):
        _transform(port, ref, case, 1e-5)
    elif case == "p2l":
        _transform(port, ref, case, 1e-9)
        src = inputs["p2l"][0]
        t_true = RigidTransform3.from_twist(jnp.asarray(P2L_TRUE, F64))
        for k in range(src.shape[0]):
            rot, t = port[0][case][0][k], port[0][case][1][k]
            pred = src[k] @ rot.T + t
            want = np.asarray(t_true.apply_points(jnp.asarray(src[k])))
            assert np.linalg.norm(pred - want, axis=1).max() < 5e-3
    elif case.startswith("dist"):
        for rank in port:
            rot, t = rank[case]
            for want_rot, want_t in ((ref[case].poses.rot, ref[case].poses.t),
                                     port[0][f"{case}-local"]):
                _close(t, want_t, 1e-5)
                _close(rot, want_rot, 1e-6)
    elif case.startswith("schur"):
        for rank in port:
            rot, t, local_rot, local_t = rank[case]
            for want_rot, want_t in ((ref[case].poses.rot, ref[case].poses.t),
                                     (local_rot, local_t)):
                _close(t, want_t, 1e-10)
                _close(rot, want_rot, 1e-10)
    else:
        # dryrun_multichip's per-rank programs, which raise on a failed
        # check (dryrun_multichip(4, "cpu") itself runs in
        # tests/test_torch_parallel_phase.py).
        for rank in port:
            assert len(rank["dryrun"]) == 19
            assert all(np.isfinite(list(rank["dryrun"].values())))
