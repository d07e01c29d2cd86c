"""The port's chain-elimination Schur solver (``models/graph_schur``)
against the dense Gauss-Newton solve and the JAX package's
``optimize_schur``, on the graphs of ``tests/test_graph_schur.py``.

Tolerances (float64 graphs): the per-iteration delta within 1e-6 of the
dense solve's largest component (the dense solve's 1e8 gauge prior sets
its accuracy); optimized poses within 1e-8 of the dense GN's and of the
JAX package's Schur GN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.geometry.transform2d import RigidTransform2 as JT2
from icp_rust_tpu.geometry.transform3d import RigidTransform3 as JT3
from icp_rust_tpu.models import pose_graph as jpg
from icp_rust_tpu.models.graph_schur import optimize_schur as j_schur
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.models.graph_schur import _solve_delta, _structure, \
    optimize_schur

F64 = jnp.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    several processes, whose thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph2d(n=60, n_loops=3, seed=0):
    rng = np.random.default_rng(seed)
    step = np.array([1.0, 0.0, 2 * np.pi / n])
    noisy = step + rng.normal(0, [0.02, 0.02, 0.01], (n - 1, 3))
    chain = JT2.from_twist(jnp.asarray(noisy, F64))
    gt = [JT2.identity(dtype=F64)]
    z = JT2.from_twist(jnp.asarray(step, F64))
    for _ in range(n - 1):
        gt.append(gt[-1].compose(z))
    pairs = [(0, n - 1), (5, n // 2), (10, 3 * n // 4)][:n_loops]
    extra = [(i, j, gt[i].inverse().compose(gt[j]), 50.0 * np.eye(3))
             for i, j in pairs]
    return jpg.odometry_chain_graph(chain, extra_edges=extra)


def _graph3d(n=40, seed=1):
    rng = np.random.default_rng(seed)
    step = np.array([1.0, 0.0, 0.05, 0.01, 0.0, 2 * np.pi / n])
    noisy = step + rng.normal(0, 0.01, (n - 1, 6))
    chain = JT3.from_twist(jnp.asarray(noisy, F64))
    gt = [JT3.identity(dtype=F64)]
    z = JT3.from_twist(jnp.asarray(step, F64))
    for _ in range(n - 1):
        gt.append(gt[-1].compose(z))
    extra = [(0, n - 1, gt[0].inverse().compose(gt[-1]), 50.0 * np.eye(6)),
             (7, 2 * n // 3, gt[7].inverse().compose(gt[2 * n // 3]),
              50.0 * np.eye(6))]
    return jpg.odometry_chain_graph(chain, extra_edges=extra)


def _adjacent():
    """Loop endpoints right next to each other: zero-length segments."""
    rng = np.random.default_rng(3)
    n = 20
    chain = JT2.from_twist(jnp.asarray(
        np.array([1.0, 0, 0.1]) + rng.normal(0, 0.01, (n - 1, 3)), F64))
    z = JT2.from_twist(jnp.asarray([2.0, 0.1, 0.2], F64))
    extra = [(3, 4, z, 10.0 * np.eye(3)), (4, 5, z, 10.0 * np.eye(3))]
    return jpg.odometry_chain_graph(chain, extra_edges=extra)


def _port(jg) -> pg.PoseGraph:
    return convert.pose_graph_from_numpy(*[np.array(x) for x in (
        jg.poses.rot, jg.poses.t, jg.edge_i, jg.edge_j, jg.meas.rot,
        jg.meas.t, jg.info, jg.edge_mask)])


def _close(out, want, atol=1e-8):
    np.testing.assert_allclose(out.poses.t.numpy(), np.asarray(want.poses.t),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(out.poses.rot.numpy(),
                               np.asarray(want.poses.rot), atol=atol, rtol=0)


@pytest.mark.parametrize("graph_fn", [_graph2d, _graph3d])
def test_schur_delta_equals_dense_solve(graph_fn):
    graph = _port(graph_fn())
    dof = graph.info.shape[-1]
    p = graph.poses.t.shape[0]
    r, ji, jj = pg.edge_residuals_and_jacobians(graph)
    w = pg._edge_weights(r, graph.info, graph.edge_mask, None)
    h, b = pg._assemble_dense(graph, r, ji, jj, w)
    gauge = pg._gauge_prior(p, dof, torch.float64, "cpu")
    dense = -torch.linalg.solve(
        h + torch.diag(gauge) + 1e-10 * torch.eye(dof * p,
                                                  dtype=torch.float64), b)
    schur = _solve_delta(graph, r, ji, jj, w, _structure(graph)).reshape(-1)
    scale = float(dense.abs().max()) + 1e-30
    assert float((schur - dense).abs().max()) < 1e-6 * max(scale, 1.0)


@pytest.mark.parametrize("graph_fn", [_graph2d, _graph3d])
def test_schur_optimization_matches_dense_gn_and_jax(graph_fn):
    jg = graph_fn()
    graph = _port(jg)
    out = optimize_schur(graph, iters=15)
    _close(out, pg.optimize(graph, iters=15, solve="dense"))
    _close(out, j_schur(jg, iters=15))


def test_schur_robust_kernel():
    jg = _graph2d()
    graph = _port(jg)
    kw = dict(iters=12, huber_k=1.345, kernel="cauchy")
    out = optimize_schur(graph, **kw)
    _close(out, pg.optimize(graph, solve="dense", **kw))
    _close(out, j_schur(jg, **kw))


def test_schur_adjacent_skeleton_nodes():
    jg = _adjacent()
    graph = _port(jg)
    out = optimize_schur(graph, iters=10)
    _close(out, pg.optimize(graph, iters=10, solve="dense"))
    _close(out, j_schur(jg, iters=10))


def test_schur_rejects_non_chain_graph_and_a_mesh():
    graph = _port(_graph2d())
    ei = graph.edge_i.clone()
    ei[3] = 7
    with pytest.raises(ValueError):
        optimize_schur(graph._replace(edge_i=ei), iters=2)
    with pytest.raises(ValueError):
        j_schur(_graph2d()._replace(
            edge_i=_graph2d().edge_i.at[3].set(7)), iters=2)
    with pytest.raises(TypeError, match="DeviceMesh, got object"):
        optimize_schur(graph, iters=2, mesh=object())
