"""The port's SE(2)/SE(3) pose graph (``models/pose_graph.py``) against the
JAX package's, on the same float64 graphs (the noisy circle and helix of
tests/test_pose_graph*.py, carried over with
``convert.pose_graph_from_numpy``).

Tolerance 1e-9 everywhere (float64): residuals, Jacobians, errors and
optimized poses differ only in the order of sums (einsum, scatter-adds,
LU and CG dot products), ~1e-13 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.geometry.transform2d import RigidTransform2 as J2
from icp_rust_tpu.geometry.transform3d import RigidTransform3 as J3
from icp_rust_tpu.models import pose_graph as jpg
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.geometry.transform3d import RigidTransform3
from icp_rust_tpu_torch.models import pose_graph as pg

TOL = 1e-9
F64 = jnp.float64
# Jitted: the JAX package calls these inside jit; eagerly they take ~10 s.
_j_edges = jax.jit(jpg.edge_residuals_and_jacobians)
_j_error = jax.jit(jpg.graph_error, static_argnames=("huber_k",))


def _port(graph):
    """The JAX graph's arrays as the port's PoseGraph."""
    return convert.pose_graph_from_numpy(
        np.asarray(graph.poses.rot), np.asarray(graph.poses.t),
        np.asarray(graph.edge_i), np.asarray(graph.edge_j),
        np.asarray(graph.meas.rot), np.asarray(graph.meas.t),
        np.asarray(graph.info), np.asarray(graph.edge_mask))


def _chain_graph(jcls, steps, loop_info, n=24, seed=0, bad=None):
    """A noisy odometry chain of ``steps``-sized twists closing with one
    exact loop edge (tests/test_pose_graph*.py's construction), optionally
    with a grossly wrong extra edge 3 -> 20."""
    rng = np.random.default_rng(seed)
    dof = len(steps)
    z_true = jcls.from_twist(jnp.asarray(steps, F64))
    d = 2 if dof == 3 else 3
    rots, ts = [jnp.eye(d, dtype=F64)], [jnp.zeros(d, dtype=F64)]
    for _ in range(n - 1):
        nxt = jcls(rots[-1], ts[-1]).compose(z_true)
        rots.append(nxt.rot)
        ts.append(nxt.t)
    noise = rng.normal(0, 0.01, (n - 1, dof)) + 0.02 * (np.arange(dof) == 0)
    chain = jcls.from_twist(jnp.asarray(np.asarray(steps) + noise, F64))
    z_loop = jcls(rots[0], ts[0]).inverse().compose(jcls(rots[-1], ts[-1]))
    extra = [(0, n - 1, z_loop, loop_info * np.eye(dof))]
    if bad is not None:
        extra.append((3, 20, jcls.from_twist(jnp.asarray(bad, F64)),
                      100.0 * np.eye(dof)))
    return jpg.odometry_chain_graph(chain, extra_edges=extra)


@pytest.fixture(scope="module")
def graphs():
    se2 = [2 * np.pi * 5.0 / 24, 0.0, 2 * np.pi / 24]
    se3 = [2 * np.pi * 5.0 / 24, 0.0, 0.05, 0.01, 0.015, 2 * np.pi / 24]
    return {
        "se2": _chain_graph(J2, se2, 100.0),
        "se3": _chain_graph(J3, se3, 100.0),
        "se2-bad": _chain_graph(J2, se2, 100.0, bad=[30.0, -20.0, 1.5]),
        "se3-bad": _chain_graph(J3, se3, 100.0,
                                bad=[30.0, -20.0, 10.0, 0.8, -0.5, 1.2]),
    }


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("group", ["se2-bad", "se3-bad"])
def test_residuals_jacobians_and_error_match_jax(graphs, group):
    graph = graphs[group]
    r, ji, jj = pg.edge_residuals_and_jacobians(_port(graph))
    jr, jji, jjj = _j_edges(graph)
    for got, want in ((r, jr), (ji, jji), (jj, jjj)):
        _assert_close(got.numpy(), want)
    for k in (None, 1.345):
        np.testing.assert_allclose(
            float(pg.graph_error(_port(graph), huber_k=k)),
            float(_j_error(graph, huber_k=k)), rtol=TOL)


def _identity_graph(jcls, meas_twists):
    """Two-pose edges (0 -> 1) with both poses at the identity and the
    given measurements: the residual is Log(z^-1)."""
    e, dof = meas_twists.shape
    d = 2 if dof == 3 else 3
    z = jcls.from_twist(jnp.asarray(meas_twists, F64))
    jgraph = jpg.PoseGraph(
        poses=jcls(jnp.broadcast_to(jnp.eye(d, dtype=F64), (2, d, d)),
                   jnp.zeros((2, d), F64)),
        edge_i=jnp.zeros(e, jnp.int32), edge_j=jnp.ones(e, jnp.int32),
        meas=z, info=jnp.broadcast_to(jnp.eye(dof, dtype=F64), (e, dof, dof)),
        edge_mask=jnp.ones(e, bool))
    return jgraph, _port(jgraph)


@pytest.mark.parametrize("group", ["se2", "se3"])
def test_jacobians_at_exactly_zero_residuals(group):
    """Pure-translation measurements between poses integrated from them:
    the residual's rotation is the identity bitwise, so the rotation log
    sits at arccos(1) in its unselected branch, and the translation part is
    roundoff; identity poses and measurement give an exactly zero residual.  The Jacobians stay finite and
    equal the JAX package's."""
    dof = 3 if group == "se2" else 6
    rng = np.random.default_rng(3)
    n_t = 2 if dof == 3 else 3  # the twist's translation part
    tw = np.zeros((5, dof))
    tw[:, :n_t] = rng.normal(size=(5, n_t))
    jcls = J2 if group == "se2" else J3
    chain = jcls.from_twist(jnp.asarray(tw, F64))
    jgraph = jpg.odometry_chain_graph(chain)
    r, ji, jj = pg.edge_residuals_and_jacobians(_port(jgraph))
    rot_part = r[:, 2:] if dof == 3 else r[:, 3:]
    assert torch.equal(rot_part, torch.zeros_like(rot_part))
    assert float(torch.abs(r).max()) < 1e-14
    assert torch.isfinite(ji).all() and torch.isfinite(jj).all()
    jr, jji, jjj = _j_edges(jgraph)
    _assert_close(ji.numpy(), jji)
    _assert_close(jj.numpy(), jjj)
    # Identity poses, identity measurement: R = I bitwise.
    _, graph = _identity_graph(jcls, np.zeros((1, dof)))
    r, ji, _ = pg.edge_residuals_and_jacobians(graph)
    assert torch.equal(r, torch.zeros_like(r)) and torch.isfinite(ji).all()
    # so3.log's Taylor tangent at the identity under jacfwd.
    if group == "se3":
        from icp_rust_tpu_torch.geometry import so3

        jac = torch.func.jacfwd(lambda w: so3.log(so3.exp(w)))(
            torch.zeros(3, dtype=torch.float64))
        np.testing.assert_allclose(jac.numpy(), np.eye(3), atol=1e-12)


@pytest.mark.parametrize("group", ["se2", "se3"])
def test_jacobians_near_pi_residuals(group):
    """Residual rotations 1e-6, 1e-4 and 1e-2 short of pi (the SO(3)
    near-pi branch for the first two, the generic one for the last)."""
    dof = 3 if group == "se2" else 6
    jcls = J2 if group == "se2" else J3
    angles = np.pi - np.array([1e-6, 1e-4, 1e-2])
    tw = np.zeros((3, dof))
    tw[:, 0] = 0.3
    if dof == 3:
        tw[:, 2] = angles
    else:
        axis = np.array([0.48, -0.6, 0.64])
        tw[:, 3:] = angles[:, None] * axis
    jgraph, graph = _identity_graph(jcls, tw)
    r, ji, jj = pg.edge_residuals_and_jacobians(graph)
    jr, jji, jjj = _j_edges(jgraph)
    assert torch.isfinite(ji).all() and torch.isfinite(jj).all()
    _assert_close(r.numpy(), jr)
    for got, want in ((ji, jji), (jj, jjj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("group", ["se2", "se3"])
@pytest.mark.parametrize("solve", ["dense", "cg"])
@pytest.mark.parametrize("kernel", [None, "huber", "cauchy"])
def test_optimize_matches_jax(graphs, group, solve, kernel):
    """The clean loop graph for least squares and Huber; Cauchy also with a
    grossly wrong edge, which it suppresses (least squares and Huber let
    it drag the graph, where GN amplifies roundoff to ~1e-6)."""
    graph = graphs[group if kernel != "cauchy" else group + "-bad"]
    kw = dict(iters=8, solve=solve, cg_iters=60)
    if kernel is not None:
        kw.update(huber_k=1.345, kernel=kernel)
    out = pg.optimize(_port(graph), **kw)
    want = jpg.optimize(graph, **kw)
    _assert_close(out.poses.t.numpy(), want.poses.t)
    _assert_close(out.poses.rot.numpy(), want.poses.rot)
    assert out.poses.t.dtype == torch.float64


def test_optimize_pulls_the_loop_closed_and_keeps_the_gauge(graphs):
    """The JAX tests' own checks on the port: the error falls, pose 0 stays
    at the identity, and a converged step is zeroed."""
    graph = _port(graphs["se3"])
    e0 = float(pg.graph_error(graph))
    out = pg.optimize(graph, iters=25, solve="dense", huber_k=1.345,
                      kernel="cauchy")
    assert float(pg.graph_error(out)) < 0.05 * e0
    np.testing.assert_allclose(out.poses.t[0].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(out.poses.rot[0].numpy(), np.eye(3),
                               atol=1e-6)
    again = pg.optimize(out, iters=3, solve="dense", huber_k=1.345,
                        kernel="cauchy", delta_tol=1e30)
    assert not torch.equal(again.poses.t, out.poses.t)  # step 1 moves
    once = pg.optimize(out, iters=1, solve="dense", huber_k=1.345,
                       kernel="cauchy")
    assert torch.equal(again.poses.t, once.poses.t)  # then it is done
    with pytest.raises(ValueError, match="solve"):
        pg.optimize(graph, solve="lu")


def test_odometry_chain_graph_and_transform2_log_match_jax():
    rng = np.random.default_rng(9)
    tw = rng.normal(0, 0.3, (6, 3))
    jchain = J2.from_twist(jnp.asarray(tw, F64))
    chain = RigidTransform2.from_twist(torch.as_tensor(tw))
    z = RigidTransform2.from_twist(torch.as_tensor(rng.normal(size=3)))
    jz = J2(jnp.asarray(z.rot.numpy()), jnp.asarray(z.t.numpy()))
    got = pg.odometry_chain_graph(chain, extra_edges=[(0, 5, z, np.eye(3))])
    want = jpg.odometry_chain_graph(jchain, extra_edges=[(0, 5, jz,
                                                          np.eye(3))])
    _assert_close(got.poses.t.numpy(), want.poses.t)
    _assert_close(got.poses.rot.numpy(), want.poses.rot)
    np.testing.assert_array_equal(got.edge_i.numpy(), np.asarray(want.edge_i))
    np.testing.assert_array_equal(got.info.numpy(), np.asarray(want.info))
    _assert_close(chain.log().numpy(), jchain.log())
    assert chain.batch_shape == (6,)
    back = RigidTransform2.from_twist(chain.log())
    _assert_close(back.t.numpy(), chain.t.numpy())
    assert RigidTransform2.from_rt(z.rot, z.t).rot is z.rot
    # Under torch.func the 2D log (no in-place writes) differentiates.
    jac = torch.func.jacfwd(lambda w: RigidTransform2.from_twist(w).log())(
        torch.zeros(3, dtype=torch.float64))
    np.testing.assert_allclose(jac.numpy(), np.eye(3), atol=1e-12)
    jjac = jax.jacfwd(lambda w: J2.from_twist(w).log())(jnp.zeros(3, F64))
    _assert_close(jac.numpy(), jjac)
    assert isinstance(pg.odometry_chain_graph(
        RigidTransform3.identity((2,), torch.float64)).poses,
        RigidTransform3)
