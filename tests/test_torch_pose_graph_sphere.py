"""sphere2500 (``bench_port/configs/sphere2500.json``) on the port's dense
pose graph, on the CPU:

- the generator at full size gives the published shape: 2,500 poses and
  4,949 edges, the chain's 2,499 and 2,450 closures (k - 50, k);
- ``pose_graph.optimize(solve="dense")`` on a seeded small sphere (8
  rings of 10) against the plain float64 reference
  (``bench_port/reference/pose_graph.py``), for least squares and Cauchy
  at 1.345: poses within 1e-9 (float64; the two differ in the order of
  sums and in how the Jacobians are taken, ~1e-11 here);
- the cell's judge (``bench_port/judges/graph.py``, the cell's limits)
  passes the program's answer and fails one pose moved 1e-3 m, one
  rotation turned 1e-3 rad, and the answer after 2 iterations;
- the spans ``icp.pose_graph`` > ``icp.graph_linearize``,
  ``icp.graph_assemble``, ``icp.graph_solve`` open, nested, one of each a
  Gauss-Newton iteration, only while a profiler records, and
  ``SOLVES["graph_solves"]`` counts 15 for a call of 15 iterations;
- ``utils/io``'s g2o writer and reader round-trip a generated sphere.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port.data import sphere
from bench_port.entries import pose_graph_dense as entry
from bench_port.inputs import graph as graph_inputs
from bench_port.judges import graph as judge
from bench_port.reference import pose_graph as ref
from icp_rust_tpu_torch.models import pose_graph as pg
from icp_rust_tpu_torch.utils import io, profiling

PKG = Path(__file__).resolve().parent.parent / "bench_port"
CONFIG = json.loads((PKG / "configs" / "sphere2500.json").read_text())
LIMITS = json.loads((PKG / "cells" / "sphere2500-batch-gn.json").read_text())
SMALL = dict(CONFIG["data"], rings=8, poses_per_ring=10)
LEAST_SQUARES = CONFIG["graph"]
CAUCHY = dict(CONFIG["graph"], huber_k=1.345, kernel="cauchy")
SPANS = ("icp.graph_linearize", "icp.graph_assemble", "icp.graph_solve")
TOL = 1e-9


def test_the_generator_gives_the_published_shape():
    d = sphere.make(CONFIG["data"], CONFIG["data"]["seed"])
    ei, ej = d["edge_i"], d["edge_j"]
    assert d["gt_t"].shape == (2500, 3) and d["guess_rot"].shape == (
        2500, 3, 3)
    assert len(ei) == len(ej) == len(d["meas_t"]) == len(d["info"]) == 4949
    chain = (ej - ei) == 1
    closure = (ej - ei) == 50
    assert chain.sum() == 2499 and closure.sum() == 2450
    assert (chain | closure).all()
    assert sorted(ej[closure]) == list(range(50, 2500))
    np.testing.assert_array_equal(np.linalg.norm(d["gt_t"], axis=-1) > 99.99,
                                  True)


@pytest.fixture(scope="module")
def small():
    """The small sphere, its edges in a seeded order, and the program's
    least-squares answer from a traced call: (data, inputs, graph, events
    of the ``icp.`` spans, solves counted, answer)."""
    data = sphere.make(SMALL, 0)
    inputs = graph_inputs.make(data, {"shuffle_edges": True}, 2**31 + 7)
    st = entry.prepare(data, inputs, CONFIG, {}, "cpu")
    pg.reset_solves()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pg.optimize(st["graph"], **LEAST_SQUARES)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("icp.")]
    return (data, inputs, st["graph"], events,
            pg.SOLVES["graph_solves"], out)


def _reference(inputs, settings):
    g = judge.graph_on(inputs, torch.float64, "cpu")
    return ref.solve(g, inputs["rot0"], inputs["t0"], settings)


@pytest.mark.parametrize("objective", ["least_squares", "cauchy"])
def test_the_port_matches_the_plain_reference(small, objective):
    data, inputs, graph, _, _, out = small
    settings = LEAST_SQUARES if objective == "least_squares" else CAUCHY
    if objective == "cauchy":
        out = pg.optimize(graph, **settings)
    r_ref, t_ref = _reference(inputs, settings)
    assert float((out.poses.t - t_ref).abs().max()) < TOL
    assert float((out.poses.rot - r_ref).abs().max()) < TOL
    # The solve moved the poses far from the guess.
    assert float((out.poses.t - inputs["t0"]).abs().max()) > 0.1


def _moved(g):
    t = g.poses.t.clone()
    t[7, 0] += 1e-3
    return g._replace(poses=type(g.poses)(g.poses.rot, t))


def _turned(g):
    c, s = math.cos(1e-3), math.sin(1e-3)
    turn = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                        dtype=g.poses.rot.dtype)
    rot = g.poses.rot.clone()
    rot[7] = turn @ rot[7]
    return g._replace(poses=type(g.poses)(rot, g.poses.t))


@pytest.mark.parametrize("fault", ["none", "moved", "turned",
                                   "two_iterations"])
def test_the_judge_passes_the_program_and_fails_each_fault(small, fault):
    data, inputs, graph, _, _, out = small
    if fault == "moved":
        out = _moved(out)
    elif fault == "turned":
        out = _turned(out)
    elif fault == "two_iterations":
        out = pg.optimize(graph, **dict(LEAST_SQUARES, iters=2))
    ctx = dict(config=CONFIG, limits=LIMITS,
               traffic={"reference": "pose_graph"})
    checks, failed, info = judge.judge(entry.answers([out, out]), data,
                                       inputs, ctx, 3, "cpu")
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    assert ok == (fault == "none") and (failed == 0) == ok, checks
    assert info["answers"] == 1
    if not ok:
        assert failed == 2 * inputs["work"]


def test_the_spans_nest_once_an_iteration_and_solves_count(small):
    _, _, _, events, solves, _ = small
    assert solves == LEAST_SQUARES["iters"] == 15
    (entry_span,) = [e for e in events if e[0] == "icp.pose_graph"]
    inner = [e for e in events if e[0] != "icp.pose_graph"]
    assert sorted({e[0] for e in inner}) == sorted(SPANS)
    for name in SPANS:
        assert sum(e[0] == name for e in inner) == 15
    assert all(entry_span[1] <= e[1] and e[2] <= entry_span[2]
               for e in inner)
    inner.sort(key=lambda e: e[1])
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    assert [e[0] for e in inner[:3]] == list(SPANS)


def test_no_span_opens_without_a_profiler(small, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    pg.reset_solves()
    pg.optimize(small[2], **dict(LEAST_SQUARES, iters=1))
    assert pg.SOLVES["graph_solves"] == 1


def test_g2o_round_trip(small, tmp_path):
    graph = small[5]
    path = str(tmp_path / "sphere.g2o")
    io.save_g2o(path, graph)
    back = io.load_g2o(path)
    for a, b in ((back.poses.rot, graph.poses.rot),
                 (back.poses.t, graph.poses.t),
                 (back.meas.rot, graph.meas.rot),
                 (back.meas.t, graph.meas.t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    torch.testing.assert_close(back.info, graph.info, rtol=0, atol=0)
    torch.testing.assert_close(back.edge_i, graph.edge_i)
    torch.testing.assert_close(back.edge_j, graph.edge_j)
    assert back.poses.t.dtype == torch.float64 and bool(back.edge_mask.all())
    with open(path) as f:
        first = f.readline().split()
    assert first[0] == "VERTEX_SE3:QUAT" and len(first) == 9
