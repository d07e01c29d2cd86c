"""The pose-graph cell's files (``configs/sphere2500.json``,
``traffic/graph-batch-gn.json``, ``cells/sphere2500-batch-gn.json``) at a
reduced sphere (8 rings of 10) on the CPU, through the harness: a sound
run is correct and reads the per-layer metrics the CPU can read, each of
three faults comes out not correct (one pose moved 1e-3 m, one rotation
turned 1e-3 rad, the answer after 2 iterations), and the control, the
reference in float32, fails a limit that the program meets."""

import json

import pytest

from bench_port.tests import checkout

CELL = "sphere-tiny-gn"
REAL = "sphere2500-batch-gn"

MOVED = """lambda call: lambda st: (lambda g: g._replace(
    poses=type(g.poses)(g.poses.rot, g.poses.t.index_add(
        0, __import__("torch").tensor([7]),
        __import__("torch").tensor([[1e-3, 0.0, 0.0]],
                                   dtype=g.poses.t.dtype)))))(call(st))"""
TURNED = """lambda call: lambda st: (lambda g, c, s: g._replace(
    poses=type(g.poses)(g.poses.rot.index_copy(
        0, __import__("torch").tensor([7]),
        __import__("torch").tensor([[[c, -s, 0], [s, c, 0], [0, 0, 1]]],
                                   dtype=g.poses.rot.dtype)
        @ g.poses.rot[7:8]), g.poses.t)))(
    call(st), __import__("math").cos(1e-3), __import__("math").sin(1e-3))"""
TWO_ITERATIONS = """lambda call: lambda st: __import__(
    "icp_rust_tpu_torch.models.pose_graph", fromlist=["optimize"]).optimize(
        st["graph"], **dict(st["settings"], iters=2))"""

CONTROL = """
import json
from bench_port import control
r = control.readings({w!r}, [2**31 + 3], [2**31 + 5], "float32",
                     device="cpu")
print(json.dumps(r))
"""


def _add(root, spec):
    pkg = root / "bench_port"
    cfg = json.loads((pkg / "configs" / "sphere2500.json").read_text())
    cfg["data"].update(rings=8, poses_per_ring=10)
    (pkg / "configs" / "sphere-tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(spec["configs"][0], name="sphere-tiny",
                                file="bench_port/configs/sphere-tiny.json"))
    (pkg / "cells" / f"{CELL}.json").write_text(
        (pkg / "cells" / f"{REAL}.json").read_text())
    spec["workloads"].append(dict(name=CELL, config="sphere-tiny",
                                  traffic="graph-batch-gn", chips=1,
                                  why="tiny CPU rehearsal"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)


@pytest.fixture(scope="module")
def graph_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph")
    return checkout.make(tmp, extra=_add), tmp


def test_a_sound_run_is_correct_and_reads_its_metrics(graph_cell):
    root, tmp = graph_cell
    plain = checkout.rehearse(root, tmp, CELL)
    assert plain["correct"] and plain["failed"] == 0
    assert plain["attempted"] % 149 == 0   # 79 chain edges, 70 closures
    assert set(plain["metrics"]) == {"pairs_per_s", "setup_s"}
    traced = checkout.rehearse(root, tmp, CELL, trace=1)
    assert traced["correct"]
    # On the CPU only the program's counter finds something to read.
    assert traced["metrics"] == {"graph_solves_per_call": {
        "value": 15.0, "unit": "solves"}}


@pytest.mark.parametrize("wrap", [MOVED, TURNED, TWO_ITERATIONS],
                         ids=["moved", "turned", "two_iterations"])
def test_faults_come_out_not_correct(graph_cell, wrap):
    root, tmp = graph_cell
    r = checkout.rehearse(root, tmp, CELL, wrap=wrap)
    assert not r["correct"] and r["failed"] > 0, r["checks"]


def test_the_control_fails_where_the_program_passes(graph_cell):
    root, tmp = graph_cell
    p = checkout.run_python(root, tmp, CONTROL.format(w=CELL))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    prog, ctrl = out["program"][0], out["control"][0]
    assert prog["failed"] == 0 and ctrl["failed"] > 0
    lim = out["summary"]
    assert all(prog[n] <= lim[n]["limit"] for n in lim)
    assert any(ctrl[n] > lim[n]["limit"] for n in lim)
