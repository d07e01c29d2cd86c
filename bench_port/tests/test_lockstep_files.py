"""The lockstep traffic and its limits (``traffic/mapping-lockstep.json``,
``cells/scan2d-mapping-lockstep.json``), kept for the cell that PERF.md
holds back until its runs spread less: at a tiny size on the CPU, with
their entry added to BENCHMARK.json as files alone, a sound run is correct
and reads the per-layer metrics the cell would list, each fault of
``test_faults`` comes out not correct, and the control fails a limit that
the program meets."""

import json

import pytest

from bench_port.tests import checkout
from bench_port.tests.test_control import CODE
from bench_port.tests.test_faults import ALTERED, HALF, UNCHANGED

CELL = "scan2d-tiny-lockstep"
# The readers the cell would list (PERF.md, the cells held back).
PER_LAYER = ("device_idle_share", "device_idle_share.outer_loop",
             "device_idle_share.prepare", "device_idle_share.outside_program",
             "nn_searches_per_call", "host_syncs_per_call",
             "batch_latency_p95_ms.mapping_2d")


def _add(root, spec):
    pkg = root / "bench_port"
    traffic = json.loads((pkg / "traffic" / "mapping-lockstep.json")
                         .read_text())
    assert traffic["program"] == {}  # the default route, not kernel 10
    (pkg / "traffic" / "mapping-lockstep-tiny.json").write_text(json.dumps(
        dict(traffic, warmup_calls=1, trace_calls=2)))
    lim = json.loads((pkg / "cells" / "scan2d-mapping-lockstep.json")
                     .read_text())
    (pkg / "cells" / f"{CELL}.json").write_text(json.dumps(
        dict(lim, gap_pairs=2)))
    spec["workloads"].append(dict(name=CELL, config="scan2d-tiny",
                                  traffic="mapping-lockstep-tiny", chips=1,
                                  why="tiny CPU rehearsal"))
    for m in spec["per_layer"]:
        if m["name"] in PER_LAYER:
            m["workloads"].append(CELL)


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lockstep")
    return checkout.make(tmp, extra=_add), tmp


def test_a_sound_run_is_correct_and_reads_its_metrics(lockstep):
    root, tmp = lockstep
    plain = checkout.rehearse(root, tmp, CELL)
    assert plain["correct"] and plain["failed"] == 0
    assert set(plain["metrics"]) == {"pairs_per_s", "setup_s"}
    traced = checkout.rehearse(root, tmp, CELL, trace=1)
    assert traced["correct"]
    # On the CPU only the host clock's reader finds something to read.
    assert set(traced["metrics"]) == {"batch_latency_p95_ms.mapping_2d"}


@pytest.mark.parametrize("wrap", [UNCHANGED, HALF, ALTERED],
                         ids=["unchanged", "half", "altered"])
def test_faults_come_out_not_correct(lockstep, wrap):
    root, tmp = lockstep
    r = checkout.rehearse(root, tmp, CELL, wrap=wrap)
    assert not r["correct"] and r["failed"] > 0, r["checks"]


def test_the_control_fails_where_the_program_passes(lockstep):
    root, tmp = lockstep
    p = checkout.run_python(root, tmp, CODE.format(w=CELL))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    prog, ctrl = out["program"][0], out["control"][0]
    assert prog["failed"] == 0 and ctrl["failed"] > 0
    lim = out["summary"]
    assert all(prog[n] <= lim[n]["limit"] for n in lim)
    assert any(ctrl[n] > lim[n]["limit"] for n in lim)
