"""A configuration, a traffic mix, a cell and a metric added as files,
with their entries in BENCHMARK.json, run with no edit of the harness:
pairs two scans apart from perturbed true poses, where the cells of the
benchmark take consecutive pairs from identity.  The run writes only
inside its checkout, HOME, XDG_CACHE_HOME and TMPDIR."""

import json
import os

from bench_port.tests import checkout


def _add(root, spec):
    pkg = root / "bench_port"
    cfg = dict(checkout.SCAN2D, data=dict(
        checkout.SCAN2D["data"], scans=7, rays=48, min_points=30,
        max_points=50, pad_to=64))
    (pkg / "configs" / "scan2d-new.json").write_text(json.dumps(cfg))
    (pkg / "cells" / "scan2d-new-skip.json").write_text(json.dumps(
        {"limits": {"gap": 0.01, "step": 0.01}, "gap_pairs": 3}))
    traffic = json.loads((pkg / "traffic" / "mapping-pairs.json")
                         .read_text())
    (pkg / "traffic" / "skip-one-perturbed.json").write_text(json.dumps(
        dict(traffic, pairs={"gap": 2}, shuffle_pairs=True,
             warm_start={"from": "truth", "perturb_m": 0.05,
                         "perturb_rad": 0.02, "perturb_seed": 3},
             warmup_calls=1, trace_calls=2)))
    (pkg / "metrics" / "src_points_per_pair.py").write_text(
        "def read(run):\n"
        "    return float(run['valid_src'].sum()) / run['work_per_call']\n")
    spec["configs"].append(dict(spec["configs"][1], name="scan2d-new",
                                file="bench_port/configs/scan2d-new.json"))
    spec["workloads"].append(dict(name="scan2d-new-skip",
                                  config="scan2d-new",
                                  traffic="skip-one-perturbed", chips=1,
                                  why="added by files alone"))
    spec["per_layer"].append(dict(name="src_points_per_pair", unit="points",
                                  better="higher", source="program_counter",
                                  layer="driver", moves="pairs_per_s",
                                  workloads=["scan2d-new-skip"]))


WRITES = """
import json, os, sys
written = []
def hook(ev, args):
    if ev == "open" and isinstance(args[0], str) and args[1] is not None \\
            and any(c in str(args[1]) for c in "wax+"):
        written.append(os.path.abspath(args[0]))
    elif ev in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                "shutil.copyfile"):
        written.append(os.path.abspath(str(args[0])))
sys.addaudithook(hook)
from bench_port import harness
out = [harness.run("scan2d-new-skip", 5, 0.2, t, device="cpu")
       for t in (False, True)]
ctx = harness.resolve("scan2d-new-skip")
data, inp = harness.make_inputs(ctx, 5)
warm = float((inp["t0"] - inp["gt_t"]).abs().max())
print(json.dumps(dict(written=written, runs=out, warm=warm,
                      pairs=inp["pairs"].tolist())))
"""


def test_a_cell_added_as_files_runs_and_writes_only_where_allowed(tmp_path):
    root = checkout.make(tmp_path, extra=_add)
    p = checkout.run_python(root, tmp_path, WRITES)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    plain, traced = out["runs"]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"pairs_per_s", "setup_s"}
    assert 30 <= traced["metrics"]["src_points_per_pair"]["value"] <= 50
    assert 0 < out["warm"] <= 0.05
    assert sorted(out["pairs"]) == [[k, k + 2] for k in range(5)]
    assert out["pairs"] != sorted(out["pairs"])
    env = checkout.env(tmp_path)
    allowed = [str(root)] + [env[v] for v in ("HOME", "XDG_CACHE_HOME",
                                               "TMPDIR")]
    for f in out["written"]:
        if f == os.devnull:
            continue
        assert any(f == a or f.startswith(a + os.sep) for a in allowed), f
        assert not f.startswith("/dev/shm")
