"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and
nothing it opens is the JAX package's benchmark files."""

import json
from pathlib import Path

from bench_port.tests import checkout
from bench_port.tests.fixtures import tiny  # noqa: F401 (a fixture)

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "icp_rust_tpu"}
# The JAX package's benchmark files, which measured it on a TPU.
JAX_BENCH = ("benchmarks/", "bench.py", "BENCH_r", "MULTICHIP_",
             "BASELINE_MEASURED")

LOADED = """
import json, sys
from pathlib import Path
from bench_port import harness
import bench_port.control, bench_port.reference.icp
for kind in ("reference", "data", "inputs", "judges"):
    for f in sorted((harness.PKG / kind).glob("*.py")):
        __import__(f"bench_port.{kind}.{f.stem}")
for f in sorted((harness.PKG / "metrics").glob("*.py")):
    harness.load_reader(f.stem)
before = sorted({m.split(".")[0] for m in sys.modules})
for f in sorted((harness.PKG / "entries").glob("*.py")):
    __import__(f"bench_port.entries.{f.stem}")
after = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps([before, after]))
"""


def test_the_harness_loads_no_jax_and_the_port_only_in_entries(tiny):
    root, tmp = tiny
    p = checkout.run_python(root, tmp, LOADED)
    assert p.returncode == 0, p.stderr
    before, after = json.loads(p.stdout.strip().splitlines()[-1])
    assert not FORBIDDEN & set(before), before
    assert "icp_rust_tpu_torch" not in before
    assert not FORBIDDEN & set(after), after
    assert "icp_rust_tpu_torch" in after


def test_the_reference_imports_nothing_of_the_program():
    for f in (PKG / "reference").glob("*.py"):
        src = f.read_text()
        assert "icp_rust_tpu" not in src and "jax" not in src, f


AUDIT = """
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], (str, bytes)) else None)
from bench_port import harness
r = harness.run({w!r}, 11, 0.2, {trace}, device="cpu")
print(json.dumps(dict(opened=opened, loaded=sorted(
    {{m.split(".")[0] for m in sys.modules}}), correct=r["correct"])))
"""


def test_a_run_opens_no_jax_benchmark_file_and_loads_no_jax(tiny):
    root, tmp = tiny
    for w, trace in (("scan2d-tiny-pairs", 1), ("vlp16-tiny-p2l", 0)):
        p = checkout.run_python(root, tmp, AUDIT.format(w=w, trace=trace))
        assert p.returncode == 0, p.stderr[-4000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"]
        assert not FORBIDDEN & set(out["loaded"]), out["loaded"]
        bad = [f for f in out["opened"] if any(s in f for s in JAX_BENCH)]
        assert not bad, bad


def test_no_source_of_the_benchmark_names_a_jax_benchmark_file():
    for f in PKG.rglob("*.py"):
        if "tests" in f.parts:
            continue
        src = f.read_text()
        assert not any(s in src for s in JAX_BENCH), f


MAIN = """
import sys, time
from bench_port import harness
sys.exit(harness.main(["--workload", {w!r}, "--seed", "5", "--seconds",
                       "0.2", "--trace", "1"], time.perf_counter(),
                      device="cpu"))
"""


def test_a_run_that_loads_jax_after_its_window_prints_no_result(tmp_path):
    """A metric reader, read after the window and the judge, imports jax
    (a stand-in package in the checkout): the run exits 3, names it, and
    prints no result line."""
    def add(root, spec):
        (root / "jax").mkdir()
        (root / "jax" / "__init__.py").write_text("")
        (root / "bench_port" / "metrics" / "late_import.py").write_text(
            "def read(run):\n    import jax  # noqa: F401\n    return 1.0\n")
        spec["per_layer"].append(dict(
            name="late_import", unit="calls", better="lower",
            source="program_counter", layer="device", moves="pairs_per_s",
            workloads=["scan2d-tiny-pairs"]))

    root = checkout.make(tmp_path, extra=add)
    w = "scan2d-tiny-pairs"
    p = checkout.run_python(root, tmp_path, MAIN.format(w=w))
    assert p.returncode == 3, p.stderr[-4000:]
    assert "jax" in p.stderr and "{" not in p.stdout
    (root / "bench_port" / "metrics" / "late_import.py").write_text(
        "def read(run):\n    return 1.0\n")
    p = checkout.run_python(root, tmp_path, MAIN.format(w=w))
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
