"""On the card: each cell of BENCHMARK.json runs briefly through
``BENCHMARK.json``'s command and prints a correct result as its last
line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.tests.fixtures import card  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
    ["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        workload, "--seed", str(2**31 + 17), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
