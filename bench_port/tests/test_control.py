"""The control, the plain reference in the program's place computed in
bfloat16 (the precision below the configurations' float32), reads above a
limit of its cell where the program reads below every limit: at a tiny
size on the CPU, through the script that gives the cell's readings on the
card (``control.py``)."""

import json

import pytest

from bench_port.tests import checkout
from bench_port.tests.fixtures import tiny  # noqa: F401 (a fixture)

CODE = """
import json
from bench_port import control
r = control.readings({w!r}, [2**31 + 3], [2**31 + 5], "bfloat16",
                     device="cpu")
print(json.dumps(r))
"""


@pytest.mark.parametrize("workload", ["scan2d-tiny-pairs", "vlp16-tiny-p2l"])
def test_the_control_fails_where_the_program_passes(tiny, workload):
    root, tmp = tiny
    p = checkout.run_python(root, tmp, CODE.format(w=workload))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    prog, ctrl = out["program"][0], out["control"][0]
    assert prog["failed"] == 0 and ctrl["failed"] > 0
    lim = out["summary"]
    assert all(prog[n] <= lim[n]["limit"] for n in lim)
    assert any(ctrl[n] > lim[n]["limit"] for n in lim)
