"""A run whose timed path is broken underneath comes out not correct, once
for each fault a cell of these entries can have (the run's look for a chip
skipped, at a tiny size on the CPU): the sound program first, then a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced.  The one-chip cells have no exchange between
chips to leave out."""

import pytest

from bench_port.tests import checkout
from bench_port.tests.fixtures import tiny  # noqa: F401 (a fixture)

UNCHANGED = """lambda call: lambda st: type(st["t0"])(st["t0"].rot.clone(),
                                                  st["t0"].t.clone())"""
HALF = """lambda call: lambda st: (lambda o, h: type(o)(
    __import__("torch").cat([o.rot[:h], st["t0"].rot[h:]]),
    __import__("torch").cat([o.t[:h], st["t0"].t[h:]])))(
        call(st), st["t0"].t.shape[0] // 2)"""
ALTERED = """lambda call: lambda st: (lambda o: type(o)(
    o.rot, o.t + __import__("torch").nn.functional.pad(
        __import__("torch").full((1, 1), 0.01), (0, o.t.shape[1] - 1,
                                                  0, o.t.shape[0] - 1))))(
        call(st))"""


@pytest.mark.parametrize("workload", ["scan2d-tiny-pairs", "vlp16-tiny-p2l"])
def test_faults_come_out_not_correct(tiny, workload):
    root, tmp = tiny
    sound = checkout.rehearse(root, tmp, workload)
    assert sound["correct"] and sound["failed"] == 0
    for wrap in (UNCHANGED, HALF, ALTERED):
        r = checkout.rehearse(root, tmp, workload, wrap=wrap)
        assert not r["correct"] and r["failed"] > 0, (wrap, r["checks"])
