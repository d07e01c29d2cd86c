"""chip_smoke.py's phase 24 (``parallel/`` on torch.distributed) at a tiny
size on the CPU: four gloo CPU ranks, where the ring takes the plain
``nn_torch`` and every other wrapper its kernel's plain version.  The
phase's own gates hold (the sharded drivers within 1 mm of the
single-device ones and within the ATE gate, the ring bitwise the
whole-cloud search, ``batched_icp2d`` with a mesh bitwise each rank's
slice and within 1e-5 of the full call, the sharded graph solves within
their tolerances, the dry run's checks)."""

import os
import sys

import numpy as np
import pytest
import torch

from icp_rust_tpu_torch.geometry.transform2d import RigidTransform2
from icp_rust_tpu_torch.models import pose_graph as pg


@pytest.fixture(scope="module")
def chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(root)
    return mod


def _loop_graph(n=12, seed=0):
    """A float64 SE(2) chain with drift and two loop closures."""
    rng = np.random.default_rng(seed)
    step = np.array([1.0, 0.0, 2 * np.pi / n])
    chain = RigidTransform2.from_twist(torch.as_tensor(
        step + rng.normal(0, [0.02, 0.02, 0.01], (n - 1, 3))))
    z = RigidTransform2.from_twist(torch.as_tensor(step))
    gt = [RigidTransform2.identity(dtype=torch.float64)]
    for _ in range(n - 1):
        gt.append(gt[-1].compose(z))
    extra = [(i, j, gt[i].inverse().compose(gt[j]), 50.0 * np.eye(3))
             for i, j in ((0, n - 1), (2, n // 2))]
    return pg.odometry_chain_graph(chain, extra_edges=extra)


def test_chip_smoke_phase_24_rehearses_on_cpu(chip_smoke, capsys):
    inputs = chip_smoke.sharded_inputs(
        _loop_graph(), stride=8, tile=256, n_scans=9, pad=128, n_batch=8,
        device="cpu")
    # At an eighth of the width a shard's voxels hold too few points for
    # the full-width p2l gates (its xy lands ~1.4 cm from the single-device
    # driver's here, its |z| ~3.6 cm beyond it): the rehearsal holds both
    # to the ATE gate instead.
    runs = chip_smoke.phase_sharded("cpu", smi="(CPU rehearsal)",
                                    inputs=inputs, tile=256, voxel=0.3,
                                    p2l_gate=chip_smoke.ATE_GATE_M,
                                    p2l_z_margin=chip_smoke.ATE_GATE_M,
                                    timeout_s=400)
    assert set(chip_smoke.SHARDED_KERNELS) <= set(runs)
    # On the CPU the wrappers take the plain versions: nothing launches.
    assert not any(n for run in runs.values() for n in run.values())
    out = capsys.readouterr().out
    assert "bitwise equal to search over the whole cloud on every rank: " \
           "True" in out
    assert "no scaling figure" in out
    assert "checks passed on every rank" in out
