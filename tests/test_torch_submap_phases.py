"""chip_smoke.py's phases 18-20 (kernels 12 and 13, the scan-to-submap
path at full width and on the small 2D wall world) rehearsed at a tiny
size on the CPU, where every wrapper takes its kernel's plain version: the
phases' shapes, control flow and gates (the launch gates are the card's)
run without a card.
"""

import pytest


@pytest.fixture(scope="module")
def chip_smoke():
    import chip_smoke as mod

    return mod


def test_chip_smoke_gn_stats_phase_rehearses_on_cpu(chip_smoke, capsys):
    recs = chip_smoke.phase_gn_stats("cpu", stride=48, n_scans=8)
    assert [(r["name"], r["path"]) for r in recs] == [
        ("gn_stats", "gn_stats"), ("gn_stats_batched", "gn_stats_batched")]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0  # the same code on the CPU
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
        assert rec["launches"] == 0  # no kernel on the CPU
    out = capsys.readouterr().out
    assert out.count("ok equal True") == 3


def test_chip_smoke_submap_phases_rehearse_on_cpu(chip_smoke, capsys):
    run = chip_smoke.phase_submap(
        "cpu", n_frames=5, stride=48, plain_frames=3, tile=512,
        kw=dict(voxel_size=0.2, capacity=1 << 13, view_rows=1 << 12))
    assert run["ate"] < chip_smoke.ATE_GATE_M and run["outer_total"] > 0
    two = chip_smoke.phase_submap_2d("cpu")  # full size: 8 x 400 points
    assert set(two) == {"fused", "re-voxelize"}
    out = capsys.readouterr().out
    assert "bitwise equal to the first run" in out
    assert "submap plain path" in out and "submap 2D re-voxelize" in out
