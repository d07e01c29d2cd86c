"""chip_smoke.py's SLAM-slice phases (14-17) rehearsed at a tiny size on the
CPU, where every wrapper takes its kernel's plain version: the phases'
shapes, control flow and gates (the launch gates are the card's) run
without a card.  The brute-force checks of phase 14 are real ones here.
"""

import pytest


@pytest.fixture(scope="module")
def chip_smoke():
    import chip_smoke as mod

    return mod


def test_chip_smoke_sweep_phase_rehearses_on_cpu(chip_smoke, capsys):
    recs = chip_smoke.phase_nn_sweeps("cpu", stride=48, small=256, n_wide=2,
                                      q_tile=128, db_tile=128)
    assert [(r["name"], r["path"]) for r in recs] == [
        ("nn_pruned", "slam3d"), ("nn_sweep", "slam3d-small"),
        ("nn_matched", "slam3d-small"), ("nn_sweep", "slam2d-wide"),
        ("nn_matched", "slam2d-wide")]
    for rec in recs:
        assert rec["max_abs_err"] == 0.0  # the same code on the CPU
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    out = capsys.readouterr().out
    assert out.count("bitwise equal to plain and brute force") == 12


def test_chip_smoke_slam_phases_rehearse_on_cpu(chip_smoke, capsys):
    run = chip_smoke.phase_slam3d("cpu", n_frames=9, stride=48,
                                  plain_frames=9, voxel=0.8)
    assert run["closures"] >= 1 and run["ate"] < chip_smoke.ATE_GATE_M
    chip_smoke.phase_slam3d_small("cpu", n_poses=20, n_points=768,
                                  scene_n=2000)
    # Wide scans of 4,680 points on 1,536-point tiles: above PAIRS_MAX_DB
    # and over 3 tiles, so the warm searches take kernel 8's route.
    run = chip_smoke.phase_slam2d("cpu", n_scans=22, wide_frames=3,
                                  wide_stride=6, tile=1536)
    assert [(r["name"], r["path"]) for r in run["records"]] == [
        ("nn_pairs", "slam2d-wide")]
    assert run["records"][0]["extra"]["calls"] >= 2
    out = capsys.readouterr().out
    assert "slam3d plain path" in out and "slam2d wide scans" in out
    assert "nn_pairs slam2d-wide (D 2, P 2)" in out
