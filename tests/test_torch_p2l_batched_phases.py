"""chip_smoke.py's phases 25-27 (batched point-to-plane ICP,
nn_method="mxu", the grid hash) rehearsed at a tiny size on the CPU, where
every wrapper takes its kernel's plain version: the phases' shapes,
control flow and gates (the launch gates are the card's) run without a
card.  Phase 25's checks of kernels 4, 8 and 9 at the 4-lane payload
against their plain versions, brute force and (kernels 8 and 9) their
schedule emulations are real ones here; (a) runs at a sixth of the width
on 1,536-point tiles, so that its dbs (4,800 points) take kernel 4's
plain version cold and kernel 8's warm, each warm call held against
kernel 4's.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_phases_25_to_27_rehearse_on_cpu(capsys):
    import chip_smoke

    runs, recs = chip_smoke.phase_p2l_batched(
        "cpu", n_frames=2, stride=6, plain_pairs=1, voxel=0.4, n_poses=3,
        n_points=768, scene_n=2000, tile=1536)
    assert [(r["name"], r["path"]) for r in recs] == [
        ("nn_matched", "batched-p2l"), ("nn_pairs", "batched-p2l"),
        ("nn_pairs", "batched-p2l-room"),
        ("nn_pairs_list", "batched-p2l-room")]
    assert recs[1]["extra"]["calls"] == runs["wide"]["outer"] - 1
    assert all(0.0 < w < 1.0 for w in recs[1]["extra"]["walk_share"])
    for rec in recs:
        assert rec["max_abs_err"] == 0.0
        assert rec["name"] == "nn_matched" or rec["extra"]["payload"] == 4
        assert rec["bound_by"] in ("bytes", "operations")
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    assert runs["wide"]["max_t_err"] < chip_smoke.ATE_GATE_M
    assert runs["room"]["outer"] >= 2
    mxu = chip_smoke.phase_mxu("cpu", n_frames=3, stride=24)
    assert mxu["ate"] < chip_smoke.ATE_GATE_M and mxu["index_share"] > 0.99
    grid = chip_smoke.phase_gridhash("cpu", stride=16, reps=1)
    assert grid["found"] > 0
    out = capsys.readouterr().out
    assert ("nn_matched batched-p2l (D 3, P 4): the cold call, 1 pairs"
            in out)
    assert "bitwise equal to plain and brute force on every pair" in out
    assert "each bitwise equal to nn_matched on its inputs" in out
    assert out.count("bitwise equal to plain, the items' emulation and "
                     "brute force") == 2
    assert "fields and results bitwise the CPU's: True" in out
