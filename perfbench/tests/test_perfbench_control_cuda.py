"""The control on a card: the reference computed in TF32, put in the
program's place, fails the comparison that the program passes. (At the
cells' own size it is run by ``python3 -m perfbench.calibrate``; here at a
size a test run holds.)"""
import copy

import pytest
from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pairs-hdl64-b128", "fleet64-replay"])
def test_control_fails_where_the_program_passes(card, cell):
    from perfbench.run import run_cell
    w = harness.workload(cell)
    cfg = copy.deepcopy(harness.config(w["config"]))
    mix = copy.deepcopy(harness.traffic(w["traffic"]))
    if cell.startswith("pairs"):
        mix["pool_batches"] = 1
        mix["pairs_per_profile"] = [2] * 10
        cfg["check"]["sample_pairs"] = 16
    else:
        cfg["service"]["slots"] = 8
        mix["pool_drives"] = 12
        cfg["check"]["sample_vehicles"] = 4
    out = run_cell(cell, 424242, 3.0, False, config=cfg, mix=mix,
                   control=True)
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert not all(c.ok for c in out["control"]), out["control"]
