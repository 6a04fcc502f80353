"""The rest of a run, on the CPU at a tiny size, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cell can have (one card: no exchange between chips to leave out), and
true with nothing broken."""
import importlib

import _tiny
import numpy as np
import pytest
import torch
from perfbench import run


def _run(cell):
    cfg, mix = _tiny.pairs() if cell.startswith("pairs") else _tiny.fleet()
    out = run.run_cell(cell, 20260101, 3.0, False, device="cpu",
                       config=cfg, mix=mix)
    return all(c.ok for c in out["checks"]) and out["failed"] == 0, out


def _state_unchanged(monkeypatch):
    icp_module = importlib.import_module("repro_torch.core.icp")
    monkeypatch.setattr(icp_module, "_icp_iteration",
                        lambda source, state, *a, **k: state)


def _half_batch(monkeypatch):
    """The engine registers only the first half of its lanes; the rest
    come back at their warm start."""
    from repro_torch.core import engine
    from repro_torch.core.icp import ICPResult
    real = engine.KernelEngine._register_batch

    def half(self, src, dst, params, T0, sv, dv):
        res = real(self, src, dst, params, T0, sv, dv)
        keep = src.shape[0] // 2
        T = res.T.clone()
        T[keep:] = T0[keep:] if T0 is not None else torch.eye(4)
        return ICPResult(T, *res[1:])

    monkeypatch.setattr(engine.KernelEngine, "_register_batch", half)
    monkeypatch.setattr(engine.SlotEngine, "_register_batch", half)


def _answer_altered(monkeypatch, cell):
    """One answer moved by 0.1 m where it is produced."""
    if cell.startswith("pairs"):
        from repro_torch.core import engine
        real = engine.RegistrationEngine.register_pairs

        def altered(self, *a, **k):
            res, batch = real(self, *a, **k)
            res.T[0, 0, 3] += 0.1
            return res, batch

        monkeypatch.setattr(engine.RegistrationEngine, "register_pairs",
                            altered)
    else:
        from repro_torch.serve import registration_service as rs
        real = rs.RegistrationService.step

        def altered(self):
            out = real(self)
            for sid, (pose, diag) in sorted(out.items())[:1]:
                if diag.frame > 0:
                    pose = np.array(pose)
                    pose[0, 3] += 0.1
                    out[sid] = (pose, diag)
            return out

        monkeypatch.setattr(rs.RegistrationService, "step", altered)


def _flags_wrong(monkeypatch, cell):
    """The answers' own flags steer clear of the step check: a pair moved
    by 0.03 m that says it did not converge; every frame of the fleet
    rejected (its pose the motion model's prediction)."""
    if cell.startswith("pairs"):
        from repro_torch.core import engine
        real = engine.RegistrationEngine.register_pairs

        def flagged(self, *a, **k):
            res, batch = real(self, *a, **k)
            res.T[0, 0, 3] += 0.03
            res.converged[0] = False
            return res, batch

        monkeypatch.setattr(engine.RegistrationEngine, "register_pairs",
                            flagged)
    else:
        from repro_torch.serve import registration_service as rs
        real = rs.RegistrationService.stream_config

        def rejecting(self):
            return real.fget(self)._replace(min_inlier_frac=1.01)

        monkeypatch.setattr(rs.RegistrationService, "stream_config",
                            property(rejecting))


CELLS = ["pairs-hdl64-b128", "fleet64-replay"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, out = _run(cell)
    assert ok, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "flags_wrong"])
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    elif fault == "flags_wrong":
        _flags_wrong(monkeypatch, cell)
    else:
        _answer_altered(monkeypatch, cell)
    ok, out = _run(cell)
    assert not ok, out["checks"]
