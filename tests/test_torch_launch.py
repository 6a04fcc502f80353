"""The port's registration launcher (``repro_torch.launch.registration``)
against the reference's (``repro.launch.registration``), on the CPU at
small sizes, both run in this process on the same command line.

``pairwise --reduced`` (1 frame, 512 samples) with the reference's ``xla``
engine, batched and per frame, and with ``distributed`` (the legacy
point-sharded engine, batched): every row's RMSE, k-d tree RMSE and
translation error within 1e-3 of the reference's row; for the batched
run, the engine, the ICP parameters and the frame pairs that reach
``register_pairs`` are the reference's, converted. The port's rows alone,
on each engine: RMSE within the paper's 0.01 m of the k-d tree baseline's
on the same pair, translation within 0.05 m of the ground truth.

``serve`` with 2 streams and 2 frames from sequence 2 (seqs 2 and 3; seq
1, the highway stream, would run the retry ladder on the CPU for tens of
seconds): the service configuration (scene, map, budgets, robust
defaults) is the reference's, converted; the submitted scans are its
bits; every frame has the reference's verdicts, and each report its
counters. Poses agree within 1e-3 while a stream's ICP iteration counts
equal the reference's. An ICP stops where its step falls under the 1e-5
epsilon, and a near-tie correspondence can move that step across it:
seq 3's frame 1 stops at 15 iterations in the port's plain search and at
14 in the reference's (the port's own plain "torch" and "cuda" searches
split the same way), and the two runs then lie 3.9e-3 m apart. From such
a frame on, the stream is held to the paper's 0.01 m band.

The ``distributed`` engine's per-frame loop meets the k-d tree's bands.
"""
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

import repro.launch.registration as jlaunch
import repro.serve.registration_service as jservice
import repro_torch.launch.registration as tlaunch
import repro_torch.serve.registration_service as tservice
from repro_torch.core.icp import params_from_reference
from repro_torch.launch.registration import ENGINE_ALIASES, main
from repro_torch.serve import service_config_from_reference

PAIRWISE = ["--mode", "pairwise", "--reduced", "--frames", "1",
            "--samples", "512", "--device", "cpu"]
REF_PAIRWISE = PAIRWISE[:-2] + ["--engine", "xla"]
SERVE = ["--mode", "serve", "--streams", "2", "--frames", "2", "--seq", "2"]
TOL = 1e-3
BAND = 0.01  # the paper's accuracy band (§IV-A)
VERDICTS = ("recovery_tier", "health", "accepted", "quarantined",
            "degenerate")


class _EngineSpy:
    """Passes ``register_pairs`` through and keeps its pairs and params."""

    def __init__(self, engine, seen):
        self._engine, self._seen = engine, seen

    def register_pairs(self, pairs, params, *a, **kw):
        self._seen.update(pairs=[(np.asarray(s), np.asarray(d))
                                 for s, d in pairs], params=params)
        return self._engine.register_pairs(pairs, params, *a, **kw)


def _spy_engine(monkeypatch, launcher):
    seen, get_engine = {}, launcher.get_engine

    def spy(name, **kw):
        seen["engine"] = name
        return _EngineSpy(get_engine(name, **kw), seen)
    monkeypatch.setattr(launcher, "get_engine", spy)
    return seen


def _spy_service(monkeypatch, module):
    """Keeps the service's configuration, its submitted scans and every
    round's outputs."""
    seen = dict(submitted=[], rounds=[])

    class Spy(module.RegistrationService):
        def __init__(self, config, *a, **kw):
            seen["config"] = config
            super().__init__(config, *a, **kw)

        def submit(self, stream_id, scan, valid=None):
            seen["submitted"].append((stream_id, np.asarray(scan), valid))
            return super().submit(stream_id, scan, valid)

        def step(self):
            out = super().step()
            seen["rounds"].append({sid: (np.asarray(p), d)
                                   for sid, (p, d) in out.items()})
            return out
    monkeypatch.setattr(module, "RegistrationService", Spy)
    return seen


@pytest.mark.parametrize("extra", [[], ["--per-frame"],
                                   ["--engine", "pallas"]])
def test_pairwise_rows_match_the_kdtree(extra):
    rows = main(PAIRWISE + extra)
    assert len(rows) == 1
    frame, rmse, kdtree_rmse, t_ours, t_base, t_err = rows[0]
    assert frame == 0 and np.isfinite(rmse) and t_ours > 0 and t_base > 0
    assert abs(rmse - kdtree_rmse) <= 0.01
    assert t_err <= 0.05


@pytest.mark.parametrize("extra", [[], ["--per-frame"],
                                   ["--engine", "distributed"]],
                         ids=["batched", "per_frame", "distributed"])
def test_pairwise_matches_the_reference(extra, monkeypatch):
    jseen = _spy_engine(monkeypatch, jlaunch)
    tseen = _spy_engine(monkeypatch, tlaunch)
    jrows = jlaunch.main(REF_PAIRWISE + extra)
    trows = main(REF_PAIRWISE + extra + ["--device", "cpu"])
    assert len(trows) == len(jrows) == 1
    for t, j in zip(trows, jrows):
        assert t[0] == j[0]
        for k in (1, 2, 5):  # RMSE, k-d tree RMSE, translation error
            assert abs(t[k] - j[k]) <= TOL, (k, t[k], j[k])
    if "--per-frame" in extra:
        assert not jseen and not tseen  # FppsICP builds its own engine
        return
    engine = extra[-1] if extra else "xla"
    assert jseen["engine"] == engine
    assert tseen["engine"] == ENGINE_ALIASES.get(engine, engine)
    assert tseen["params"] == params_from_reference(jseen["params"]._asdict())
    assert len(tseen["pairs"]) == len(jseen["pairs"])
    for a, b in zip(tseen["pairs"], jseen["pairs"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_serve_reports_every_stream(monkeypatch):
    jseen = _spy_service(monkeypatch, jservice)
    tseen = _spy_service(monkeypatch, tservice)
    jreports = jlaunch.main(SERVE)
    reports = main(SERVE + ["--device", "cpu"])
    assert tseen["config"] == service_config_from_reference(
        jseen["config"]._asdict())
    assert len(tseen["submitted"]) == len(jseen["submitted"]) == 6
    for (tsid, tscan, tvalid), (jsid, jscan, jvalid) in zip(
            tseen["submitted"], jseen["submitted"]):
        assert tsid == jsid and tvalid is None and jvalid is None
        assert np.array_equal(tscan, jscan)
    assert [r.stream_id for r in reports] == ["veh0", "veh1"]
    assert len(tseen["rounds"]) == len(jseen["rounds"]) == 3
    for r, j in zip(reports, jreports):
        assert r.stream_id == j.stream_id
        assert r.frames_submitted == r.frames_processed == 3
        assert r.frames_dropped == 0
        assert sum(r.health_counts.values()) == 3
        assert np.all(np.isfinite(r.final_pose))
        for field in ("frames_submitted", "frames_processed",
                      "frames_dropped", "frames_quarantined",
                      "cascade_escapes", "health_counts"):
            assert getattr(r, field) == getattr(j, field), (r.stream_id,
                                                            field)
        diverged = False
        for f, (tround, jround) in enumerate(zip(tseen["rounds"],
                                                 jseen["rounds"])):
            (tp, td), (jp, jd) = tround[r.stream_id], jround[r.stream_id]
            for field in VERDICTS:
                assert getattr(td, field) == getattr(jd, field), (
                    r.stream_id, f, field)
            diverged |= td.iterations != jd.iterations
            tol = BAND if diverged else TOL
            assert np.abs(tp - jp).max() <= tol, (r.stream_id, f)
        assert np.abs(r.final_pose - np.asarray(j.final_pose)).max() <= tol


def test_distributed_engine_is_a_later_slice():
    """Named when the engine raised; it is ported now: the per-frame
    Table-I loop on the ``distributed`` engine (each pair a batch of one)
    meets the k-d tree's bands."""
    rows = main(PAIRWISE + ["--engine", "distributed", "--per-frame"])
    assert len(rows) == 1
    _, rmse, kdtree_rmse, _, _, t_err = rows[0]
    assert abs(rmse - kdtree_rmse) <= 0.01 and t_err <= 0.05
