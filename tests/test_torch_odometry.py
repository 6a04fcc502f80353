"""Port vs reference: streaming scan-to-map odometry.

Scripted: the reference's own cascade scenarios (``tests/test_odometry.py``)
run with the same scripted engine results fed to ``repro.core.odometry``
and ``repro_torch.core.odometry``. Tier engines are keyed by each side's
names: the port's fallback tier is the ``"cuda"`` engine where the
reference's is ``"xla"``. Required per frame: identical recovery tier,
health, accepted, quarantined and pose-jump, and identical pose and
velocity bits (scripted poses are numpy), plus equal engine call counts.

Real: one small seeded stream (5 frames, ``scan_budget=1024``) through the
default pyramid engine on both sides, and through the port's ``"torch"``
engine against the reference's ``"xla"``; then the same stream with frame 3
dropped (``apply_faults(..., "drop")``, the empty-frame path). Per frame:
poses within 1e-3 elementwise, the same tier, health, accepted, quarantined
and iterations, ``map_occupancy`` within 2 cells of capacity, equal
``dropped_cells``.

Tiers: each retry tier once from one map (the reference's after three
frames, carried over with ``submap_state_from_reference``) and one prepared
frame: T within 1e-3 and the same iterations.

Lifecycle: the caller-owned spelling (``prepare_frame(downsampled=)``,
``complete_frame(result, lattice_frac=, defer_fuse=, defer_bootstrap=)``,
``FuseRequest``, ``amend_diagnostics``) on scripted results: the same
requests, diagnostics, pose bits and submap state on both sides.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (repro.core before repro.data.normals)
import repro.core.odometry as jod
import repro_torch.core.odometry as tod
from repro.data.collate import PAD_SENTINEL
from repro.data.corruption import apply_faults
from repro.data.pointcloud import SceneConfig, sequence_scans
from repro.data.submap import SubmapParams as JSubmapParams
from repro_torch.data.submap import submap_state_from_reference

TEST_SCENE = SceneConfig(n_ground=800, n_walls=600, n_poles=150,
                         n_clutter=150, extent=15.0, sensor_range=20.0)
TEST_SUBMAP = dict(voxel_size=0.75, capacity=4096, dims=(64, 64, 24),
                   evict_radius=20.0)
POSE_TOL = 1e-3
# One scan budget for the scripted and the real streams: every scan then has
# one shape, so the reference compiles each of its programs once.
SCAN_BUDGET = 1024

OK_RESULT = dict(rmse=0.05, inlier_frac=0.9, degenerate=False)
BAD_RESULT = dict(rmse=float("inf"), inlier_frac=0.0, degenerate=True)
SUS_RESULT = dict(rmse=0.8, inlier_frac=0.3, degenerate=False)


def _result(T=None, rmse=0.05, inlier_frac=0.9, degenerate=False):
    class R:
        pass
    r = R()
    r.T = np.eye(4, dtype=np.float32) if T is None else T
    r.rmse = rmse
    r.inlier_frac = inlier_frac
    r.degenerate = degenerate
    r.iterations = 5
    r.converged = True
    return r


class ScriptedEngine:
    """Returns the scripted results in order; repeats the last one."""

    def __init__(self, *specs):
        self.specs = list(specs)
        self.calls = 0

    def register(self, *args, **kwargs):
        spec = self.specs[min(self.calls, len(self.specs) - 1)]
        self.calls += 1
        return _result(**spec)


def _moved(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return dict(OK_RESULT, T=T)


def _scan(n=64, seed=0):
    return np.asarray(np.random.default_rng(seed).uniform(-5, 5, (n, 3)),
                      np.float32)


def _nan_scan():
    scan = _scan(seed=1)
    scan[5] = np.nan
    scan[9, 1] = np.inf
    return scan


_EMPTY = (np.full((64, 3), np.nan, np.float32), None)
_DROPPED = (np.zeros((64, 3), np.float32), np.zeros(64, bool))

# name: (primary specs, {tier kind: engine key}, engine specs by key,
#        config kwargs, frames after the bootstrap as (scan, valid))
SCENARIOS = {
    "clean_tier0": ([OK_RESULT], {}, {}, {}, [(_scan(seed=1), None)]),
    "tier1_widen": ([BAD_RESULT], {"pyramid": "w"}, {"w": [OK_RESULT]},
                    dict(recovery_tiers=("widen",)),
                    [(_scan(seed=1), None)]),
    "tier2_fallback": ([BAD_RESULT], {"fallback": "f"}, {"f": [OK_RESULT]},
                       dict(recovery_tiers=("fallback",)),
                       [(_scan(seed=1), None)]),
    "tier3_wide_basin": ([BAD_RESULT], {"pyramid": "w"}, {"w": [OK_RESULT]},
                         dict(recovery_tiers=("wide_basin",)),
                         [(_scan(seed=1), None)]),
    "first_ok_stops": ([BAD_RESULT], {"pyramid": "w", "fallback": "n"},
                       {"w": [OK_RESULT], "n": [OK_RESULT]}, {},
                       [(_scan(seed=1), None)]),
    "least_bad_suspect": ([BAD_RESULT], {"pyramid": "s", "fallback": "x"},
                          {"s": [SUS_RESULT, dict(SUS_RESULT,
                                                  inlier_frac=0.5)],
                           "x": [SUS_RESULT]}, {},
                          [(_scan(seed=1), None)]),
    "all_failed_coast": ([BAD_RESULT], {"pyramid": "b", "fallback": "b"},
                         {"b": [BAD_RESULT]}, {}, [(_scan(seed=1), None)]),
    "recovery_off": ([BAD_RESULT], {}, {}, dict(recovery=False),
                     [(_scan(seed=1), None)]),
    "sticky_counters": ([BAD_RESULT, BAD_RESULT, OK_RESULT],
                        {"pyramid": "w", "fallback": "w"},
                        {"w": [OK_RESULT]}, {},
                        [(_scan(seed=s), None) for s in (1, 2, 3)]),
    "dropout_decay": ([_moved(1.0), _moved(2.0)], {}, {}, {},
                      [(_scan(seed=1), None), (_scan(seed=2), None),
                       _EMPTY, _EMPTY, _EMPTY]),
    "dropped_frame": ([OK_RESULT], {}, {}, {},
                      [(_scan(seed=1), None), _DROPPED]),
    "nan_rows": ([OK_RESULT], {}, {}, {}, [(_nan_scan(), None)]),
    "coast_then_reacquire": ([BAD_RESULT], {"pyramid": "b", "fallback": "b"},
                             {"b": [BAD_RESULT, BAD_RESULT, BAD_RESULT,
                                    _moved(0.5)]}, {},
                             [(_scan(seed=1), None), (_scan(seed=2), None)]),
}
# The fallback tier's engine kind on each side.
_FALLBACK = {"ref": "xla", "port": "cuda"}


def _run_scripted(side, monkeypatch, name):
    primary, kinds, specs, cfg_kw, frames = SCENARIOS[name]
    engines = {key: ScriptedEngine(*s) for key, s in specs.items()}
    by_kind = {(_FALLBACK[side] if kind == "fallback" else kind):
               engines[key] for kind, key in kinds.items()}
    if side == "ref":
        mod = jod
        cfg = jod.OdometryConfig(submap=JSubmapParams(**TEST_SUBMAP),
                                 scan_budget=SCAN_BUDGET, warmup_frames=1,
                                 **cfg_kw)
        pipe = jod.OdometryPipeline(cfg)
    else:
        mod = tod
        cfg = tod.OdometryConfig(
            submap=tod.SubmapParams(**TEST_SUBMAP), scan_budget=SCAN_BUDGET,
            warmup_frames=1, **cfg_kw)
        pipe = tod.OdometryPipeline(cfg, device="cpu")
    pipe.engine = ScriptedEngine(*primary)
    monkeypatch.setattr(mod, "get_engine", lambda kind, **kw: by_kind[kind])
    out = [pipe.process(_scan(seed=100))]
    for scan, valid in frames:
        out.append(pipe.process(scan, valid=valid))
    calls = {key: e.calls for key, e in engines.items()}
    return pipe, out, calls


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_cascade_matches_reference(monkeypatch, name):
    rp, rout, rcalls = _run_scripted("ref", monkeypatch, name)
    tp, tout, tcalls = _run_scripted("port", monkeypatch, name)
    assert tcalls == rcalls
    assert tp.engine.calls == rp.engine.calls
    for (tpose, td), (rpose, rd) in zip(tout, rout):
        assert np.array_equal(tpose, rpose) and tpose.dtype == rpose.dtype
        for field in ("frame", "recovery_tier", "health", "accepted",
                      "quarantined", "pose_jump", "iterations",
                      "degenerate", "dropped_cells"):
            assert getattr(td, field) == getattr(rd, field), field
        assert td.map_occupancy == rd.map_occupancy
    assert np.array_equal(tp._velocity, rp._velocity)
    assert tp._velocity.dtype == rp._velocity.dtype
    assert (tp.recovery_count, tp.quarantined_count, tp._coast_streak) == \
        (rp.recovery_count, rp.quarantined_count, rp._coast_streak)
    assert tp.tier_counts() == rp.tier_counts()
    assert tp.health_counts() == rp.health_counts()
    assert tp.submap.frames_inserted == rp.submap.frames_inserted


def test_decay_toward_identity_bits():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.uniform(-0.5, 0.5)
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = rng.uniform(-2, 2, 3)
        for f in (0.5, 0.25):
            assert np.array_equal(tod._decay_toward_identity(T, f),
                                  jod._decay_toward_identity(T, f))


def test_config_from_reference_and_unknown_fields():
    jcfg = jod.OdometryConfig(scan_budget=16384, engine="xla")
    tcfg = tod.odometry_config_from_reference(jcfg._asdict())
    assert tcfg.engine == "torch"
    assert tuple(tcfg.params) == tuple(jcfg.params)
    assert tuple(tcfg.submap) == tuple(jcfg.submap)
    assert tuple(tcfg.thresholds) == tuple(jcfg.thresholds)
    for field in ("scan_budget", "scan_voxel", "recovery_tiers",
                  "engine_kwargs", "warmup_frames", "velocity_decay"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    nested = dict(jcfg._asdict(), params=jcfg.params._asdict(),
                  submap=jcfg.submap._asdict(),
                  thresholds=jcfg.thresholds._asdict())
    assert tod.odometry_config_from_reference(nested) == tcfg
    with pytest.raises(ValueError):
        tod.odometry_config_from_reference(dict(jcfg._asdict(), bogus=1))
    assert tod.DEFAULT_RECOVERY_TIERS == jod.DEFAULT_RECOVERY_TIERS
    assert tod._WIDEN_LEVELS == jod._WIDEN_LEVELS
    assert tod._WIDE_BASIN_LEVELS == jod._WIDE_BASIN_LEVELS


def test_pipeline_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tod.OdometryPipeline(tod.OdometryConfig())
    with pytest.raises(RuntimeError):
        tod.Submap(tod.SubmapParams())


# -- real streams ------------------------------------------------------------

STREAMS = {"pyramid": ("pyramid", "pyramid", None),
           "brute": ("xla", "torch", None),
           "pyramid_drop3": ("pyramid", "pyramid", 3)}


def _stream(drop):
    """The 5 scans as ``(points, valid)``, padded to one row count with
    invalid rows (one shape: the reference compiles its ingest once);
    frame ``drop`` loses every return."""
    scans = sequence_scans(2, 5, TEST_SCENE)
    n = max(len(s) for s in scans)
    out = []
    for f, scan in enumerate(scans):
        pts = np.full((n, 3), PAD_SENTINEL, np.float32)
        pts[:len(scan)] = scan
        valid = np.arange(n) < len(scan)
        if f == drop:
            pts, valid = apply_faults(pts, "drop", seed=0, frame=f,
                                      valid=valid)
        out.append((pts, valid))
    return out


def _run(pipe, scans):
    for pts, valid in scans:
        pipe.process(pts, valid=valid)
    return np.stack(pipe.poses), list(pipe.diagnostics)


@pytest.fixture(scope="module", params=sorted(STREAMS))
def streams(request):
    ref_engine, port_engine, drop = STREAMS[request.param]
    scans = _stream(drop)
    jcfg = jod.OdometryConfig(engine=ref_engine, scan_budget=SCAN_BUDGET,
                              submap=JSubmapParams(**TEST_SUBMAP))
    tcfg = tod.odometry_config_from_reference(jcfg._asdict())
    assert tcfg.engine == port_engine
    jp, tp = jod.OdometryPipeline(jcfg), tod.OdometryPipeline(tcfg,
                                                              device="cpu")
    jposes, jdiags = _run(jp, scans)
    tposes, tdiags = _run(tp, scans)
    return request.param, (jposes, jdiags, jp), (tposes, tdiags, tp)


def test_stream_poses_within_tolerance(streams):
    _, (jposes, _, _), (tposes, _, _) = streams
    assert np.all(np.isfinite(tposes))
    assert np.abs(tposes - jposes).max() <= POSE_TOL


def test_stream_verdicts_and_iterations_match(streams):
    name, (_, jdiags, _), (_, tdiags, _) = streams
    for td, jd in zip(tdiags, jdiags):
        for field in ("recovery_tier", "health", "accepted", "quarantined",
                      "iterations", "degenerate"):
            assert getattr(td, field) == getattr(jd, field), (td.frame,
                                                              field)
    if name == "pyramid_drop3":  # the empty-frame path, then reacquire
        assert tdiags[3].health == "failed" and tdiags[3].quarantined
        assert tdiags[3].iterations == 0 and tdiags[3].recovery_tier == 4
        assert tdiags[4].recovery_tier > 0


def test_stream_map_matches(streams):
    _, (_, jdiags, jp), (_, tdiags, tp) = streams
    cap = tp.submap.params.capacity
    for td, jd in zip(tdiags, jdiags):
        assert abs(td.map_occupancy - jd.map_occupancy) * cap <= 2
        assert td.dropped_cells == jd.dropped_cells
    assert tp.submap.frames_inserted == jp.submap.frames_inserted
    assert tp.mean_iterations() == jp.mean_iterations()
    assert tp.rejected_frames() == jp.rejected_frames()


# -- one retry tier from one map and one prepared frame -----------------------

TIER_FRAME = 3


@pytest.fixture(scope="module")
def tier_inputs():
    """The reference pipeline after frames 0-2 of the clean stream, and a
    port pipeline started on its map, poses and velocity; frame 3 prepared
    once by the reference and handed to both as the same numbers."""
    scans = _stream(None)
    jcfg = jod.OdometryConfig(scan_budget=SCAN_BUDGET,
                              submap=JSubmapParams(**TEST_SUBMAP))
    tcfg = tod.odometry_config_from_reference(jcfg._asdict())
    jp = jod.OdometryPipeline(jcfg)
    _run(jp, scans[:TIER_FRAME])
    submap = tod.Submap(tcfg.submap, device="cpu")
    submap.state = submap_state_from_reference(
        [np.asarray(x) for x in jp.submap.state], tcfg.submap, device="cpu")
    tp = tod.OdometryPipeline(tcfg, submap=submap, device="cpu")
    tp.poses = [p.copy() for p in jp.poses]
    tp._velocity = jp._velocity.copy()
    prep = jp.prepare_frame(*scans[TIER_FRAME])
    src, sv = np.asarray(prep.src), np.asarray(prep.sv)
    return jp, tp, prep, torch.tensor(src), torch.tensor(sv)


@pytest.mark.parametrize("name", tod.DEFAULT_RECOVERY_TIERS)
def test_tier_attempt_matches_reference(tier_inputs, name):
    """Each retry tier (the port's fallback is the ``"cuda"`` engine, the
    reference's ``"xla"``) on the same map, scan and warm start: T within
    1e-3 elementwise and the same iteration count."""
    jp, tp, prep, src, sv = tier_inputs
    for a, b in zip(tp.submap.target(), jp.submap.target()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jr = jp._tier_attempt(name, prep.src, prep.sv, *jp.submap.target(),
                          prep.T0)
    tr = tp._tier_attempt(name, src, sv, *tp.submap.target(), prep.T0)
    assert np.all(np.isfinite(tr.T))
    assert np.abs(np.asarray(tr.T) - np.asarray(jr.T)).max() <= POSE_TOL
    assert int(tr.iterations) == int(jr.iterations)


# -- the caller-owned lifecycle: downsampled frames, deferred fuses -----------

def _lane(seed, empty=False):
    """A downsampled scan as a batched caller would hand it over: (1024, 3)
    points, invalid rows at the sentinel, and its mask."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (SCAN_BUDGET, 3)).astype(np.float32)
    sv = rng.random(SCAN_BUDGET) < (0.0 if empty else 0.9)
    src[~sv] = PAD_SENTINEL
    return src, sv


# frame: (lane, primary result spec or None, lattice_frac). Frame 1 is a
# warmup frame (probe supplied, no cascade); frame 2's supplied probe trips
# out_of_lattice, so the cascade takes the primary and the widen tier wins;
# frame 3 is empty (coast); frame 4 reacquires (no primary); frame 5's
# probe fails the primary and every tier is SUSPECT, so the earliest of the
# equal suspects (widen) is output and quarantined.
HOOK_FRAMES = ((_lane(10), None, None),
               (_lane(11), _moved(0.3), 0.0),
               (_lane(12), _moved(0.6), 0.3),
               (_lane(13, empty=True), None, None),
               (_lane(14), None, None),
               (_lane(15), _moved(1.5), 0.7))
HOOK_TIERS = {"pyramid": [_moved(0.6), _moved(1.2), SUS_RESULT],
              "fallback": [SUS_RESULT]}


def _run_hooks(side, monkeypatch):
    """Drive ``prepare_frame(downsampled=)``, ``complete_frame(result,
    lattice_frac=, defer_fuse=True, defer_bootstrap=True)`` and
    ``amend_diagnostics`` as the service does; the caller fuses each
    ``FuseRequest`` itself (numpy transform, the same on both sides)."""
    if side == "ref":
        import jax.numpy as jnp
        mod, lane = jod, jnp.asarray
        pipe = jod.OdometryPipeline(jod.OdometryConfig(
            submap=JSubmapParams(**TEST_SUBMAP), scan_budget=SCAN_BUDGET))
    else:
        mod, lane = tod, torch.tensor
        pipe = tod.OdometryPipeline(tod.OdometryConfig(
            submap=tod.SubmapParams(**TEST_SUBMAP),
            scan_budget=SCAN_BUDGET), device="cpu")
    engines = {kind: ScriptedEngine(*s) for kind, s in HOOK_TIERS.items()}
    engines[_FALLBACK[side]] = engines.pop("fallback")
    monkeypatch.setattr(mod, "get_engine", lambda kind, **kw: engines[kind])
    out = []
    for (src, sv), spec, frac in HOOK_FRAMES:
        prep = pipe.prepare_frame(None, downsampled=(lane(src), lane(sv),
                                                     int(sv.sum())))
        result = None
        if prep.kind == mod.KIND_REGISTER and not prep.skip_primary:
            result = _result(**spec)
        pose, diag, req = pipe.complete_frame(
            prep, result, lattice_frac=frac, defer_fuse=True,
            defer_bootstrap=True)
        if req is not None:
            assert isinstance(req, mod.FuseRequest)
            pts = np.asarray(req.src) @ req.pose[:3, :3].T + req.pose[:3, 3]
            pipe.submap.insert(pts.astype(np.float32), center=req.pose[:3, 3],
                               valid=np.asarray(req.sv))
            diag = pipe.amend_diagnostics(
                prep.frame, map_occupancy=pipe.submap.occupancy())
        out.append((prep, pose, diag, req))
    return pipe, out, {k: e.calls for k, e in engines.items()}


def test_deferred_fuse_lifecycle_matches_reference(monkeypatch):
    rp, rout, rcalls = _run_hooks("ref", monkeypatch)
    tp, tout, tcalls = _run_hooks("port", monkeypatch)
    assert tcalls == {_FALLBACK["port"] if k == _FALLBACK["ref"] else k: v
                      for k, v in rcalls.items()}
    kinds = [(p.kind, p.skip_primary) for p, _, _, _ in tout]
    assert kinds == [(p.kind, p.skip_primary) for p, _, _, _ in rout]
    assert kinds == [("bootstrap", False), ("register", False),
                     ("register", False), ("empty", False),
                     ("register", True), ("register", False)]
    for (_, tpose, td, treq), (_, rpose, rd, rreq) in zip(tout, rout):
        assert np.array_equal(tpose, rpose) and tpose.dtype == rpose.dtype
        assert tuple(td) == tuple(rd), (td, rd)
        assert (treq is None) == (rreq is None)
        if treq is not None:
            assert np.array_equal(treq.pose, rreq.pose)
            assert np.array_equal(treq.src.numpy(), np.asarray(rreq.src))
            assert np.array_equal(treq.sv.numpy(), np.asarray(rreq.sv))
    # the deferred frames: bootstrap, warmup, tier-1 win, reacquire
    assert [req is not None for _, _, _, req in tout] == [
        True, True, True, False, True, False]
    assert [d.recovery_tier for _, _, d, _ in tout] == [0, 0, 1, 4, 1, 1]
    assert [d.quarantined for _, _, d, _ in tout] == [
        False, False, False, True, False, True]
    assert tp.diagnostics == [d for _, _, d, _ in tout]
    assert all(d.map_occupancy >= 0 for d in tp.diagnostics)
    assert tp.submap.frames_inserted == rp.submap.frames_inserted == 4
    assert np.array_equal(tp.submap.valid.numpy(),
                          np.asarray(rp.submap.valid))
    assert np.array_equal(tp.submap.origin.numpy(),
                          np.asarray(rp.submap.origin))
    assert np.abs(tp.submap.points.numpy()
                  - np.asarray(rp.submap.points)).max() <= 1e-6
    assert np.array_equal(tp._velocity, rp._velocity)
