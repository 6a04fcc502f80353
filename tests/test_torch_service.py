"""Port vs reference: the slot engine and the multi-stream registration
service (single device; the sharded mode is
``tests/test_torch_service_sharded.py``).

One configuration for the whole module, the reference's own
(``tests/test_service.py``): its small scene, ``scan_budget=256``, map
capacity 1024, ``recovery=False``, four slots and a 1024-row staging
capacity. The reference's slot executable then compiles once per process,
for the (4, 256, 1024) batch that the service and every single-pair
``register`` below share.

  * ``SlotEngine``: ``register`` (the lane-0 embedding) and
    ``register_batch`` against the reference's ``get_engine("slots",
    slots=4)`` on the same pairs: T within 1e-3, the same iterations per
    lane. In the port alone: permuted lanes, lanes beside sentinel lanes,
    and a lane frozen while the others iterate keep their bits.
  * The service against the reference's service on a 3-stream, 5-frame
    fleet (once as configured, once with the recovery cascade on and
    ``crop`` faults on frames 2-3 of stream 0): poses within 1e-3
    elementwise, and per frame the same tier, health, accepted,
    quarantined, iterations and degenerate flag. The cascade runs the
    fallback tier alone, which keeps the reference's compiles within this
    file's time; ``tests/test_torch_odometry.py`` holds each tier of the
    default ladder to the reference's.
  * One round from the reference's fleet state (every stream's submap,
    poses and velocity after three rounds, carried across) on the
    reference's staged frames: the same verdicts, poses within 1e-3.
  * The service against the port's standalone pipeline on the staged
    frames, fp32 and fp16 storage: the same bits, poses and diagnostics.
  * Host logic mirrored from ``tests/test_service.py`` as cases of one
    test: admission, backpressure, retirement, degraded input, churn.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core  # noqa: F401  (repro.core before repro.data.normals)
from repro.core import ICPParams as JICPParams
from repro.core import get_engine as jget_engine
from repro.core.odometry import OdometryConfig as JOdometryConfig
from repro.data.corruption import apply_faults
from repro.data.pointcloud import SceneConfig, sequence_scans
from repro.data.submap import SubmapParams as JSubmapParams
from repro.serve.registration_service import (
    RegistrationService as JRegistrationService)
from repro.serve.registration_service import ServiceConfig as JServiceConfig
from repro_torch.core.engine import SlotEngine, get_engine
from repro_torch.core.odometry import OdometryPipeline
from repro_torch.data.collate import PAD_SENTINEL
from repro_torch.data.submap import submap_state_from_reference
from repro_torch.serve import (RegistrationService,
                               service_config_from_reference)

SCENE = SceneConfig(n_ground=300, n_walls=220, n_poles=60, n_clutter=70,
                    extent=12.0, sensor_range=16.0)
JODO = JOdometryConfig(
    params=JICPParams(max_iterations=6, max_correspondence_distance=1.0,
                      chunk=512, robust_kernel="huber", robust_scale=0.3),
    submap=JSubmapParams(voxel_size=0.75, capacity=1024, dims=(48, 48, 16),
                         evict_radius=12.0),
    scan_budget=256, recovery=False)
SLOTS = 4
JCFG = JServiceConfig(slots=SLOTS, scan_capacity=1024, odometry=JODO)
CFG = service_config_from_reference(JCFG._asdict())
ODO = CFG.odometry
POSE_TOL = 1e-3
FIELDS = ("recovery_tier", "health", "accepted", "quarantined", "iterations",
          "degenerate")
CROP = "crop:0.15"


def _service(**over):
    return RegistrationService(CFG._replace(**over), device="cpu")


def _fleet(n_streams, frames, base_seq=0):
    return {f"veh{s}": sequence_scans(base_seq + s, frames, SCENE)
            for s in range(n_streams)}


def _drive(svc, fleet):
    """Submit every stream's frames wave by wave; returns {sid: [(pose,
    diag), ...]} in frame order. A frame is a scan or a (scan, valid)."""
    out = {sid: [] for sid in fleet}
    for f in range(max(len(v) for v in fleet.values())):
        for sid, frames in fleet.items():
            if f < len(frames):
                frame = frames[f]
                svc.submit(sid, *(frame if isinstance(frame, tuple)
                                  else (frame,)))
        for sid, res in svc.step().items():
            out[sid].append(res)
    return out


def _assert_replays_bitwise(svc, staged, out):
    """Every stream against a standalone pipeline on its staged frames."""
    for sid, frames in staged.items():
        ref = OdometryPipeline(svc.stream_config, device="cpu")
        assert len(out[sid]) == len(frames)
        for f, (padded, valid) in enumerate(frames):
            pose_ref, diag_ref = ref.process(padded, valid)
            pose_svc, diag_svc = out[sid][f]
            np.testing.assert_array_equal(pose_svc, pose_ref)
            assert diag_svc == diag_ref, (sid, f)


# -- the slot engine against the reference's ---------------------------------

def _pairs():
    """Four (source, target) lanes at the service's shapes: the 256-row
    downsampled frame f+1 of stream s against its frame f padded to 1024
    rows, with masks and a warm start off by 0.2 m."""
    rng = np.random.default_rng(7)
    src = np.full((SLOTS, 256, 3), PAD_SENTINEL, np.float32)
    dst = np.full((SLOTS, 1024, 3), PAD_SENTINEL, np.float32)
    sv = np.zeros((SLOTS, 256), bool)
    dv = np.zeros((SLOTS, 1024), bool)
    for s in range(SLOTS):
        a, b = sequence_scans(s, 2, SCENE)
        a = a[rng.permutation(len(a))[:1024]]
        b = b[rng.permutation(len(b))[:256]]
        dst[s, :len(a)], dv[s, :len(a)] = a, True
        src[s, :len(b)], sv[s, :len(b)] = b, True
    T0 = np.broadcast_to(np.eye(4, dtype=np.float32), (SLOTS, 4, 4)).copy()
    T0[:, 0, 3] = 0.2
    return src, dst, sv, dv, T0


@pytest.fixture(scope="module")
def slot_runs():
    src, dst, sv, dv, T0 = _pairs()
    jeng = jget_engine("slots", slots=SLOTS)
    teng = get_engine("slots", device="cpu", slots=SLOTS)
    assert isinstance(teng, SlotEngine)
    args = (src, dst, JODO.params)
    kw = dict(src_valid=sv, dst_valid=dv, initial_transforms=T0)
    jb = jeng.register_batch(*args, **kw)
    tb = teng.register_batch(src, dst, ODO.params, **kw)
    j1 = [jeng.register(src[s], dst[s], JODO.params, T0[s],
                        src_valid=sv[s], dst_valid=dv[s])
          for s in range(SLOTS)]
    t1 = [teng.register(src[s], dst[s], ODO.params, T0[s],
                        src_valid=sv[s], dst_valid=dv[s])
          for s in range(SLOTS)]
    return (src, dst, sv, dv, T0), teng, (jb, tb), (j1, t1)


def test_slot_engine_matches_reference(slot_runs):
    _, _, (jb, tb), (j1, t1) = slot_runs
    assert np.abs(tb.T.numpy() - np.asarray(jb.T)).max() <= POSE_TOL
    assert tb.iterations.tolist() == np.asarray(jb.iterations).tolist()
    assert min(tb.iterations.tolist()) >= 2
    for j, t in zip(j1, t1):  # the lane-0 embedding
        assert np.abs(t.T.numpy() - np.asarray(j.T)).max() <= POSE_TOL
        assert int(t.iterations) == int(j.iterations)


def _lane_bits(res, lane):
    return [x[lane].numpy().tobytes() for x in res]


def test_slot_lanes_are_independent(slot_runs):
    """A lane's bits depend on that lane alone: the single-pair embedding
    (other lanes sentinel), a permuted batch, and a batch whose other lanes
    are sentinel lanes all give the batch's bits."""
    (src, dst, sv, dv, T0), teng, (_, tb), (_, t1) = slot_runs
    perm = [2, 0, 3, 1]
    tp = teng.register_batch(src[perm], dst[perm], ODO.params,
                             src_valid=sv[perm], dst_valid=dv[perm],
                             initial_transforms=T0[perm])
    for s in range(SLOTS):
        assert [x.numpy().tobytes() for x in t1[s]] == _lane_bits(tb, s)
        assert _lane_bits(tp, perm.index(s)) == _lane_bits(tb, s)
    alone = np.arange(SLOTS) == 3  # lane 3 beside three sentinel lanes
    ts = teng.register_batch(
        np.where(alone[:, None, None], src, PAD_SENTINEL),
        np.where(alone[:, None, None], dst, PAD_SENTINEL), ODO.params,
        src_valid=sv & alone[:, None], dst_valid=dv & alone[:, None],
        initial_transforms=T0)
    assert _lane_bits(ts, 3) == _lane_bits(tb, 3)
    assert ts.degenerate[:3].all() and ts.iterations[:3].tolist() == [1] * 3
    # A lane that holds a frame but does not register (all-False masks)
    # reaches the searcher as the same operands as an idle sentinel lane.
    t = torch.as_tensor
    masks = (t(sv & alone[:, None]), t(dv & alone[:, None]))
    held = teng._prepare(t(src), t(dst), ODO.params, *masks)
    idle = teng._prepare(t(np.where(alone[:, None, None], src, PAD_SENTINEL)),
                         t(np.where(alone[:, None, None], dst, PAD_SENTINEL)),
                         ODO.params, *masks)
    for a, b in zip(held[:3], idle[:3]):
        assert torch.equal(a, b)


def test_frozen_lane_keeps_its_bits(slot_runs):
    """Lane 1 registers its target onto itself from the identity: it
    converges after one step and stays frozen while the other lanes run
    on; its result is the one it gets alone."""
    (src, dst, sv, dv, T0), teng, _, _ = slot_runs
    src2, sv2, T02 = src.copy(), sv.copy(), T0.copy()
    src2[1], sv2[1], T02[1] = dst[1, :256], dv[1, :256], np.eye(4)
    res = teng.register_batch(src2, dst, ODO.params, src_valid=sv2,
                              dst_valid=dv, initial_transforms=T02)
    its = res.iterations.tolist()
    assert its[1] < min(its[0], its[2], its[3])
    one = teng.register(src2[1], dst[1], ODO.params, T02[1],
                        src_valid=sv2[1], dst_valid=dv[1])
    assert [x.numpy().tobytes() for x in one] == _lane_bits(res, 1)


# -- the service against the reference's service ----------------------------

def _faulty_fleet(n_streams, frames):
    """Stream 0 cropped on frames 2-3, the others clean."""
    fleet = _fleet(n_streams, frames)
    fleet["veh0"] = [apply_faults(sc, CROP, seed=0, frame=f) if f in (2, 3)
                     else (sc, None) for f, sc in enumerate(fleet["veh0"])]
    return fleet


@pytest.fixture(scope="module", params=["as_configured", "recovery_crop"])
def both_services(request):
    recovery = request.param == "recovery_crop"
    fleet = _faulty_fleet(3, 5) if recovery else _fleet(3, 5)
    tiers = dict(recovery=recovery, recovery_tiers=("fallback",))
    jsvc = JRegistrationService(JCFG._replace(odometry=JODO._replace(**tiers)))
    tsvc = _service(odometry=ODO._replace(**tiers))
    for svc in (jsvc, tsvc):
        for sid in fleet:
            svc.admit(sid)
    return request.param, _drive(jsvc, fleet), _drive(tsvc, fleet), tsvc


def test_service_matches_reference_service(both_services):
    name, jout, tout, tsvc = both_services
    for sid in jout:
        assert len(tout[sid]) == len(jout[sid]) == 5
        for (tp, td), (jp, jd) in zip(tout[sid], jout[sid]):
            assert np.all(np.isfinite(tp))
            assert np.abs(tp - np.asarray(jp)).max() <= POSE_TOL, (sid,
                                                                  td.frame)
            for field in FIELDS:
                assert getattr(td, field) == getattr(jd, field), (
                    sid, td.frame, field)
    report = tsvc.service_report()
    assert report["frames_processed"] == 15 and report["batch_shapes"] == 1
    if name == "recovery_crop":  # stream 0 retried, coasted, reacquired
        assert [d.recovery_tier for _, d in tout["veh0"]] == [0, 0, 1, 2, 1]


def test_one_round_from_the_reference_fleet_state():
    """Every stream's state after three reference rounds (its submap
    through ``submap_state_from_reference``, poses, velocity, counters)
    carried into the port's service; the fourth round, on the reference's
    staged frames, gives the reference's verdicts and poses within 1e-3."""
    fleet = _fleet(3, 4)
    jsvc = JRegistrationService(JCFG)
    tsvc = _service()
    for sid in fleet:
        jsvc.admit(sid)
        tsvc.admit(sid)
    _drive(jsvc, {sid: scans[:3] for sid, scans in fleet.items()})
    for sid in fleet:
        jp, tp = jsvc._streams[sid].pipe, tsvc._streams[sid].pipe
        tp.submap.state = submap_state_from_reference(
            [np.asarray(x) for x in jp.submap.state], ODO.submap,
            device="cpu")
        tp.submap.frames_inserted = jp.submap.frames_inserted
        tp.submap.dropped_cells = jp.submap.dropped_cells
        tp.poses = [np.asarray(p).copy() for p in jp.poses]
        tp.diagnostics = list(jp.diagnostics)
        tp._velocity = np.asarray(jp._velocity).copy()
        tp._coast_streak = jp._coast_streak
    for sid, scans in fleet.items():
        padded, valid = jsvc.stage_scan(scans[3])
        jsvc.submit(sid, padded, valid)
        tsvc.submit(sid, padded, valid)
    jout, tout = jsvc.step(), tsvc.step()
    assert sorted(tout) == sorted(jout) == sorted(fleet)
    for sid, (tp, td) in tout.items():
        jp, jd = jout[sid]
        assert td.frame == jd.frame == 3
        assert np.abs(tp - np.asarray(jp)).max() <= POSE_TOL
        for field in FIELDS:
            assert getattr(td, field) == getattr(jd, field), (sid, field)


# -- the service against the port's standalone pipeline ----------------------

@pytest.mark.parametrize("storage", ["fp32", "fp16"])
def test_service_matches_standalone_pipeline_bitwise(storage):
    """The contract: every stream of a fleet gives the same poses and
    diagnostics, bit for bit, as a standalone OdometryPipeline
    (stream_config) replay of its staged frames."""
    svc = _service(odometry=ODO._replace(
        submap=ODO.submap._replace(storage=storage)))
    fleet = _fleet(3, 5)
    for sid in fleet:
        svc.admit(sid)
    staged = {sid: [svc.stage_scan(sc) for sc in scans]
              for sid, scans in fleet.items()}
    _assert_replays_bitwise(svc, staged, _drive(svc, fleet))


# -- host logic (tests/test_service.py) ---------------------------------------

def _admission_queue():
    svc = _service()
    fleet = _fleet(SLOTS, 2)
    assert all(svc.admit(sid) for sid in fleet)
    _drive(svc, fleet)
    assert svc.admit("pending") is False          # fleet full: queued
    report = svc.close("veh0")
    assert report.frames_processed == 2 and report.final_pose is not None
    # the freed slot rebinds the pending stream at once
    assert svc.service_report()["active_streams"] == SLOTS
    assert svc.service_report()["pending_streams"] == 0
    out = _drive(svc, {"pending": sequence_scans(9, 2, SCENE)})
    assert len(out["pending"]) == 2
    with pytest.raises(KeyError):
        svc.report("veh0")                        # retired streams are gone


def _admission_reject():
    svc = _service(admission="reject")
    for s in range(SLOTS):
        svc.admit(f"veh{s}")
    with pytest.raises(RuntimeError, match="service full"):
        svc.admit("overflow")


def _duplicate_admit():
    svc = _service()
    svc.admit("veh0")
    with pytest.raises(ValueError, match="already admitted"):
        svc.admit("veh0")


def _drop_oldest():
    svc = _service(max_queue=2)
    svc.admit("veh0")
    scans = sequence_scans(0, 4, SCENE)
    assert all(svc.submit("veh0", sc) for sc in scans)  # the oldest pay
    report = svc.report("veh0")
    assert report.frames_submitted == 4 and report.frames_dropped == 2
    ref = OdometryPipeline(svc.stream_config, device="cpu")
    for sc in scans[2:]:                          # the two freshest survive
        ref.process(*svc.stage_scan(sc))
    out = svc.drain()
    assert len(out["veh0"]) == 2
    np.testing.assert_array_equal(out["veh0"][-1][0], ref.poses[-1])


def _drop_newest():
    svc = _service(max_queue=2, drop_policy="newest")
    svc.admit("veh0")
    results = [svc.submit("veh0", sc) for sc in sequence_scans(0, 4, SCENE)]
    assert results == [True, True, False, False]
    assert svc.report("veh0").frames_dropped == 2


def _drops_deterministic():
    reports = []
    for _ in range(2):
        svc = _service(max_queue=1)
        svc.admit("veh0")
        for sc in sequence_scans(0, 4, SCENE):
            svc.submit("veh0", sc)
            svc.submit("veh0", sc)
        svc.drain()
        reports.append(svc.report("veh0"))
    assert reports[0].frames_dropped == reports[1].frames_dropped == 7
    np.testing.assert_array_equal(reports[0].final_pose,
                                  reports[1].final_pose)


def _close_counts_unstepped():
    svc = _service()
    svc.admit("veh0")
    for sc in sequence_scans(0, 3, SCENE):
        svc.submit("veh0", sc)
    report = svc.close("veh0")
    assert report.frames_dropped == 3 and report.frames_processed == 0


def _empty_scan_coasts():
    svc = _service()
    svc.admit("veh0")
    out = _drive(svc, {"veh0": sequence_scans(0, 3, SCENE)})
    svc.submit("veh0", np.full((64, 3), np.nan, np.float32))
    pose, diag = svc.step()["veh0"]
    assert diag.quarantined and diag.iterations == 0
    assert np.all(np.isfinite(pose)) and len(out["veh0"]) == 3


def _oversized_scan_rejected():
    svc = _service()
    svc.admit("veh0")
    big = np.zeros((svc.config.scan_capacity + 1, 3), np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        svc.submit("veh0", big)


def _retired_slot_reused():
    """A stream bound to a retired stream's slot never sees its
    predecessor's map: its whole trajectory replays bit-identically
    against a fresh standalone pipeline."""
    svc = _service()
    fleet = _fleet(SLOTS, 3)
    for sid in fleet:
        svc.admit(sid)
    _drive(svc, fleet)
    freed = svc._streams["veh0"].slot
    svc.close("veh0")
    svc.admit("fresh")
    assert svc._streams["fresh"].slot == freed
    scans = sequence_scans(11, 3, SCENE)
    staged = {"fresh": [svc.stage_scan(sc) for sc in scans]}
    _assert_replays_bitwise(svc, staged, _drive(svc, {"fresh": scans}))


def _dropped_cells_surface():
    """A capacity-starved stream's saturation shows per frame in
    FrameDiagnostics.dropped_cells, as in the standalone replay."""
    svc = _service(odometry=ODO._replace(
        submap=ODO.submap._replace(capacity=64)))
    svc.admit("veh0")
    scans = sequence_scans(0, 2, SCENE)
    staged = {"veh0": [svc.stage_scan(sc) for sc in scans]}
    out = _drive(svc, {"veh0": scans})
    assert out["veh0"][0][1].dropped_cells > 0   # bootstrap already drops
    _assert_replays_bitwise(svc, staged, out)


def _churn_keeps_batch_shapes():
    """Joins, retirements, drops and empty slots never change a batch
    shape: the slot engine's shape count stays at its first round's."""
    svc = _service(max_queue=1)
    fleet = _fleet(2, 2)
    for sid in fleet:
        svc.admit(sid)
    _drive(svc, fleet)
    shapes = svc.service_report()["batch_shapes"]
    assert shapes == 1
    svc.admit("joiner")                           # joins a warm fleet
    scans = sequence_scans(5, 4, SCENE)
    for f in range(4):
        svc.submit("joiner", scans[f])
        svc.submit("joiner", scans[f])            # overflow: a drop
        svc.step()
    svc.close("veh0")
    svc.step()                                    # a round with a free slot
    assert svc.frames_dropped > 0
    assert svc.service_report()["batch_shapes"] == shapes


def _sharded_not_ported():
    """Named when the sharded mode raised; it is ported now
    (``tests/test_torch_service_sharded.py``): the reference's ``devices``
    converts and builds a sharded service, and both sharded engines
    resolve. An unknown reference field still raises."""
    cfg = service_config_from_reference(JCFG._replace(devices=2)._asdict())
    assert cfg.devices == 2
    svc = RegistrationService(cfg, device="cpu")
    assert svc.engine.name == "sharded-slots"
    assert svc.service_report()["devices"] == 2
    for name in ("sharded-slots", "distributed"):
        assert get_engine(name, device="cpu").name == name
    with pytest.raises(ValueError, match="unknown"):
        service_config_from_reference(dict(JCFG._asdict(), lanes=2))


HOST_CASES = {
    "admission_queue": _admission_queue,
    "admission_reject": _admission_reject,
    "duplicate_admit": _duplicate_admit,
    "drop_oldest": _drop_oldest,
    "drop_newest": _drop_newest,
    "drops_deterministic": _drops_deterministic,
    "close_counts_unstepped": _close_counts_unstepped,
    "empty_scan_coasts": _empty_scan_coasts,
    "oversized_scan_rejected": _oversized_scan_rejected,
    "retired_slot_reused": _retired_slot_reused,
    "dropped_cells_surface": _dropped_cells_surface,
    "churn_keeps_batch_shapes": _churn_keeps_batch_shapes,
    "sharded_not_ported": _sharded_not_ported,
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_service_host_logic(case):
    HOST_CASES[case]()


def test_no_card_no_service(monkeypatch):
    """Without CUDA the service and the slot engine raise unless the caller
    asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        RegistrationService(CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        get_engine("slots", slots=SLOTS)
    assert RegistrationService(CFG, device="cpu").device.type == "cpu"
