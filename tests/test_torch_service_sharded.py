"""Port vs reference: the registration service's sharded mode
(``ServiceConfig(devices=D)``), on the CPU.

The reference's own small configuration (``tests/test_service.py``; its
scene, ``scan_budget=256``, map capacity 1024, ``recovery=False``, 1024-row
staging). The port's D > 1 fleets run over repeated CPU devices
(``device=["cpu"] * D``), the reference's in-process fleet over its one CPU
device (D=1).

  * The sharded service at D=1 against the reference's sharded service at
    D=1 on a 3-stream, 5-frame fleet: poses within 1e-3, and per frame the
    same tier, health, accepted, quarantined, iterations and degenerate
    flag. One round from the reference's fleet state (each stream's lane
    of its ``(S, ...)`` map leaves, poses, velocity and counters carried
    into the port's D=2 fleet): the same verdicts, poses within 1e-3.
  * The contract, bit for bit (poses and diagnostics): D=2 over ``["cpu",
    "cpu"]`` against standalone ``OdometryPipeline(svc.stream_config)``
    replays and against a D=1 fleet of the same lanes per device, fp32 and
    fp16 storage, and with the recovery cascade on (``crop`` faults on
    stream 0, the fallback tier: the tiers read the map through the lane
    view); D=1 with L lanes against the single-device service at
    ``slots=L``.
  * Host logic: least-loaded admission (ties to the lower device), a
    pending stream rebinding to a freed lane on its block, ``close``
    resetting a lane in place (its successor replays bit-identically
    against a fresh pipeline), churn that never changes a batch shape, the
    lane view's ``insert`` refused, and the configuration errors.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core  # noqa: F401  (repro.core before repro.data.normals)
from repro.core import ICPParams as JICPParams
from repro.core.odometry import OdometryConfig as JOdometryConfig
from repro.data.corruption import apply_faults
from repro.data.pointcloud import SceneConfig, sequence_scans
from repro.data.submap import SubmapParams as JSubmapParams
from repro.serve.registration_service import (
    RegistrationService as JRegistrationService)
from repro.serve.registration_service import ServiceConfig as JServiceConfig
from repro_torch.core.odometry import OdometryPipeline
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
JCFG = JServiceConfig(slots=SLOTS, scan_capacity=1024, odometry=JODO,
                      devices=1)
CFG = service_config_from_reference(JCFG._asdict())
ODO = CFG.odometry
POSE_TOL = 1e-3
FIELDS = ("recovery_tier", "health", "accepted", "quarantined", "iterations",
          "degenerate")


def _service(devices=2, slots=SLOTS, **over):
    cfg = CFG._replace(slots=slots, devices=devices, **over)
    return RegistrationService(cfg, device=["cpu"] * devices)


def _fleet(n_streams, frames, base_seq=0):
    return {f"veh{s}": sequence_scans(base_seq + s, frames, SCENE)
            for s in range(n_streams)}


def _drive(svc, fleet, admit=True):
    """Admit the streams (in order), submit their frames wave by wave;
    returns {sid: [(pose, diag), ...]}. A frame is a scan or (scan,
    valid)."""
    if admit:
        for sid in fleet:
            svc.admit(sid)
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


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(pa, pb) and repr(tuple(da)) == repr(tuple(db))
        for (pa, da), (pb, db) in zip(a, b))


def _assert_replays_bitwise(svc, fleet, out):
    for sid, frames in fleet.items():
        ref = OdometryPipeline(svc.stream_config, device="cpu")
        replay = [ref.process(*svc.stage_scan(*(fr if isinstance(fr, tuple)
                                                 else (fr,))))
                  for fr in frames]
        assert _same(out[sid], replay), sid


# -- against the reference's sharded service ---------------------------------

def test_sharded_service_matches_reference_sharded_service():
    fleet = _fleet(3, 5)
    jout = _drive(JRegistrationService(JCFG), fleet)
    svc = RegistrationService(CFG, device="cpu")
    tout = _drive(svc, fleet)
    assert CFG.devices == 1 and svc.service_report()["devices"] == 1
    for sid in fleet:
        assert len(tout[sid]) == len(jout[sid]) == 5
        for (tp, td), (jp, jd) in zip(tout[sid], jout[sid]):
            assert np.abs(tp - np.asarray(jp)).max() <= POSE_TOL, sid
            for field in FIELDS:
                assert getattr(td, field) == getattr(jd, field), (
                    sid, td.frame, field)
            assert td.map_occupancy == jd.map_occupancy


def test_one_round_from_the_reference_fleet_state():
    """The reference's sharded fleet state after three rounds, each
    stream's lane of its (S, ...) leaves carried into its lane of the
    port's two-block fleet (with the pipeline's poses, velocity and the
    lane view's counters); the fourth round on the reference's staged
    frames gives its verdicts, poses within 1e-3."""
    fleet = _fleet(3, 4)
    jsvc = JRegistrationService(JCFG)
    tsvc = _service()
    for sid in fleet:
        jsvc.admit(sid)
        tsvc.admit(sid)
    _drive(jsvc, {sid: scans[:3] for sid, scans in fleet.items()},
           admit=False)
    leaves = [np.asarray(x) for x in jsvc._fleet]
    for sid in fleet:
        js, ts = jsvc._streams[sid], tsvc._streams[sid]
        block, k = divmod(ts.slot, tsvc._lanes)
        lane = submap_state_from_reference([x[js.slot] for x in leaves],
                                           ODO.submap, device="cpu")
        for leaf, value in zip(tsvc._fleet[block], lane):
            leaf[k] = value
        jview, tview = js.pipe.submap, ts.pipe.submap
        tview.frames_inserted = jview.frames_inserted
        tview.dropped_cells = jview.dropped_cells
        tview._occupied = jview._occupied
        jp, tp = js.pipe, ts.pipe
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


# -- the contract, bit for bit ---------------------------------------------------

@pytest.mark.parametrize("storage", ["fp32", "fp16"])
def test_two_blocks_match_standalone_and_one_block(storage):
    odo = ODO._replace(submap=ODO.submap._replace(storage=storage))
    fleet = _fleet(3, 5)
    svc = _service(odometry=odo)
    out = _drive(svc, fleet)
    assert svc.service_report()["devices"] == 2
    assert svc.stream_config.engine == "sharded-slots"
    assert dict(svc.stream_config.engine_kwargs) == dict(
        lanes_per_device=2, devices=("cpu", "cpu"))
    _assert_replays_bitwise(svc, fleet, out)
    # the same streams through a one-block fleet of the same width
    one = _service(devices=1, slots=2, odometry=odo)
    pair = {sid: fleet[sid] for sid in ("veh0", "veh2")}
    out1 = _drive(one, pair)
    for sid in pair:
        assert _same(out1[sid], out[sid]), sid


def test_one_block_matches_single_device_service():
    fleet = _fleet(3, 5)
    single = RegistrationService(CFG._replace(devices=None), device="cpu")
    sharded = RegistrationService(CFG, device="cpu")
    out_s, out_1 = _drive(single, fleet), _drive(sharded, fleet)
    for sid in fleet:
        assert _same(out_1[sid], out_s[sid]), sid


def test_recovery_cascade_reads_the_lane_view_bitwise():
    fleet = _fleet(3, 5)
    fleet["veh0"] = [apply_faults(sc, "crop:0.15", seed=0, frame=f)
                     if f in (2, 3) else (sc, None)
                     for f, sc in enumerate(fleet["veh0"])]
    svc = _service(odometry=ODO._replace(recovery=True,
                                         recovery_tiers=("fallback",)))
    out = _drive(svc, fleet)
    assert [d.recovery_tier for _, d in out["veh0"]] == [0, 0, 1, 2, 1]
    assert svc.service_report()["cascade_escapes"] >= 2
    _assert_replays_bitwise(svc, fleet, out)


# -- host logic ----------------------------------------------------------------------

def _least_loaded_admission():
    svc = _service()
    for sid in ("a", "b", "c", "d"):
        assert svc.admit(sid)
    assert [svc._streams[s].slot for s in "abcd"] == [0, 2, 1, 3]
    assert svc.admit("e") is False                # full: queued
    svc.close("c")                                # frees lane 1, block 0
    assert svc._streams["e"].slot == 1
    assert svc._streams["e"].pipe.device == torch.device("cpu")
    svc.close("b")
    svc.close("d")                                # block 1 now empty
    assert svc.admit("f") and svc._streams["f"].slot == 2


def _close_resets_lane():
    svc = _service()
    fleet = _fleet(SLOTS, 3)
    _drive(svc, fleet)
    freed = svc._streams["veh0"].slot
    assert bool(svc._streams["veh0"].pipe.submap.valid.any())
    svc.close("veh0")
    block, k = divmod(freed, svc._lanes)
    assert not bool(svc._fleet[block][1][k].any())  # idle valid mask
    svc.admit("fresh")
    assert svc._streams["fresh"].slot == freed
    scans = {"fresh": sequence_scans(11, 3, SCENE)}
    _assert_replays_bitwise(svc, scans, _drive(svc, scans, admit=False))


def _churn_keeps_batch_shapes():
    svc = _service(max_queue=1)
    fleet = _fleet(2, 2)
    _drive(svc, fleet)
    assert svc.service_report()["batch_shapes"] == 1
    svc.admit("joiner")
    scans = sequence_scans(5, 4, SCENE)
    for f in range(4):
        svc.submit("joiner", scans[f])
        svc.submit("joiner", scans[f])            # overflow: a drop
        svc.step()
    svc.close("veh0")
    svc.step()                                    # a round with a free lane
    assert svc.frames_dropped > 0
    assert svc.service_report()["batch_shapes"] == 1


def _lane_view_refuses_insert():
    svc = _service()
    svc.admit("veh0")
    view = svc._streams["veh0"].pipe.submap
    with pytest.raises(RuntimeError, match="never inserted"):
        view.insert(np.zeros((4, 3), np.float32), np.zeros(3))
    svc.admit("a")
    svc.admit("b")
    svc.admit("c")
    assert svc.admit("pending") is False
    with pytest.raises(RuntimeError, match="no slot"):
        svc._streams["pending"].pipe.submap.target()


def _config_errors():
    with pytest.raises(ValueError, match="divide evenly"):
        RegistrationService(CFG._replace(slots=3, devices=2),
                            device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices given"):
        RegistrationService(CFG._replace(devices=2), device=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs ServiceConfig.devices"):
        RegistrationService(CFG._replace(devices=None), device=["cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        RegistrationService(CFG._replace(devices=0), device="cpu")
    svc = RegistrationService(CFG._replace(devices=2), device="cpu")
    assert svc.service_report()["devices"] == 2
    assert dict(svc.stream_config.engine_kwargs)["devices"] == 2


HOST_CASES = {
    "least_loaded_admission": _least_loaded_admission,
    "close_resets_lane": _close_resets_lane,
    "churn_keeps_batch_shapes": _churn_keeps_batch_shapes,
    "lane_view_refuses_insert": _lane_view_refuses_insert,
    "config_errors": _config_errors,
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_sharded_service_host_logic(case):
    HOST_CASES[case]()


def test_sharded_service_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        RegistrationService(CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="has 1 CUDA"):
        RegistrationService(CFG._replace(devices=2))
