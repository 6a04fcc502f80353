"""Driver of the multi-stream registration service:
``RegistrationService.submit`` / ``step`` of the program, in a closed
loop of vehicles that replay recorded drives.

Set-up draws the mix's pool of drives from the seed (scans on the device,
handed over as host arrays), builds the service with the configuration's
settings and admits one vehicle a slot (:class:`generate.FleetPlan`), then
runs the mix's warm-up rounds. A round: every live vehicle submits its
next scan, then one ``step()``; then every vehicle at the end of its drive
is closed and the next one admitted to its slot. The window runs rounds
until its time is up; a round that ends after the window's end does not
count. ``fleet_frames_per_s`` is the poses the counted rounds returned
over the time from the window's start to the end of the last of them;
``frame_latency_p95_ms`` the 95th percentile over those frames of the time
from the frame's ``submit`` to the return of the ``step`` that emitted its
pose.

``correct``: once the window has closed and the service is freed, the
reference (:mod:`perfbench.reference.odometry`) replays a sample of the
vehicles, drawn from the seed, frame by frame from their scans and the
poses the program emitted, and every pose of theirs is compared with the
reference's. A traced run replays every vehicle's map besides, for the
NN search's valid work.
"""
from __future__ import annotations

import time

import numpy as np
from perfbench import harness
from perfbench.reference import icp as ref_icp
from perfbench.reference import odometry as ref_odo
from perfbench.traffic import generate, scenes

SPLIT = "fleet"


def _sid(v) -> str:
    return f"v{v.vid}"


def service_config(cfg: dict):
    from repro_torch.core.icp import ICPParams
    from repro_torch.core.odometry import OdometryConfig
    from repro_torch.data.submap import SubmapParams
    from repro_torch.serve.registration_service import ServiceConfig
    odo = dict(cfg["odometry"], recovery=cfg["recovery"])
    odo["params"] = ICPParams(**odo["params"])
    sub = dict(odo["submap"])
    sub["dims"] = tuple(sub["dims"])
    odo["submap"] = SubmapParams(**sub)
    return ServiceConfig(**cfg["service"], odometry=OdometryConfig(**odo))


def reference_settings(cfg: dict) -> ref_odo.Odometry:
    odo = cfg["odometry"]
    p, sub = odo["params"], odo["submap"]
    return ref_odo.Odometry(
        scan_voxel=odo["scan_voxel"], scan_budget=odo["scan_budget"],
        map_voxel=sub["voxel_size"], map_capacity=sub["capacity"],
        map_dims=tuple(sub["dims"]), evict_radius=sub["evict_radius"],
        max_iterations=p["max_iterations"],
        gate=p["max_correspondence_distance"],
        epsilon=p["transformation_epsilon"], huber=p["robust_scale"],
        min_inlier_frac=odo["min_inlier_frac"],
        velocity_decay=odo["velocity_decay"])


class Round:
    """One round's record: its frames, the program's answers and clocks."""

    def __init__(self, items):
        self.items = items          # [(Vehicle, frame)]
        self.submitted: dict = {}   # sid -> host clock at submit
        self.out: dict = {}         # sid -> (pose, FrameDiagnostics)
        self.end = 0.0
        self.steps = 0


def run(ctx) -> dict:
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.serve.registration_service import RegistrationService

    cfg, mix = ctx.config, ctx.mix
    svc = RegistrationService(service_config(cfg), device=ctx.device)
    svc.engine.setup()
    slots = svc.config.slots
    pool = generate.drives(mix, scenes.scene_from_config(cfg["scene"]),
                           ctx.seed, ctx.device)
    plan = generate.FleetPlan(mix, slots)
    for v in plan.live:
        svc.admit(_sid(v))
    rounds: list[Round] = []

    def one_round() -> Round:
        r = Round(plan.round())
        with ctx.tracer.span("submit"):
            for v, f in r.items:
                r.submitted[_sid(v)] = time.perf_counter()
                svc.submit(_sid(v), pool[v.drive].scans[f])
        launches = nn_search_kernel.launches
        with ctx.tracer.span("step"):
            r.out = svc.step()
        r.end = time.perf_counter()
        r.steps = nn_search_kernel.launches - launches
        with ctx.tracer.span("retire"):
            for old, new in plan.retire_finished():
                svc.close(_sid(old))
                svc.admit(_sid(new))
        rounds.append(r)
        return r

    for _ in range(int(mix["warmup_rounds"])):
        one_round()
    setup_s = ctx.end_setup()
    first = len(rounds)
    with ctx.tracer:
        t0 = time.perf_counter()
        t_close = t0 + ctx.seconds
        while one_round().end <= t_close:
            pass
    counted = rounds[first:-1]
    if not counted:
        raise RuntimeError("no round completed inside the window")
    latency, returned, attempted, failed = [], 0, 0, 0
    for r in counted:
        for v, _ in r.items:
            sid = _sid(v)
            attempted += 1
            got = r.out.get(sid)
            if got is None or not np.isfinite(got[0]).all():
                failed += 1
                continue
            returned += 1
            latency.append((r.end - r.submitted[sid]) * 1e3)
    metrics = {"fleet_frames_per_s": returned / (counted[-1].end - t0),
               "frame_latency_p95_ms": float(np.percentile(latency, 95)),
               "setup_s": setup_s}

    traced = rounds[first:]
    counters = {"split": SPLIT,
                "loop_steps": sum(r.steps for r in traced),
                "lane_iterations": 0, "lane_steps": 0}
    for r in traced:
        its = [d.iterations for (v, f) in r.items
               for _, d in [r.out[_sid(v)]] if f != v.first]
        counters["lane_iterations"] += int(sum(its))
        counters["lane_steps"] += len(its) * (max(its) if its else 0)
    ctx.read_memory_peak()
    del svc
    ctx.free()
    trace_on = ctx.tracer.enabled
    checks, control, frames, details = _check(ctx, rounds, first, pool,
                                              replay_all=trace_on)
    if trace_on:
        counters["nn_work"] = _nn_work(traced, frames)
    trace = ctx.finish_window(counters)
    return dict(metrics=metrics, attempted=attempted, failed=failed,
                checks=checks, control=control, trace=trace,
                details=details)


def _nn_work(traced, frames) -> list:
    """(query-target pairs, queries, targets) of every NN launch of the
    traced rounds, from the reference's downsampled scans and maps: a
    round's registering lanes, once per loop step."""
    work = []
    for r in traced:
        lanes = [frames[(_sid(v), f)] for v, f in r.items if f != v.first]
        q = [x.n_scan for x in lanes]
        t = [x.n_map for x in lanes]
        work += [(int(np.dot(q, t)), int(sum(q)), int(sum(t)))] * r.steps
    return work


def _check(ctx, rounds, first: int, pool, replay_all: bool):
    """Replay a sample of the vehicles that drove in the window's counted
    rounds (``rounds[first:-1]``), and every vehicle's map with
    ``replay_all``, and compare the sample's poses with the reference's."""
    chk = ctx.config["check"]
    seen = sorted({v for r in rounds[first:-1] for v, _ in r.items},
                  key=lambda v: v.vid)
    rng = np.random.default_rng(scenes.mix(ctx.seed, "check"))
    pick = rng.choice(len(seen), min(chk["sample_vehicles"], len(seen)),
                      replace=False)
    check = {_sid(seen[i]) for i in pick}
    odo = reference_settings(ctx.config)
    streams: dict = {}
    frames: dict = {}
    got, want, low, info = [], [], [], []
    for r in rounds:
        items = [(_sid(v), pool[v.drive].scans[f], r.out[_sid(v)][0],
                  r.out[_sid(v)][1].accepted) for v, f in r.items
                 if replay_all or _sid(v) in check]
        if not items:
            continue
        made = ref_odo.step(streams, items, odo, ctx.device, check=check,
                            control=ctx.control)
        for (v, f) in r.items:
            sid = _sid(v)
            if sid not in made:
                continue
            frames[(sid, f)] = made[sid]
            if sid in check and made[sid].expected is not None:
                got.append(r.out[sid][0])
                want.append(made[sid].expected)
                d = r.out[sid][1]
                info.append((made[sid], f == v.first, d, (sid, f)))
                if ctx.control:
                    low.append(made[sid].control)
    want, got = np.stack(want), np.stack(got)
    boot = np.array([i[1] for i in info])
    ref = [i[0] for i in info]
    said = np.array([i[2].accepted for i in info])
    details = {"t_err": ref_icp.pose_errors(got, want)[0],
               "restep": [m.restep for m in ref],
               "accepted": said.tolist(),
               "iterations": [i[2].iterations for i in info],
               "inlier_frac": [i[2].inlier_frac for i in info],
               "ref_ok": [m.ok for m in ref],
               "ref_converged": [m.converged for m in ref],
               "ref_inlier_frac": [m.inlier_frac for m in ref],
               "boot": boot.tolist(),
               "frame": [i[3] for i in info]}
    step = np.array(details["restep"])
    ref_ok = np.array([m.ok[0] for m in ref])
    # the step is taken where the reference's own registration converged
    # and accepted the frame; a stream's first frame has no registration:
    # its pose has to be the identity, exactly (any other pose reads a
    # whole unit of the measure)
    judged = np.array(details["ref_converged"]) & ref_ok & ~boot
    bad_boot = np.where(boot & (details["t_err"] != 0), 1.0, 0.0)
    # accept decisions, away from the threshold's near-ties
    clear = (np.abs(np.array(details["ref_inlier_frac"]) - odo.min_inlier_frac)
             > chk["accept_tie_band"]) & ~boot
    control = None
    if low:
        low = np.stack(low)
        details["control_t_err"] = ref_icp.pose_errors(low, want)[0]
        low_ok = np.array([m.ok[1] for m in ref])
        control = _numbers(ctx, details["control_t_err"],
                           np.where(judged & low_ok, step[:, 1], 0.0),
                           clear & (low_ok != ref_ok))
    return (_numbers(ctx, details["t_err"],
                     np.maximum(np.where(judged & said, step[:, 0], 0.0),
                                bad_boot),
                     clear & (said != ref_ok)),
            control, frames, details)


def _numbers(ctx, t_err, step, mismatch) -> list:
    """The upper quartile of the poses' translation errors (m); the
    largest step the reference takes from a pose of a frame that its own
    registration converged on and accepted, in the stop rule's measure
    (``||R - I||_F² + ||t||²``); the poses farther than ``gross_t_m`` from
    the reference's; and the frames whose acceptance differs from the
    reference's, away from the inlier threshold's near-ties."""
    chk = ctx.config["check"]
    lim = chk["limits"]
    return [harness.Check("pose_t_err_p75_m",
                          float(np.percentile(t_err, 75)),
                          lim["pose_t_err_p75_m"]),
            harness.Check("pose_restep_max", float(np.max(step)),
                          lim["pose_restep_max"]),
            harness.Check("pose_gross_count",
                          int(np.sum(t_err > chk["gross_t_m"])),
                          lim["pose_gross_count"]),
            harness.Check("pose_accept_mismatch", int(np.sum(mismatch)),
                          lim["pose_accept_mismatch"])]
