"""Multi-stream registration service: N odometry streams through S fixed
slots, one batched round per frame wave (port of the single-device half of
``repro.serve.registration_service``).

The paper's headline number is a *runtime-weighted* speedup across a
workload mix (§IV), a shared-accelerator framing. This module is that layer
for the repo: a fleet of vehicles (streams) funnels scans into a fixed set
of ``slots``, and every service round runs the whole fleet's data plane as
three batched stages over a leading lane dimension (scrub + downsample, one
``SlotEngine`` fleet registration, submap fuse) however many streams are
live. The control plane (health verdicts, the recovery cascade,
accept/quarantine bookkeeping) stays on the host per stream, reusing
:class:`~repro_torch.core.odometry.OdometryPipeline` as it is, so the
service inherits every robustness behaviour of the odometry path without
forking the policy code.

Every tensor of a round has a fixed shape: ``(slots, scan_capacity, 3)``
staged scans, ``(slots, scan_budget, 3)`` downsampled sources, ``(slots,
capacity, 3)`` map targets. Idle or non-registering lanes ride along with
all-False validity masks (they freeze as degenerate after one ICP
iteration). Admitting a stream, retiring one, or dropping frames under
backpressure therefore never changes a shape. The reference proves that by
its jit trace count; the eager port counts the distinct batch shapes the
service's rounds registered (``service_report()["batch_shapes"]``),
constant after the first round.

Bit-exactness contract: a standalone ``OdometryPipeline`` built from
:attr:`RegistrationService.stream_config` and fed the same (staged) frames
produces bit-identical poses and diagnostics. Its single-frame registration
embeds into the same S-lane batch (``SlotEngine.register``); its prepare,
lattice probe and fuse are the one-lane forms of the service's batched
stages, each a function of its own lane only.

The sharded mode (``ServiceConfig.devices``) is not ported yet: it is
slice 6 (ROADMAP queue 1, item 6), and asking for it raises.

Typical use::

    svc = RegistrationService(ServiceConfig(slots=8), device="cuda")
    for vid in vehicle_ids:
        svc.admit(vid)
    while streaming:
        for vid, scan in poll_sensors():
            svc.submit(vid, scan)            # staged on the device
        for vid, (pose, diag) in svc.step().items():
            publish(vid, pose, diag)
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import get_engine
from repro_torch.core.health import host_result
from repro_torch.core.icp import ICPResult, scrub_nonfinite
from repro_torch.core.odometry import (KIND_REGISTER, FrameDiagnostics,
                                       OdometryConfig, OdometryPipeline,
                                       odometry_config_from_reference,
                                       out_of_lattice_frac)
from repro_torch.core.transform import transform_points
from repro_torch.data.collate import PAD_SENTINEL, bucket_size, pad_cloud
from repro_torch.data.submap import (SubmapParams, empty_state, fuse_state,
                                     state_views)
from repro_torch.data.voxelize import voxel_downsample
from repro_torch.device import resolve_device


def _single_device(devices) -> None:
    """Raise for the reference's sharded mode, which is not ported yet."""
    if devices is not None:
        raise NotImplementedError("the sharded service "
                                  "(ServiceConfig.devices) is not ported "
                                  "yet: slice 6 (ROADMAP queue 1, item 6)")


class _ServiceFields(NamedTuple):
    slots: int = 8
    scan_capacity: int = 4096
    max_queue: int = 4
    drop_policy: str = "oldest"
    admission: str = "queue"
    odometry: OdometryConfig = OdometryConfig()
    devices: int | None = None


class ServiceConfig(_ServiceFields):
    """Service-level configuration on top of a shared per-stream
    :class:`~repro_torch.core.odometry.OdometryConfig`; the reference's
    fields and defaults.

    ``slots`` is the fleet width of every batched stage: admitted streams
    bind to a slot, further admissions wait (``admission="queue"``) or fail
    (``"reject"``). ``scan_capacity`` is the staged raw-scan row budget
    (rounded up to a collate bucket); larger scans are rejected at
    ``submit``. ``max_queue`` bounds the per-stream staging queue; on
    overflow ``drop_policy`` evicts the ``"oldest"`` staged frame (keep the
    freshest, the odometry default) or refuses the ``"newest"``
    submission. All streams share one odometry config: one ``ICPParams``
    and one shape family for the whole fleet.

    ``devices`` is the reference's sharded mode. Only ``None`` (one device)
    is ported; anything else raises ``NotImplementedError``.
    """

    __slots__ = ()

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls, *args, **kwargs)
        _single_device(self.devices)
        return self


def service_config_from_reference(d: dict) -> ServiceConfig:
    """``ServiceConfig`` from the reference's ``ServiceConfig._asdict()``,
    with the nested ``odometry`` as its own ``_asdict()`` (nested in turn
    as :func:`~repro_torch.core.odometry.odometry_config_from_reference`
    takes it) or as a port value. Raises ``ValueError`` on a field the
    port does not know."""
    unknown = sorted(set(d) - set(ServiceConfig._fields))
    if unknown:
        raise ValueError(f"reference ServiceConfig fields unknown to the "
                         f"port: {unknown}")
    d = dict(d)
    odo = d.get("odometry")
    if odo is not None and not isinstance(odo, OdometryConfig):
        d["odometry"] = odometry_config_from_reference(
            odo if isinstance(odo, dict) else odo._asdict())
    return ServiceConfig(**d)


class StreamReport(NamedTuple):
    """Per-stream service accounting, returned by ``report``/``close``:
    submit/process/drop counters, quarantine and cascade-escape totals, the
    health-verdict histogram, and the last output pose (None before the
    first processed frame)."""

    stream_id: str
    frames_submitted: int
    frames_processed: int
    frames_dropped: int
    frames_quarantined: int
    cascade_escapes: int
    health_counts: dict
    final_pose: np.ndarray | None


class _StagedFrame(NamedTuple):
    # staged scan padded to (scan_capacity, 3) and its mask, on the
    # service's device
    pts: torch.Tensor
    valid: torch.Tensor
    seq: int


class _Stream:
    """Host-side stream record: its pipeline, staging queue, counters."""

    def __init__(self, stream_id: str):
        self.id = stream_id
        self.pipe: OdometryPipeline | None = None
        self.queue: deque[_StagedFrame] = deque()
        self.slot: int | None = None
        self.submitted = 0
        self.dropped = 0
        self.cascade_escapes = 0


# -- the round's batched stages ----------------------------------------------
# Plain functions over a leading lane dimension. The standalone pipeline runs
# the same functions on one lane (``prepare_frame``'s scrub and downsample,
# ``out_of_lattice_frac``, ``Submap.insert``), and each lane's result depends
# on that lane alone. The reference jits these stages and donates the map
# buffers to the fuse; eager PyTorch has no donation, so the fuse writes new
# state tensors and the old ones are freed when the last reference goes.

def _prepare_batch(pts_b, valid_b, voxel: float, budget: int):
    """Scrub NaN/Inf rows and voxel-downsample every staged lane. Returns
    ``(src_b, sv_b, n_valid_b)``."""
    pts_b, valid_b = scrub_nonfinite(pts_b, valid_b)
    src_b, sv_b = voxel_downsample(pts_b, voxel, max_points=budget,
                                   valid=valid_b)
    return src_b, sv_b, sv_b.sum(-1)


def _fuse_batch(state_b, src_b, sv_b, pose_b, accept_b,
                params: SubmapParams):
    """Submap fuse of every lane with a per-lane accept select over stacked
    state tuples. Non-accepted lanes keep their state bit-unchanged and
    report zero dropped cells; occupancy is that of the kept state.
    Returns ``(state_b', occupied_b, dropped_b)``."""
    world = transform_points(pose_b, src_b)
    fused, occ, dropped = fuse_state(state_b, world, sv_b, pose_b[:, :3, 3],
                                     params)
    kept = tuple(torch.where(accept_b.reshape((-1,) + (1,) * (new.dim() - 1)),
                             new, old) for new, old in zip(fused, state_b))
    occ_kept = torch.where(accept_b, occ,
                           state_views(kept, params)[1].sum(-1))
    return kept, occ_kept, torch.where(accept_b, dropped, 0)


class RegistrationService:
    """Continuous-batching front end over the odometry stack: admit streams
    into slots, stage frames, and run the whole fleet's round as one
    batched step (see the module docstring for the lifecycle).

    The service is single-threaded and deterministic: ``step()`` pops at
    most one staged frame per active stream in slot order, so identical
    submission sequences produce identical outputs, drops included. All its
    tensors live on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``; asking for CUDA without it raises).
    """

    def __init__(self, config: ServiceConfig = ServiceConfig(),
                 device="cuda"):
        _single_device(config.devices)  # _replace() skips __new__
        if config.drop_policy not in ("oldest", "newest"):
            raise ValueError(f"drop_policy must be 'oldest' or 'newest', "
                             f"got {config.drop_policy!r}")
        if config.admission not in ("queue", "reject"):
            raise ValueError(f"admission must be 'queue' or 'reject', "
                             f"got {config.admission!r}")
        self.device = dev = resolve_device(device)
        cap = bucket_size(config.scan_capacity)
        self.config = config._replace(scan_capacity=cap)
        self.engine = get_engine("slots", device=dev, slots=config.slots)
        # idle-lane fillers: a staged scan and a map, on the device
        self._idle_pts = torch.full((cap, 3), PAD_SENTINEL,
                                    dtype=torch.float32, device=dev)
        self._idle_valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self._idle_state = empty_state(self.stream_config.submap, dev)
        self._streams: dict[str, _Stream] = {}
        self._slots: list[str | None] = [None] * config.slots
        self._pending: deque[str] = deque()
        self.rounds = 0
        self.frames_processed = 0
        self.frames_dropped = 0
        self.cascade_escapes = 0
        # (params, S, N, M) of every fleet registration this service ran
        self._shapes: set = set()
        self._eye = np.eye(4, dtype=np.float32)

    @property
    def stream_config(self) -> OdometryConfig:
        """The per-stream odometry config, on the shared slot engine. A
        standalone ``OdometryPipeline(stream_config)`` on the service's
        device is the service's bit-exact single-stream reference."""
        return self.config.odometry._replace(
            engine="slots", engine_kwargs=(("slots", self.config.slots),))

    # -- admission ---------------------------------------------------------
    def _free_lane(self) -> int | None:
        """The slot a new stream binds: the first free one."""
        return next((i for i, s in enumerate(self._slots) if s is None),
                    None)

    def admit(self, stream_id: str) -> bool:
        """Admit a new stream. Returns True if a slot was bound now, False
        if the stream was queued behind a full fleet
        (``admission="queue"``); raises RuntimeError when the fleet is full
        under ``admission="reject"``. Frames may be submitted while queued:
        they stage and wait."""
        if stream_id in self._streams:
            raise ValueError(f"stream {stream_id!r} already admitted")
        stream = _Stream(stream_id)
        stream.pipe = OdometryPipeline(self.stream_config,
                                       device=self.device)
        lane = self._free_lane()
        if lane is None:
            if self.config.admission == "reject":
                raise RuntimeError(
                    f"service full: {self.config.slots} slots bound, "
                    f"admission policy is 'reject'")
            self._streams[stream_id] = stream
            self._pending.append(stream_id)
            return False
        self._streams[stream_id] = stream
        self._slots[lane] = stream_id
        stream.slot = lane
        return True

    def close(self, stream_id: str) -> StreamReport:
        """Retire a stream: free its slot (rebinding the oldest pending
        stream, if any), drop its state, and return the final
        :class:`StreamReport`. Unstepped staged frames are discarded
        (counted as dropped). A stream's map lives in its own pipeline, so
        the next stream bound to the slot starts from an empty map."""
        stream = self._streams.pop(stream_id)
        stream.dropped += len(stream.queue)
        self.frames_dropped += len(stream.queue)
        report = self._report(stream)
        if stream.slot is not None:
            self._slots[stream.slot] = None
            while self._pending:
                nxt = self._pending.popleft()
                if nxt in self._streams:
                    self._slots[stream.slot] = nxt
                    self._streams[nxt].slot = stream.slot
                    break
        else:
            # stream was still pending; drop it from the wait queue lazily
            self._pending = deque(s for s in self._pending
                                  if s != stream_id)
        return report

    # -- staging -----------------------------------------------------------
    def stage_scan(self, scan, valid=None):
        """Pad a raw (n, 3) scan to the service's ``scan_capacity`` rows
        (collate sentinel conventions); returns host ``(padded, valid)``.
        This is exactly what ``submit`` stages, exposed so a reference
        ``OdometryPipeline`` can be fed bit-identical input."""
        pts = np.asarray(scan, np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"scan must be (n, 3), got {pts.shape}")
        cap = self.config.scan_capacity
        if pts.shape[0] > cap:
            raise ValueError(f"scan of {pts.shape[0]} points exceeds "
                             f"scan_capacity={cap}")
        padded, pvalid = pad_cloud(pts, cap)
        if valid is not None:
            pvalid = pvalid.copy()
            pvalid[:pts.shape[0]] &= np.asarray(valid, bool)
        return padded, pvalid

    def submit(self, stream_id: str, scan, valid=None) -> bool:
        """Stage one sensor-frame scan for ``stream_id``: padded and copied
        to the service's device now. Returns True if the frame is queued;
        False if backpressure dropped it (``drop_policy="newest"``).
        Dropping the *oldest* staged frame still returns True: the
        submitted frame survived, an older one paid."""
        stream = self._streams[stream_id]
        padded, pvalid = self.stage_scan(scan, valid)
        staged = _StagedFrame(pts=torch.as_tensor(padded, device=self.device),
                              valid=torch.as_tensor(pvalid,
                                                    device=self.device),
                              seq=stream.submitted)
        stream.submitted += 1
        if len(stream.queue) >= self.config.max_queue:
            stream.dropped += 1
            self.frames_dropped += 1
            if self.config.drop_policy == "newest":
                return False
            stream.queue.popleft()
        stream.queue.append(staged)
        return True

    # -- the fleet round ---------------------------------------------------
    def _stack_states(self, work, S):
        """This round's stack of every lane's map state (idle lanes hold an
        empty map)."""
        return tuple(
            torch.stack([work[i][0].pipe.submap.state[k] if i in work
                         else self._idle_state[k] for i in range(S)])
            for k in range(len(self._idle_state)))

    def step(self) -> dict:
        """Run one service round: pop at most one staged frame per active
        stream (slot order), run the batched data plane (prepare, one fleet
        registration, the lattice probe, one bulk fetch), the per-stream
        completion on the host, then one batched fuse; return ``{stream_id:
        (pose, FrameDiagnostics)}`` for every frame processed this round.
        Streams with empty queues idle in mask-dead lanes."""
        odo = self.stream_config
        S = self.config.slots
        dev = self.device
        work = {}
        for lane, sid in enumerate(self._slots):
            if sid is None:
                continue
            stream = self._streams[sid]
            if stream.queue:
                work[lane] = (stream, stream.queue.popleft())
        if not work:
            return {}
        self.rounds += 1

        # 1. staged-scan stack -> batched scrub + downsample (data plane)
        pts_b = torch.stack([work[i][1].pts if i in work else self._idle_pts
                             for i in range(S)])
        valid_b = torch.stack([work[i][1].valid if i in work
                               else self._idle_valid for i in range(S)])
        src_b, sv_b, nv_b = _prepare_batch(pts_b, valid_b, odo.scan_voxel,
                                           odo.scan_budget)
        n_valid = nv_b.cpu().numpy()

        # 2. host classification: which lanes register this round
        preps = {}
        for lane, (stream, _) in work.items():
            preps[lane] = stream.pipe.prepare_frame(
                None, downsampled=(src_b[lane], sv_b[lane],
                                   int(n_valid[lane])))
        reg_lanes = [lane for lane, p in preps.items()
                     if p.kind == KIND_REGISTER and not p.skip_primary]

        res_host = lat_host = None
        if reg_lanes:
            # 3. one fleet registration through the slot engine
            active = torch.zeros((S,), dtype=torch.bool)
            active[reg_lanes] = True
            active = active.to(dev)
            idle = state_views(self._idle_state, odo.submap)
            views = [state_views(work[i][0].pipe.submap.state, odo.submap)
                     if i in work else idle for i in range(S)]
            dst_b = torch.stack([v[0] for v in views])
            dv_b = torch.stack([v[1] for v in views])
            origin_b = torch.stack([v[2] for v in views])
            T0_b = np.stack([preps[i].T0 if i in preps else self._eye
                             for i in range(S)])
            self._shapes.add((odo.params, S, src_b.shape[-2],
                              dst_b.shape[-2]))
            res = self.engine.register_batch(
                src_b, dst_b, odo.params,
                src_valid=sv_b & active[:, None],
                dst_valid=dv_b & active[:, None],
                initial_transforms=T0_b)
            # 4. batched lattice probe + ONE bulk device-to-host fetch
            lat_b = out_of_lattice_frac(res.T, src_b, sv_b, origin_b,
                                        odo.submap)
            fetched = host_result(tuple(res) + (lat_b,))
            res_host, lat_host = ICPResult(*fetched[:-1]), fetched[-1]

        # 5. host control plane: per-stream completion (cascade, accept,
        #    quarantine) with the fuse deferred into one batched call
        outputs = {}
        fuse_reqs = {}
        for lane, (stream, _) in work.items():
            prep = preps[lane]
            if lane in reg_lanes:
                lane_res = ICPResult(*(x[lane] for x in res_host))
                lat = float(lat_host[lane])
            else:
                lane_res, lat = None, None
            pose, diag, fuse_req = stream.pipe.complete_frame(
                prep, lane_res, lattice_frac=lat, defer_fuse=True)
            if prep.kind == KIND_REGISTER and diag.recovery_tier > 0:
                stream.cascade_escapes += 1
                self.cascade_escapes += 1
            if fuse_req is not None:
                fuse_reqs[lane] = fuse_req
            outputs[stream.id] = (pose, diag)
            self.frames_processed += 1

        # 6. one batched fuse over the fleet's submaps
        if fuse_reqs:
            accept = torch.zeros((S,), dtype=torch.bool)
            accept[list(fuse_reqs)] = True
            pose_np = np.stack([fuse_reqs[i].pose if i in fuse_reqs
                                else self._eye for i in range(S)])
            state_b, occ_b, drop_b = _fuse_batch(
                self._stack_states(work, S),
                torch.stack([fuse_reqs[i].src if i in fuse_reqs
                             else src_b[i] for i in range(S)]),
                torch.stack([fuse_reqs[i].sv if i in fuse_reqs
                             else sv_b[i] for i in range(S)]),
                torch.as_tensor(pose_np, device=dev), accept.to(dev),
                odo.submap)
            occ, drop = torch.stack([occ_b, drop_b.to(occ_b.dtype)]).cpu()
            mcap = int(odo.submap.capacity)
            for lane in fuse_reqs:
                stream = work[lane][0]
                sub = stream.pipe.submap
                sub.state = tuple(leaf[lane] for leaf in state_b)
                sub.frames_inserted += 1
                sub.dropped_cells += int(drop[lane])
                pose, diag = outputs[stream.id]
                diag = stream.pipe.amend_diagnostics(
                    diag.frame, map_occupancy=int(occ[lane]) / mcap,
                    dropped_cells=sub.dropped_cells)
                outputs[stream.id] = (pose, diag)
        return outputs

    def sync(self) -> None:
        """Block until every device computation the service queued (the
        fuse's writes included) has finished. Outputs returned by ``step``
        are already on the host; this exists for benchmarks that must charge
        the fuse's tail to the round that issued it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def drain(self, max_rounds: int | None = None) -> dict:
        """Step until every active stream's queue is empty (or
        ``max_rounds``); returns ``{stream_id: [(pose, diag), ...]}``
        accumulated in round order."""
        out: dict[str, list] = {}
        rounds = 0
        while any(self._streams[sid].queue for sid in self._slots
                  if sid is not None):
            if max_rounds is not None and rounds >= max_rounds:
                break
            for sid, res in self.step().items():
                out.setdefault(sid, []).append(res)
            rounds += 1
        return out

    # -- observability -----------------------------------------------------
    def _report(self, stream: _Stream) -> StreamReport:
        pipe = stream.pipe
        return StreamReport(
            stream_id=stream.id,
            frames_submitted=stream.submitted,
            frames_processed=len(pipe.diagnostics),
            frames_dropped=stream.dropped,
            frames_quarantined=pipe.quarantined_count,
            cascade_escapes=stream.cascade_escapes,
            health_counts=pipe.health_counts(),
            final_pose=pipe.poses[-1] if pipe.poses else None)

    def report(self, stream_id: str) -> StreamReport:
        """Current :class:`StreamReport` for one stream (active or
        pending), without retiring it."""
        return self._report(self._streams[stream_id])

    def service_report(self) -> dict:
        """Fleet-level counters: rounds run, frames processed/dropped,
        cascade escapes, live/pending stream counts, the device count (1:
        the sharded mode is not ported), and ``batch_shapes``, the number
        of distinct (params, S, N, M) batches this service's rounds have
        registered (other users of the shared slot engine not counted). The
        reference reports its jit trace count here; an eager engine traces
        nothing, and a constant shape count after the first round is the
        same invariant: churn never changes a shape."""
        return {
            "rounds": self.rounds,
            "frames_processed": self.frames_processed,
            "frames_dropped": self.frames_dropped,
            "cascade_escapes": self.cascade_escapes,
            "active_streams": sum(1 for s in self._slots if s is not None),
            "pending_streams": len(self._pending),
            "devices": 1,
            "batch_shapes": len(self._shapes),
        }

    def diagnostics(self, stream_id: str) -> list[FrameDiagnostics]:
        """The per-frame diagnostics history of one stream."""
        return list(self._streams[stream_id].pipe.diagnostics)
