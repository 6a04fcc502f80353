"""Multi-stream registration service: N odometry streams through S fixed
slots, one batched round per frame wave, optionally sharded over a device
mesh (port of ``repro.serve.registration_service``).

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

**Sharded mode** (``ServiceConfig.devices=D``): the round runs over a 1-D
``("streams",)`` mesh of D devices (``core.distributed``), one Python
process driving them all. Each device owns a contiguous block of ``slots /
D`` lanes and their resident submaps: the fleet's map state lives on the
devices as one ``(L, ...)`` state tuple per block (``data.submap``) instead
of per-stream objects, and prepare, registration
(``ShardedSlotEngine.register_blocks``, the blocks in lockstep), lattice
probe and fuse run block by block with no cross-device traffic. A round
makes one host-to-device copy per block of the staged scans, one bulk
fetch of the registrations and probes, and one of the fuse's occupancy.
The host control plane is unchanged: each stream's pipeline sees its lane
through a :class:`_LaneSubmap` view. Admission picks the least-loaded
block, and a retired slot's lane is reset in place, so churn never changes
a shape and never leaks a predecessor's map. The devices may repeat
(``device=["cuda:0", "cuda:0"]``): D blocks then share one card, which is
how one card runs the sharded program.

Every tensor of a round has a fixed shape: ``(slots, scan_capacity, 3)``
staged scans, ``(slots, scan_budget, 3)`` downsampled sources, ``(slots,
capacity, 3)`` map targets (in blocks of ``slots / D`` lanes when sharded).
Idle or non-registering lanes ride along with all-False validity masks
(they freeze as degenerate after one ICP iteration). Admitting a stream,
retiring one, or dropping frames under backpressure therefore never changes
a shape. The reference proves that by its jit trace count; the eager port
counts the distinct batch shapes the service's rounds registered
(``service_report()["batch_shapes"]``), constant after the first round.

Bit-exactness contract: a standalone ``OdometryPipeline`` built from
:attr:`RegistrationService.stream_config` and fed the same (staged) frames
produces bit-identical poses and diagnostics. Its single-frame registration
embeds into the same S-lane batch (``SlotEngine.register``); its prepare,
lattice probe and fuse are the one-lane forms of the service's batched
stages, each a function of its own lane only. Sharded, the contract extends
across mesh sizes at equal block width: the per-device program is fixed by
``slots / devices`` alone, so a D-block fleet gives each stream the bits of
a one-block fleet of the same width, and a one-block fleet those of the
single-device service at ``slots = slots / devices``. Across block widths
the agreement is float tolerance.

Typical use::

    svc = RegistrationService(ServiceConfig(slots=8), device="cuda")
    svc = RegistrationService(ServiceConfig(slots=16, devices=8))
    for vid in vehicle_ids:
        svc.admit(vid)
    while streaming:
        for vid, scan in poll_sensors():
            svc.submit(vid, scan)            # staged
        for vid, (pose, diag) in svc.step().items():
            publish(vid, pose, diag)
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distributed import fleet_devices
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


class ServiceConfig(NamedTuple):
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

    ``devices`` switches the service to sharded mode (module docstring): D
    device blocks of ``slots / devices`` lanes each and their resident
    submaps. ``None`` (default) is the single-device service.
    """

    slots: int = 8
    scan_capacity: int = 4096
    max_queue: int = 4
    drop_policy: str = "oldest"
    admission: str = "queue"
    odometry: OdometryConfig = OdometryConfig()
    devices: int | None = None


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
    # staged scan padded to (scan_capacity, 3) and its mask: on the
    # service's device in single-device mode, on the host in sharded mode
    # (a round then copies each block's lanes to its device at once)
    pts: object
    valid: object
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


class _LaneSubmap:
    """Submap view of one lane of the sharded fleet state.

    The host control plane (cascade tiers, lattice probes, occupancy
    diagnostics) reads a stream's map through the attributes of
    :class:`~repro_torch.data.submap.Submap`; this view resolves them
    against the service's per-block ``(L, ...)`` state at the stream's
    *current* slot. Occupancy and the sticky ``dropped_cells`` counter are
    host caches updated from each batched fuse, so control-plane reads
    cost no device fetch. Every write goes through the service's batched
    fuse: ``insert`` is a usage error here."""

    def __init__(self, svc: "RegistrationService", stream: "_Stream"):
        self._svc = svc
        self._stream = stream
        self.params: SubmapParams = svc.stream_config.submap
        self.frames_inserted = 0
        self.dropped_cells = 0
        self._occupied = 0

    @property
    def state(self) -> tuple:
        """The lane's state tuple (views into its block's state)."""
        lane = self._stream.slot
        if lane is None:
            raise RuntimeError(f"stream {self._stream.id!r} has no slot "
                               f"bound; its lane state does not exist yet")
        block, k = divmod(lane, self._svc._lanes)
        return tuple(leaf[k] for leaf in self._svc._fleet[block])

    @property
    def origin(self) -> torch.Tensor:
        return self.state[-1]

    @property
    def points(self) -> torch.Tensor:
        return state_views(self.state, self.params)[0]

    @property
    def valid(self) -> torch.Tensor:
        return state_views(self.state, self.params)[1]

    def target(self):
        pts, valid, _ = state_views(self.state, self.params)
        return pts, valid

    @property
    def size(self) -> int:
        return self._occupied

    def occupancy(self) -> float:
        return self._occupied / int(self.params.capacity)

    def insert(self, *args, **kwargs):
        raise RuntimeError("sharded service submaps are fused in the "
                           "batched fleet round, never inserted per stream")


def _fetch(blocks, home: torch.device) -> tuple:
    """Per-block tuples of tensors, concatenated field by field on ``home``
    and fetched to the host in one copy (``core.health.host_result``)."""
    return host_result(tuple(torch.cat([x.to(home) for x in leaves])
                             for leaves in zip(*blocks)))


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
    batched step (see the module docstring for the lifecycle and the
    sharded mode).

    The service is single-threaded and deterministic: ``step()`` pops at
    most one staged frame per active stream in slot order, so identical
    submission sequences produce identical outputs, drops included. Its
    tensors live on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``; asking for CUDA without it raises). Sharded, ``device`` is
    one device, whose D blocks are then the first D cards (or D blocks on
    the CPU), or an explicit list of D devices, which may repeat.
    """

    def __init__(self, config: ServiceConfig = ServiceConfig(),
                 device="cuda"):
        if config.drop_policy not in ("oldest", "newest"):
            raise ValueError(f"drop_policy must be 'oldest' or 'newest', "
                             f"got {config.drop_policy!r}")
        if config.admission not in ("queue", "reject"):
            raise ValueError(f"admission must be 'queue' or 'reject', "
                             f"got {config.admission!r}")
        cap = bucket_size(config.scan_capacity)
        self.config = config._replace(scan_capacity=cap)
        self._sharded = config.devices is not None
        explicit = isinstance(device, (list, tuple))
        sp = config.odometry.submap
        if self._sharded:
            D = int(config.devices)
            if D < 1:
                raise ValueError(f"devices must be >= 1, got {D}")
            if config.slots % D:
                raise ValueError(f"slots={config.slots} must divide evenly "
                                 f"over devices={D}")
            if explicit and len(device) != D:
                raise ValueError(f"{len(device)} devices given for "
                                 f"devices={D}")
            self._blocks = (fleet_devices(device) if explicit
                            else fleet_devices(D, device))
            # the standalone pipeline's engine key: hashable either way
            self._devices_key = (tuple(str(d) for d in self._blocks)
                                 if explicit else D)
            self._lanes = config.slots // D
            self.device = dev = self._blocks[0]
            self.engine = get_engine(
                "sharded-slots", device=dev,
                lanes_per_device=self._lanes, devices=self._devices_key)
            # each block's lanes' resident submaps, for the service's life
            self._fleet = [empty_state(sp, d, batch=(self._lanes,))
                           for d in self._blocks]
            # host-side idle-lane fillers (one copy per block a round)
            self._idle_pts = np.full((cap, 3), PAD_SENTINEL, np.float32)
            self._idle_valid = np.zeros((cap,), bool)
        else:
            if explicit:
                raise ValueError("a device list needs ServiceConfig.devices "
                                 "(the sharded mode)")
            self.device = dev = resolve_device(device)
            self._blocks = [dev]
            self._lanes = config.slots
            self.engine = get_engine("slots", device=dev, slots=config.slots)
            # idle-lane fillers: a staged scan and a map, on the device
            self._idle_pts = torch.full((cap, 3), PAD_SENTINEL,
                                        dtype=torch.float32, device=dev)
            self._idle_valid = torch.zeros((cap,), dtype=torch.bool,
                                           device=dev)
            self._idle_state = empty_state(sp, dev)
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
        """The per-stream odometry config, on the shared slot engine
        (sharded or not). A standalone ``OdometryPipeline(stream_config)``
        on the service's device is the service's bit-exact single-stream
        reference in either mode."""
        if self._sharded:
            return self.config.odometry._replace(
                engine="sharded-slots",
                engine_kwargs=(("lanes_per_device", self._lanes),
                               ("devices", self._devices_key)))
        return self.config.odometry._replace(
            engine="slots", engine_kwargs=(("slots", self.config.slots),))

    # -- admission ---------------------------------------------------------
    def _free_lane(self) -> int | None:
        """The slot a new stream binds: the first free lane of the
        least-loaded block (ties to the lower device), so live streams
        spread over the mesh; with one block, the first free slot."""
        L = self._lanes
        best = None
        for d in range(len(self._blocks)):
            block = self._slots[d * L:(d + 1) * L]
            free = next((d * L + i for i, s in enumerate(block)
                         if s is None), None)
            if free is None:
                continue
            load = sum(1 for s in block if s is not None)
            if best is None or load < best[0]:
                best = (load, free)
        return None if best is None else best[1]

    def _bind(self, stream: _Stream, lane: int) -> None:
        """Bind ``stream`` to ``lane``; its pipeline's retry tiers then run
        on the lane's block device."""
        self._slots[lane] = stream.id
        stream.slot = lane
        stream.pipe.device = self._blocks[lane // self._lanes]

    def admit(self, stream_id: str) -> bool:
        """Admit a new stream. Returns True if a slot was bound now, False
        if the stream was queued behind a full fleet
        (``admission="queue"``); raises RuntimeError when the fleet is full
        under ``admission="reject"``. Frames may be submitted while queued:
        they stage and wait."""
        if stream_id in self._streams:
            raise ValueError(f"stream {stream_id!r} already admitted")
        stream = _Stream(stream_id)
        stream.pipe = OdometryPipeline(
            self.stream_config, device=self.device,
            submap=_LaneSubmap(self, stream) if self._sharded else None)
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
        self._bind(stream, lane)
        return True

    def close(self, stream_id: str) -> StreamReport:
        """Retire a stream: free its slot (rebinding the oldest pending
        stream, if any), drop its state, and return the final
        :class:`StreamReport`. Unstepped staged frames are discarded
        (counted as dropped). A single-device stream's map lives in its own
        pipeline; in sharded mode the lane's resident map is reset to idle
        in place, on its block. Either way the next stream bound to the
        slot starts from an empty map."""
        stream = self._streams.pop(stream_id)
        stream.dropped += len(stream.queue)
        self.frames_dropped += len(stream.queue)
        report = self._report(stream)
        lane = stream.slot
        if lane is not None:
            if self._sharded:
                block, k = divmod(lane, self._lanes)
                idle = empty_state(self.stream_config.submap,
                                   self._blocks[block])
                for leaf, idle_leaf in zip(self._fleet[block], idle):
                    leaf[k] = idle_leaf
            self._slots[lane] = None
            while self._pending:
                nxt = self._pending.popleft()
                if nxt in self._streams:
                    self._bind(self._streams[nxt], lane)
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
        """Stage one sensor-frame scan for ``stream_id``: padded, and copied
        to the service's device now (single-device mode) or kept on the
        host until the round copies each block's lanes to its device at
        once (sharded mode). Returns True if the frame is queued; False if
        backpressure dropped it (``drop_policy="newest"``). Dropping the
        *oldest* staged frame still returns True: the submitted frame
        survived, an older one paid."""
        stream = self._streams[stream_id]
        padded, pvalid = self.stage_scan(scan, valid)
        if self._sharded:
            staged = _StagedFrame(pts=padded, valid=pvalid,
                                  seq=stream.submitted)
        else:
            staged = _StagedFrame(
                pts=torch.as_tensor(padded, device=self.device),
                valid=torch.as_tensor(pvalid, device=self.device),
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
        Streams with empty queues idle in mask-dead lanes. In sharded mode
        each data-plane stage runs block by block, each block on its
        device; the structure is the same."""
        odo = self.stream_config
        S, L = self.config.slots, self._lanes
        sharded = self._sharded
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

        # 1. staged-scan stack -> batched scrub + downsample (data plane),
        #    one (L, ...) block a device
        if sharded:
            place = self.engine.place
            pts_blk = place(np.stack([work[i][1].pts if i in work
                                      else self._idle_pts for i in range(S)]))
            valid_blk = place(np.stack([work[i][1].valid if i in work
                                        else self._idle_valid
                                        for i in range(S)]))
        else:
            pts_blk = [torch.stack([work[i][1].pts if i in work
                                    else self._idle_pts for i in range(S)])]
            valid_blk = [torch.stack([work[i][1].valid if i in work
                                      else self._idle_valid
                                      for i in range(S)])]
        prepared = [_prepare_batch(p, v, odo.scan_voxel, odo.scan_budget)
                    for p, v in zip(pts_blk, valid_blk)]
        src_blk = [p[0] for p in prepared]
        sv_blk = [p[1] for p in prepared]
        n_valid = _fetch([(p[2],) for p in prepared], self.device)[0]

        # 2. host classification: which lanes register this round
        preps = {}
        for lane, (stream, _) in work.items():
            block, k = divmod(lane, L)
            preps[lane] = stream.pipe.prepare_frame(
                None, downsampled=(src_blk[block][k], sv_blk[block][k],
                                   int(n_valid[lane])))
        reg_lanes = [lane for lane, p in preps.items()
                     if p.kind == KIND_REGISTER and not p.skip_primary]

        res_host = lat_host = None
        if reg_lanes:
            # 3. one fleet registration through the slot engine
            active = np.zeros((S,), bool)
            active[reg_lanes] = True
            T0_np = np.stack([preps[i].T0 if i in preps else self._eye
                              for i in range(S)])
            if sharded:
                views = [state_views(state, odo.submap)
                         for state in self._fleet]
                act_blk = place(active)
                T0_blk = place(T0_np)
            else:
                idle = state_views(self._idle_state, odo.submap)
                lanes = [state_views(work[i][0].pipe.submap.state,
                                     odo.submap) if i in work else idle
                         for i in range(S)]
                views = [tuple(torch.stack([v[j] for v in lanes])
                               for j in range(3))]
                act_blk = [torch.as_tensor(active, device=self.device)]
            self._shapes.add((odo.params, S, src_blk[0].shape[-2],
                              views[0][0].shape[-2]))
            if sharded:
                res_blk = self.engine.register_blocks(
                    src_blk, [v[0] for v in views], odo.params,
                    initial_transforms=T0_blk,
                    src_valid=[sv & a[:, None]
                               for sv, a in zip(sv_blk, act_blk)],
                    dst_valid=[v[1] & a[:, None]
                               for v, a in zip(views, act_blk)])
            else:
                res_blk = [self.engine.register_batch(
                    src_blk[0], views[0][0], odo.params,
                    src_valid=sv_blk[0] & act_blk[0][:, None],
                    dst_valid=views[0][1] & act_blk[0][:, None],
                    initial_transforms=T0_np)]
            # 4. batched lattice probe + ONE bulk device-to-host fetch
            lat_blk = [out_of_lattice_frac(res.T, src, sv, v[2], odo.submap)
                       for res, src, sv, v in zip(res_blk, src_blk, sv_blk,
                                                  views)]
            fetched = _fetch([tuple(res) + (lat,)
                              for res, lat in zip(res_blk, lat_blk)],
                             self.device)
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
                prep, lane_res, lattice_frac=lat, defer_fuse=True,
                defer_bootstrap=sharded)
            if prep.kind == KIND_REGISTER and diag.recovery_tier > 0:
                stream.cascade_escapes += 1
                self.cascade_escapes += 1
            if fuse_req is not None:
                fuse_reqs[lane] = fuse_req
            outputs[stream.id] = (pose, diag)
            self.frames_processed += 1

        # 6. one batched fuse over the fleet's submaps
        if fuse_reqs:
            accept = np.zeros((S,), bool)
            accept[list(fuse_reqs)] = True
            pose_np = np.stack([fuse_reqs[i].pose if i in fuse_reqs
                                else self._eye for i in range(S)])
            if sharded:
                # the fuse sources are this round's prepared blocks (every
                # FuseRequest.src is its lane's slice of them)
                fused = [_fuse_batch(state, src, sv, pose, acc, odo.submap)
                         for state, src, sv, pose, acc in zip(
                             self._fleet, src_blk, sv_blk, place(pose_np),
                             place(accept))]
                self._fleet = [f[0] for f in fused]
                occ, drop = _fetch([f[1:] for f in fused], self.device)
            else:
                state_b, occ_b, drop_b = _fuse_batch(
                    self._stack_states(work, S),
                    torch.stack([fuse_reqs[i].src if i in fuse_reqs
                                 else src_blk[0][i] for i in range(S)]),
                    torch.stack([fuse_reqs[i].sv if i in fuse_reqs
                                 else sv_blk[0][i] for i in range(S)]),
                    torch.as_tensor(pose_np, device=self.device),
                    torch.as_tensor(accept, device=self.device), odo.submap)
                occ, drop = _fetch([(occ_b, drop_b)], self.device)
            mcap = int(odo.submap.capacity)
            for lane in fuse_reqs:
                stream = work[lane][0]
                sub = stream.pipe.submap
                if sharded:
                    sub._occupied = int(occ[lane])
                else:
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
        fuse's writes included) has finished, on every block's device.
        Outputs returned by ``step`` are already on the host; this exists
        for benchmarks that must charge the fuse's tail to the round that
        issued it."""
        for dev in dict.fromkeys(self._blocks):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

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
        cascade escapes, live/pending stream counts, the number of device
        blocks the fleet is sharded over (1: single-device mode), and
        ``batch_shapes``, the number
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
            "devices": len(self._blocks),
            "batch_shapes": len(self._shapes),
        }

    def diagnostics(self, stream_id: str) -> list[FrameDiagnostics]:
        """The per-frame diagnostics history of one stream."""
        return list(self._streams[stream_id].pipe.diagnostics)
