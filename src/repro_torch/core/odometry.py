"""Streaming scan-to-map odometry on the engine layer (port of
``repro.core.odometry``).

Each incoming scan registers against the rolling local submap
(``data.submap``) instead of the previous scan, so per-frame error does not
compound into a random walk:

  * **constant-velocity warm start**: the motion model predicts each
    frame's pose (``T_pred = T_k @ v``, ``v = T_{k-1}^{-1} T_k`` after each
    accepted frame) and feeds it through ``initial_transform``. On a
    rejected frame the velocity decays toward identity (``velocity_decay``
    per frame), so a dropout burst does not coast at full speed forever.
  * **health-gated recovery cascade**: every registration is distilled
    into a :class:`~repro_torch.core.health.RegistrationHealth` verdict. A
    non-OK frame walks a bounded retry ladder:

      tier 1 ``widen``      same map, doubled gate, coarser pyramid
      tier 2 ``fallback``   the brute-force engine, warm start discarded
      tier 3 ``wide_basin`` very coarse-to-fine schedule, 4x gate, from
                            the last accepted pose
      tier 4 (implicit)     coast on the decayed motion model and
                            quarantine the frame (the scan is not fused)

    The first OK tier wins; otherwise the least-bad SUSPECT attempt (fewest
    tripped signals, then smallest jump from the prediction) is output but
    quarantined; an all-FAILED ladder coasts.
  * **sensor-boundary scrubbing**: NaN/Inf rows leave the scan before the
    voxel downsample can see them.

Everything runs on the pipeline's device (``device="cuda"`` unless the
caller passes ``"cpu"``; asking for CUDA without it raises): the submap,
the scans, and every engine of the cascade. The pyramid engines' polish is
the grid candidate-sweep kernel (or the fused moment kernel with
``params.fused``), their coarse levels the brute-force NN kernel.

One deliberate difference from the reference: its ``fallback`` tier runs
``get_engine("xla")``, the plain dense brute force. The port's plain
counterpart is the ``"torch"`` engine, which would run the plain search on
the card, so the port's fallback is ``get_engine("cuda")``
(``KernelEngine``): the brute-force NN kernel on CUDA tensors and its plain
version on CPU tensors, the same function. Registration results are
fetched to the host in one copy each (``core.health.host_result``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import get_engine
from repro_torch.core.health import (FAILED, OK, SUSPECT, HealthThresholds,
                                     RegistrationHealth, assess_registration,
                                     health_thresholds_from_reference,
                                     host_result, normal_equation_condition)
from repro_torch.core.icp import (ICPParams, params_from_reference,
                                  scrub_nonfinite)
from repro_torch.core.transform import transform_points
from repro_torch.data.submap import (Submap, SubmapParams,
                                     submap_params_from_reference)
from repro_torch.data.voxelize import voxel_downsample
from repro_torch.device import resolve_device

# Retry-tier pyramid schedules: ((voxel_m, iters, max_points), ...).
_WIDEN_LEVELS = ((8.0, 8, 4096), (4.0, 6, 8192))
_WIDE_BASIN_LEVELS = ((16.0, 8, 2048), (8.0, 8, 4096), (4.0, 6, 8192))

DEFAULT_RECOVERY_TIERS = ("widen", "fallback", "wide_basin")


class OdometryConfig(NamedTuple):
    """Pipeline configuration; same fields and defaults as the reference.

    Size ``scan_budget`` above the scan's occupied-voxel count:
    ``voxel_downsample`` drops overflow cells from the cell-order tail (the
    +x end of the scene first), a spatially biased truncation. Same for
    ``submap.capacity`` against the eviction ball. With ``recovery=True``
    the health thresholds decide accept/reject; with it off the pipeline
    keeps the degenerate/``min_inlier_frac`` guard.
    """

    engine: str = "pyramid"
    engine_kwargs: tuple = (("levels", ()),)
    params: ICPParams = ICPParams(max_iterations=30,
                                  max_correspondence_distance=1.0,
                                  transformation_epsilon=1e-5,
                                  robust_kernel="huber", robust_scale=0.3)
    submap: SubmapParams = SubmapParams(voxel_size=0.75, capacity=24576,
                                        dims=(128, 128, 32),
                                        evict_radius=40.0)
    scan_voxel: float = 0.75
    scan_budget: int = 8192
    motion_model: bool = True
    min_inlier_frac: float = 0.2
    recovery: bool = True
    recovery_tiers: tuple = DEFAULT_RECOVERY_TIERS
    thresholds: HealthThresholds = HealthThresholds()
    velocity_decay: float = 0.5
    # Frames below this index are health-labelled but never retried.
    warmup_frames: int = 2
    # Per-frame scan-observability probe: knn normals of the downsampled
    # scan -> conditioning of its 6x6 plane normal matrix.
    observability_probe: bool = True


def odometry_config_from_reference(d: dict) -> OdometryConfig:
    """``OdometryConfig`` from the reference's ``OdometryConfig._asdict()``,
    with the nested ``params``, ``submap`` and ``thresholds`` given as
    their own ``_asdict()`` dicts (or as port values).

    The reference's engine names map to the port's: ``"xla"`` to
    ``"torch"``, ``"pallas"`` to ``"cuda"``. Raises ``ValueError`` on a
    field the port does not know.
    """
    unknown = sorted(set(d) - set(OdometryConfig._fields))
    if unknown:
        raise ValueError(f"reference OdometryConfig fields unknown to the "
                         f"port: {unknown}")
    d = dict(d)
    nested = (("params", ICPParams, params_from_reference),
              ("submap", SubmapParams, submap_params_from_reference),
              ("thresholds", HealthThresholds,
               health_thresholds_from_reference))
    for key, cls, convert in nested:
        if key in d and not isinstance(d[key], cls):
            value = d[key]
            d[key] = convert(value if isinstance(value, dict)
                             else value._asdict())
    if "engine" in d:
        d["engine"] = {"xla": "torch", "pallas": "cuda"}.get(d["engine"],
                                                            d["engine"])
    return OdometryConfig(**d)


class FrameDiagnostics(NamedTuple):
    frame: int
    iterations: int
    inlier_frac: float
    rmse: float
    degenerate: bool
    accepted: bool          # False: pose fell back to the motion model
    map_occupancy: float    # submap capacity in use after this frame
    health: str = OK        # RegistrationHealth verdict for this frame
    recovery_tier: int = 0  # 0 primary; 1..N retry tier; N+1 coasted
    pose_jump: float = 0.0  # metres vs. the motion-model prediction
    quarantined: bool = False   # scan withheld from the map
    dropped_cells: int = 0  # sticky submap-saturation counter


# Frame classification out of prepare_frame.
KIND_BOOTSTRAP = "bootstrap"
KIND_EMPTY = "empty"
KIND_REGISTER = "register"


class PreparedFrame(NamedTuple):
    """Device-side half of one frame (:meth:`OdometryPipeline.prepare_frame`):
    the scrubbed, voxel-downsampled scan and its mask on the pipeline's
    device, plus the host-side classification and warm start."""

    frame: int
    kind: str               # KIND_BOOTSTRAP | KIND_EMPTY | KIND_REGISTER
    src: torch.Tensor       # (scan_budget, 3) downsampled sensor-frame scan
    sv: torch.Tensor        # (scan_budget,) validity mask
    T0: np.ndarray          # warm-start prediction (identity off-register)
    reacquire: bool = False     # first frame after a coast streak
    skip_primary: bool = False  # reacquire + tiers: ladder only, no primary


class FuseRequest(NamedTuple):
    """Deferred map-fusion work order (``complete_frame(defer_fuse=True)``):
    the accepted frame's downsampled scan (sensor frame), mask and pose."""

    src: torch.Tensor
    sv: torch.Tensor
    pose: np.ndarray


def _scan_plane_system(src: torch.Tensor, sv: torch.Tensor,
                       nparams) -> torch.Tensor:
    """6x6 plane normal matrix of the scan against its own estimated
    normals (the observability probe's device half), as one matmul."""
    # Imported here: data.normals imports the core package.
    from repro_torch.data.normals import estimate_normals
    normals, nvalid = estimate_normals(src, nparams, valid=sv)
    w = (sv & nvalid).to(torch.float32)
    a = torch.cat([torch.linalg.cross(src, normals), normals], dim=-1)
    return (a * w[..., None]).mT @ a


def _decay_toward_identity(T: np.ndarray, factor: float) -> np.ndarray:
    """Shrink a rigid motion: translation scaled by ``factor``, rotation
    angle scaled by ``factor`` about the same axis (Rodrigues)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    angle = float(np.arccos(cos))
    out = np.eye(4)
    if angle > 1e-8:
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
        axis /= max(np.linalg.norm(axis), 1e-12)
        K = np.array([[0.0, -axis[2], axis[1]],
                      [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        a = angle * factor
        out[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    out[:3, 3] = factor * T[:3, 3]
    return out.astype(np.float32)


class OdometryPipeline:
    """Stateful scan-to-map odometry: feed sensor-frame scans in order,
    read back poses (sensor -> frame-0/map) and per-frame diagnostics.

        pipe = OdometryPipeline(OdometryConfig(), device="cuda")
        for scan in scans:                       # (N_k, 3) numpy, any N_k
            pose, diag = pipe.process(scan)

    The submap, the scans and every engine live on ``device``. Retry tiers
    are named ``get_engine`` instances, shared per process.
    """

    def __init__(self, config: OdometryConfig = OdometryConfig(),
                 submap: Submap | None = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        kwargs = dict(config.engine_kwargs)
        if config.engine != "pyramid":
            # the default engine_kwargs select the pyramid's polish-only
            # schedule; they don't apply to other engine constructors
            kwargs.pop("levels", None)
        self.engine = get_engine(config.engine, device=self.device, **kwargs)
        self.submap = (Submap(config.submap, device=self.device)
                       if submap is None else submap)
        self.poses: list[np.ndarray] = []
        self.diagnostics: list[FrameDiagnostics] = []
        # inter-frame velocity v = T_{k-1}^{-1} T_k, decayed on rejection
        self._velocity = np.eye(4, dtype=np.float32)
        self._coast_streak = 0       # consecutive frames without a pose fix
        self.recovery_count = 0      # sticky: frames that left tier 0
        self.quarantined_count = 0   # sticky: frames withheld from the map

    # -- motion model ------------------------------------------------------
    def _predict(self) -> np.ndarray:
        """Constant-velocity pose prediction for the incoming frame."""
        if len(self.poses) < 2 or not self.config.motion_model:
            return self.poses[-1]
        return (self.poses[-1] @ self._velocity).astype(np.float32)

    # -- health ------------------------------------------------------------
    def _out_of_lattice_frac(self, res, src, sv) -> float:
        """Fraction of the (pose-transformed) scan outside the submap
        lattice: the low-overlap/teleport signal. A bounds check against
        the rolling lattice; no grid build."""
        p = self.submap.params
        dev = src.device
        T = torch.as_tensor(res.T, dtype=torch.float32, device=dev)
        pts = transform_points(T, src)
        v = torch.tensor(p.voxel_size, dtype=torch.float32, device=dev)
        c = torch.floor((pts - self.submap.origin) / v)
        dims = torch.tensor(p.dims, dtype=torch.float32, device=dev)
        inb = ((c >= 0) & (c < dims)).all(-1)
        n_valid = sv.sum().clamp_min(1)
        return float((sv & ~inb).sum() / n_valid)

    def _assess(self, res, T0, src, sv, condition: float | None = None,
                trust_prediction: bool = True,
                out_of_lattice: float | None = None) -> RegistrationHealth:
        # The jump signal needs a real prediction (>= 2 poses, motion model
        # on); reacquire mode drops it, since after a coast the prediction
        # is what is no longer trusted. ``out_of_lattice`` lets a batched
        # caller supply the probe.
        predicted = (T0 if trust_prediction and self.config.motion_model
                     and len(self.poses) >= 2 else None)
        if out_of_lattice is None:
            out_of_lattice = self._out_of_lattice_frac(res, src, sv)
        return assess_registration(
            res, predicted=predicted, thresholds=self.config.thresholds,
            out_of_lattice=out_of_lattice, condition=condition)

    def _scan_condition(self, src, sv) -> float | None:
        """Observability of the scan itself (pose-independent, once per
        frame): conditioning of its 6x6 plane system."""
        if not self.config.observability_probe:
            return None
        from repro_torch.data.normals import NormalParams
        A = _scan_plane_system(src, sv, NormalParams())
        return normal_equation_condition(
            A.cpu().numpy().astype(np.float64))

    # -- recovery tiers ----------------------------------------------------
    def _tier_attempt(self, name: str, src, sv, map_pts, map_valid, T0):
        """Run one named retry tier; returns its ICPResult on the host."""
        cfg = self.config
        dev = self.device
        if name == "widen":
            engine = get_engine("pyramid", device=dev, levels=_WIDEN_LEVELS)
            params = cfg.params._replace(
                max_correspondence_distance=(
                    2.0 * cfg.params.max_correspondence_distance),
                robust_scale=2.0 * cfg.params.robust_scale)
            init = T0                      # keep the warm start
        elif name == "fallback":
            engine = get_engine("cuda", device=dev)
            params = cfg.params
            init = self.poses[-1]          # warm start discarded
        elif name == "wide_basin":
            engine = get_engine("pyramid", device=dev,
                                levels=_WIDE_BASIN_LEVELS)
            params = cfg.params._replace(
                max_correspondence_distance=(
                    4.0 * cfg.params.max_correspondence_distance),
                robust_scale=2.0 * cfg.params.robust_scale)
            init = self.poses[-1]          # relocalize from last good pose
        else:
            raise ValueError(f"unknown recovery tier {name!r}; "
                             f"known: {DEFAULT_RECOVERY_TIERS}")
        return host_result(engine.register(
            src, map_pts, params, initial_transform=init, src_valid=sv,
            dst_valid=map_valid))

    def _cascade(self, src, sv, map_pts, map_valid, T0,
                 condition: float | None = None, reacquire: bool = False,
                 primary=None, out_of_lattice: float | None = None):
        """Primary attempt + bounded retry ladder. Returns
        ``(result_or_None, health, tier)``: a ``None`` result means coast.

        ``reacquire=True`` (the frame after a coast) skips the primary: the
        prediction's uncertainty has outgrown the narrow gate, so the
        ladder starts at the coarse-first schedules. ``primary`` (with its
        ``out_of_lattice`` probe) is a tier-0 result computed by the caller.
        """
        cfg = self.config
        attempts = []
        if not (reacquire and cfg.recovery_tiers):
            res = primary
            if res is None:
                res = self.engine.register(src, map_pts, cfg.params,
                                           initial_transform=T0,
                                           src_valid=sv, dst_valid=map_valid)
            res = host_result(res)
            health = self._assess(res, T0, src, sv, condition,
                                  out_of_lattice=out_of_lattice)
            if health.ok or not cfg.recovery:
                return res, health, 0
            attempts.append((0, res, health))
        for tier, name in enumerate(cfg.recovery_tiers, start=1):
            r = self._tier_attempt(name, src, sv, map_pts, map_valid, T0)
            h = self._assess(r, T0, src, sv, condition,
                             trust_prediction=not reacquire)
            if h.ok:
                return r, h, tier
            attempts.append((tier, r, h))
        # No rung is OK: the least-bad SUSPECT (fewest tripped signals, then
        # smallest jump from the prediction; ties keep the earliest tier).
        # Never compare inlier mass across tiers: a widened gate inflates it.
        suspects = [a for a in attempts if a[2].verdict == SUSPECT]
        if suspects:
            tier, r, h = min(suspects,
                             key=lambda a: (len(a[2].reasons),
                                            a[2].pose_jump_m))
            return r, h, tier
        # every rung FAILED: coast (tier N+1), report the primary's health
        return None, attempts[0][2], len(cfg.recovery_tiers) + 1

    # -- streaming API -----------------------------------------------------
    def prepare_frame(self, scan, valid=None,
                      downsampled=None) -> PreparedFrame:
        """Frame ingest and host classification, without the registration:
        scrub NaN/Inf rows, voxel-downsample to the scan budget on the
        pipeline's device, predict the warm start, and decide whether this
        frame bootstraps the map, coasts (no usable returns) or registers.

        ``downsampled=(src, sv, n_valid)`` skips the scrub and downsample
        (a caller that ran that stage batched hands each pipeline its lane).
        """
        cfg = self.config
        if downsampled is None:
            pts = torch.as_tensor(scan, dtype=torch.float32,
                                  device=self.device)
            if valid is not None:
                valid = torch.as_tensor(valid, dtype=torch.bool,
                                        device=self.device)
            pts, valid = scrub_nonfinite(pts, valid)
            src, sv = voxel_downsample(pts, cfg.scan_voxel,
                                       max_points=cfg.scan_budget,
                                       valid=valid)
            n_valid = int(sv.sum())
        else:
            src, sv, n_valid = downsampled
        frame = len(self.poses)
        if frame == 0:
            return PreparedFrame(frame=frame, kind=KIND_BOOTSTRAP, src=src,
                                 sv=sv, T0=np.eye(4, dtype=np.float32))
        if n_valid == 0:
            return PreparedFrame(frame=frame, kind=KIND_EMPTY, src=src,
                                 sv=sv, T0=np.asarray(self._predict(),
                                                      np.float32))
        reacquire = (cfg.recovery and frame >= cfg.warmup_frames
                     and self._coast_streak > 0)
        return PreparedFrame(frame=frame, kind=KIND_REGISTER, src=src,
                             sv=sv, T0=np.asarray(self._predict(),
                                                  np.float32),
                             reacquire=reacquire,
                             skip_primary=(reacquire
                                           and bool(cfg.recovery_tiers)))

    def complete_frame(self, prep: PreparedFrame, result=None, *,
                       lattice_frac: float | None = None,
                       defer_fuse: bool = False,
                       defer_bootstrap: bool = False):
        """Host-side frame completion: health assessment, recovery
        cascade, accept/quarantine bookkeeping, map fusion. Returns
        ``(pose, diagnostics, fuse_request)``.

        ``result`` is the primary registration's ICPResult for
        ``KIND_REGISTER`` frames (None when ``prep.skip_primary``);
        ``lattice_frac`` optionally supplies its out-of-lattice probe. With
        ``defer_fuse=True`` an accepted fusable frame returns a
        :class:`FuseRequest` instead of inserting into the submap (the
        caller then patches ``diag.map_occupancy``, reported here as -1);
        ``defer_bootstrap=True`` extends that to the bootstrap frame.
        """
        cfg = self.config
        frame, src, sv, T0 = prep.frame, prep.src, prep.sv, prep.T0
        fuse_req = None
        if prep.kind == KIND_BOOTSTRAP:
            pose = np.eye(4, dtype=np.float32)
            if defer_fuse and defer_bootstrap:
                fuse_req = FuseRequest(src=src, sv=sv, pose=pose)
                occ = -1.0
            else:
                self.submap.insert(src, center=np.zeros(3, np.float32),
                                   valid=sv)
                occ = self.submap.occupancy()
            diag = FrameDiagnostics(frame=0, iterations=0, inlier_frac=1.0,
                                    rmse=0.0, degenerate=False, accepted=True,
                                    map_occupancy=occ,
                                    dropped_cells=self.submap.dropped_cells)
        elif prep.kind == KIND_EMPTY:
            # dropped frame (no usable returns): coast without spending a
            # registration, quarantine, decay the velocity
            pose = np.asarray(T0, np.float32)
            self._velocity = _decay_toward_identity(self._velocity,
                                                    cfg.velocity_decay)
            self._coast_streak += 1
            tier = len(cfg.recovery_tiers) + 1 if cfg.recovery else 0
            if tier > 0:
                self.recovery_count += 1
            self.quarantined_count += 1
            diag = FrameDiagnostics(frame=frame, iterations=0,
                                    inlier_frac=0.0, rmse=float("inf"),
                                    degenerate=True, accepted=False,
                                    map_occupancy=self.submap.occupancy(),
                                    health=FAILED, recovery_tier=tier,
                                    quarantined=True,
                                    dropped_cells=self.submap.dropped_cells)
        else:
            reacquire = prep.reacquire
            if cfg.recovery and frame >= cfg.warmup_frames:
                condition = self._scan_condition(src, sv)
                map_pts, map_valid = self.submap.target()
                res, health, tier = self._cascade(
                    src, sv, map_pts, map_valid, T0, condition,
                    reacquire=reacquire, primary=result,
                    out_of_lattice=lattice_frac)
                accepted = res is not None
            else:
                res = host_result(result)
                health = self._assess(res, T0, src, sv,
                                      out_of_lattice=lattice_frac)
                tier = 0
                accepted = (not bool(res.degenerate)
                            and float(res.inlier_frac)
                            >= cfg.min_inlier_frac)
            # A SUSPECT pose is output but not fused: one wrong scan in the
            # submap poisons every later frame. With recovery off, fuse ==
            # accept.
            fused = accepted and (not cfg.recovery or health.verdict == OK)
            self._coast_streak = 0 if accepted else self._coast_streak + 1
            if accepted:
                pose = np.asarray(res.T, np.float32)
                prev = self.poses[-1]
                if not reacquire:
                    self._velocity = (np.linalg.inv(prev) @ pose).astype(
                        np.float32)
                # else: the previous (coasted) pose was wrong; keep the
                # decayed coast velocity as the motion estimate.
                if fused:
                    if defer_fuse:
                        fuse_req = FuseRequest(src=src, sv=sv, pose=pose)
                    else:
                        self.submap.insert(
                            transform_points(torch.as_tensor(
                                pose, dtype=torch.float32,
                                device=src.device), src),
                            center=pose[:3, 3], valid=sv)
            else:
                pose = np.asarray(T0, np.float32)
                # decay the motion model: coasting frames bleed speed
                self._velocity = _decay_toward_identity(self._velocity,
                                                        cfg.velocity_decay)
            if tier > 0:
                self.recovery_count += 1
            if not fused:
                self.quarantined_count += 1
            last = res
            diag = FrameDiagnostics(
                frame=frame,
                iterations=int(last.iterations) if last is not None else 0,
                inlier_frac=(float(last.inlier_frac)
                             if last is not None else 0.0),
                rmse=float(last.rmse) if last is not None else float("inf"),
                degenerate=(bool(last.degenerate)
                            if last is not None else True),
                accepted=accepted,
                map_occupancy=(-1.0 if fuse_req is not None
                               else self.submap.occupancy()),
                health=health.verdict, recovery_tier=tier,
                pose_jump=health.pose_jump_m,
                quarantined=not fused,
                dropped_cells=self.submap.dropped_cells)
        self.poses.append(pose)
        self.diagnostics.append(diag)
        return pose, diag, fuse_req

    def amend_diagnostics(self, frame: int,
                          **fields) -> FrameDiagnostics:
        """Patch the stored diagnostics for ``frame`` (e.g. fill
        ``map_occupancy`` after a deferred fuse). Returns the amended
        record."""
        idx = next(i for i, d in enumerate(self.diagnostics)
                   if d.frame == frame)
        self.diagnostics[idx] = self.diagnostics[idx]._replace(**fields)
        return self.diagnostics[idx]

    def process(self, scan, valid=None) -> tuple[np.ndarray, FrameDiagnostics]:
        """Ingest one sensor-frame scan; returns (pose, diagnostics).

        ``valid`` is an optional (N,) row mask (collate conventions). This
        is :meth:`prepare_frame` + primary registration +
        :meth:`complete_frame` in sequence.
        """
        prep = self.prepare_frame(scan, valid)
        res = None
        if prep.kind == KIND_REGISTER and not prep.skip_primary:
            map_pts, map_valid = self.submap.target()
            res = self.engine.register(prep.src, map_pts, self.config.params,
                                       initial_transform=prep.T0,
                                       src_valid=prep.sv,
                                       dst_valid=map_valid)
        pose, diag, _ = self.complete_frame(prep, res)
        return pose, diag

    def run(self, scans) -> tuple[np.ndarray, list[FrameDiagnostics]]:
        """Process a whole sequence; returns ((F,4,4) poses, diagnostics)."""
        for scan in scans:
            self.process(scan)
        return np.stack(self.poses), list(self.diagnostics)

    # -- stream-level summaries -------------------------------------------
    def mean_iterations(self) -> float:
        """Mean ICP iterations over registered frames (frame 0 excluded)."""
        its = [d.iterations for d in self.diagnostics if d.frame > 0]
        return float(np.mean(its)) if its else 0.0

    def rejected_frames(self) -> int:
        return sum(1 for d in self.diagnostics if not d.accepted)

    def health_counts(self) -> dict[str, int]:
        """Verdict histogram over the stream (``{"ok": ..., ...}``)."""
        out = {OK: 0, SUSPECT: 0, FAILED: 0}
        for d in self.diagnostics:
            out[d.health] += 1
        return out

    def tier_counts(self) -> dict[int, int]:
        """Histogram of the recovery tier each frame settled at."""
        out: dict[int, int] = {}
        for d in self.diagnostics:
            out[d.recovery_tier] = out.get(d.recovery_tier, 0) + 1
        return out
