"""Registration engines (port of ``repro.core.engine``).

An engine owns the choice of correspondence searcher, shape bucketing and
the ``register`` API:

  * ``"torch"`` (:class:`TorchEngine`, the reference's ``"xla"``): the plain
    chunked brute force of ``core.nn_search``, with native ``dst_valid``
    masking;
  * ``"cuda"`` (:class:`KernelEngine`, the reference's ``"pallas"``): the
    hand-written brute-force NN kernel, with the target augmented once per
    frame (``kernels.ops.resident_nn_fn``); with ``ICPParams.fused`` the
    fused moment kernel over a resident voxel grid instead
    (``kernels.fused_icp``). On CPU tensors each kernel wrapper runs its
    plain version. For the point-to-plane minimiser every engine estimates
    the target normals once per frame (``data.normals``);
  * ``"pyramid"`` (``core.pyramid.PyramidEngine``): coarse-to-fine ICP
    whose full-resolution polish runs the grid candidate sweep (or, fused,
    the moment kernel);
  * ``"slots"`` (:class:`SlotEngine`): the ``"cuda"`` engine at a fixed
    lane width, behind the multi-stream registration service;
  * ``"sharded-slots"`` (:class:`ShardedSlotEngine`): the slot engine's
    program on each block of a ``("streams",)`` device mesh
    (``core.distributed``), behind the service's sharded mode;
  * ``"distributed"`` (:class:`DistributedEngine`): the legacy point-sharded
    fleet mode, frames over ``"data"`` and each target over ``"model"``;
  * a user callable ``nn_fn(src, dst) -> (d2, idx)`` (:class:`CallableEngine`).

Every engine has a device, ``"cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA without it raises. ``register`` pads both
clouds on the device to the next shape bucket, ``register_batch`` runs a
padded (B, N, 3)/(B, M, 3) batch as one loop, and ``register_pairs``
collates variable-size pairs first.

The reference's jit caches and their trace counters
(``RegistrationEngine.trace_count``/``traces``) have no counterpart: PyTorch
runs eagerly and compiles nothing per shape.

Typical use::

    engine = get_engine("cuda")
    res, batch = engine.register_pairs([(src0, dst0), (src1, dst1)])
    # res.T[k] is the 4x4 transform of pair k
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core.icp import (ICPParams, ICPResult,
                                  _auto_target_normals, icp, icp_batch,
                                  scrub_nonfinite)
from repro_torch.core.transform import transform_points
from repro_torch.data.collate import PAD_SENTINEL, bucket_size, collate_pairs
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ops import resident_nn_fn


def _mask_invalid(points: torch.Tensor,
                  valid: torch.Tensor | None) -> torch.Tensor:
    """Move masked rows to the far sentinel so no searcher can match them."""
    if valid is None:
        return points
    return torch.where(valid[..., None], points, PAD_SENTINEL)


def _pad_device(points: torch.Tensor, size: int):
    """On-device analogue of ``collate.pad_cloud``: ((size, 3), (size,))."""
    n = points.shape[0]
    padded = torch.cat([points, points.new_full((size - n, 3),
                                                PAD_SENTINEL)])
    valid = torch.arange(size, device=points.device) < n
    return padded, valid


def _as(x, dtype, dev):
    return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)


class RegistrationEngine:
    """Base engine: device, bucketing and the register API.

    Subclasses pick the searcher through :meth:`_nn_fn`, or override
    :meth:`_register`/:meth:`_register_batch` when they prepare the target
    once per frame.
    """

    name = "base"

    def __init__(self, chunk: int = 2048, device="cuda"):
        self._chunk = chunk
        self.device = resolve_device(device)

    def setup(self) -> None:
        """Backend init hook (the paper's .xclbin load). Idempotent."""
        if self.device.type == "cuda":
            torch.cuda.init()

    # -- subclass hooks ----------------------------------------------------
    def _nn_fn(self, params: ICPParams) -> Callable | None:
        """Searcher ``(src, dst) -> (d2, idx)``; None selects the plain
        brute force inside ``core.icp``."""
        return None

    def _register(self, src, dst, params, T0, sv, dv) -> ICPResult:
        return icp(src, dst, params, T0, nn_fn=self._nn_fn(params),
                   src_valid=sv, dst_valid=dv)

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        return icp_batch(src, dst, params, T0, nn_fn=self._nn_fn(params),
                         src_valid=sv, dst_valid=dv)

    def _default_params(self, params: ICPParams | None) -> ICPParams:
        return ICPParams(chunk=self._chunk) if params is None else params

    def _device(self, device) -> torch.device:
        return self.device if device is None else resolve_device(device)

    # -- public API --------------------------------------------------------
    def register(self, source, target, params: ICPParams | None = None,
                 initial_transform=None, *, src_valid=None, dst_valid=None,
                 bucket: bool = True, device=None) -> ICPResult:
        """Register one (N, 3) source onto one (M, 3) target.

        With ``bucket=True`` both clouds are padded on the device to the
        next shape bucket (``data.collate``), as the reference does; masks
        passed in ``src_valid``/``dst_valid`` instead keep the given
        shapes. Inputs are cast to float32 on ``device`` (default: the
        engine's).
        """
        params = self._default_params(params)
        dev = self._device(device)
        src = _as(source, torch.float32, dev)
        dst = _as(target, torch.float32, dev)
        T0 = _as(initial_transform, torch.float32, dev)
        sv = _as(src_valid, torch.bool, dev)
        dv = _as(dst_valid, torch.bool, dev)
        if sv is None and dv is None and bucket:
            n_b, m_b = bucket_size(src.shape[0]), bucket_size(dst.shape[0])
            if (src.shape[0], dst.shape[0]) != (n_b, m_b):
                src, sv = _pad_device(src, n_b)
                dst, dv = _pad_device(dst, m_b)
        return self._register(src, dst, params, T0, sv, dv)

    def register_batch(self, sources, targets,
                       params: ICPParams | None = None, *,
                       src_valid=None, dst_valid=None,
                       initial_transforms=None, device=None) -> ICPResult:
        """Register a (B, N, 3) source batch onto a (B, M, 3) target batch
        in one fixed-iteration loop; every result field gains a leading
        batch axis. Masks come from ``collate_pairs``."""
        params = self._default_params(params)
        dev = self._device(device)
        return self._register_batch(
            _as(sources, torch.float32, dev), _as(targets, torch.float32, dev),
            params, _as(initial_transforms, torch.float32, dev),
            _as(src_valid, torch.bool, dev), _as(dst_valid, torch.bool, dev))

    def register_pairs(self, pairs, params: ICPParams | None = None,
                       initial_transforms=None, device=None):
        """Collate variable-size ``[(src, dst), ...]`` and register them as
        one batch. Returns ``(ICPResult, CollatedBatch)``."""
        batch = collate_pairs(pairs)
        res = self.register_batch(batch.src, batch.dst, params,
                                  src_valid=batch.src_valid,
                                  dst_valid=batch.dst_valid,
                                  initial_transforms=initial_transforms,
                                  device=device)
        return res, batch


class TorchEngine(RegistrationEngine):
    """Plain PyTorch engine: chunked brute-force NN on any device."""

    name = "torch"


class KernelEngine(RegistrationEngine):
    """CUDA kernel engine: the brute-force NN kernel against a target
    augmented once per frame, or with ``params.fused`` the fused moment
    kernel against a resident voxel grid.

    As in the reference's ``"pallas"`` engine, both clouds are scrubbed of
    non-finite rows first; the plane minimiser's target normals come from
    the scrubbed target and its true valid mask. Unfused, they are
    estimated here, then the masked target rows move to the far sentinel
    and the (…, 8, M') target operand is built before the loop; each
    iteration augments only the source. Fused, ``core.icp`` estimates them
    and builds a counting-sort grid over the valid target rows at the
    pyramid polish's defaults (``kernels.fused_icp.default_fused_fn``); each
    iteration is one gather and one fused pass.
    """

    name = "cuda"

    def setup(self) -> None:
        """Initialise the card and build the kernel libraries."""
        super().setup()
        if self.device.type == "cuda":
            build.build_all(["nn_search", "fused_icp"])

    def _prepare(self, src, dst, params, sv, dv):
        """Scrubbed clouds and source mask, and what ``core.icp`` needs for
        the iteration: ``dst_valid`` fused (it builds the grid and estimates
        the plane minimiser's normals), or unfused ``nn_fn`` and the
        ``target_normals`` estimated before the target is masked."""
        src, sv = scrub_nonfinite(src, sv)
        dst, dv = scrub_nonfinite(dst, dv)
        if params.fused:
            return src, dst, sv, dict(dst_valid=dv)
        normals = (_auto_target_normals(dst, dv)
                   if params.minimizer == "point_to_plane" else None)
        dst = _mask_invalid(dst, dv)
        return src, dst, sv, dict(nn_fn=resident_nn_fn(dst),
                                  target_normals=normals)

    def _register(self, src, dst, params, T0, sv, dv) -> ICPResult:
        src, dst, sv, search = self._prepare(src, dst, params, sv, dv)
        return icp(src, dst, params, T0, src_valid=sv, **search)

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        src, dst, sv, search = self._prepare(src, dst, params, sv, dv)
        return icp_batch(src, dst, params, T0, src_valid=sv, **search)


class SlotEngine(KernelEngine):
    """Fixed-width slot-batch engine backing the multi-stream registration
    service (``serve.registration_service``).

    Every registration, the service's S-stream fleet step and a lone
    single-frame :meth:`register` call alike, runs as one ``slots``-lane
    batch through :func:`core.icp.icp`, the loop that stops when no lane
    is active and keeps converged or inactive lanes frozen (the
    reference's ``vmap(icp)`` while loop). Each lane searches through the
    brute-force NN kernel against a target augmented once per call, as in
    the ``"cuda"`` engine; the reference's lanes run its plain ``"xla"``
    brute force, the same function.

    A single-frame call embeds the frame at lane 0 among sentinel lanes
    with all-False masks (they freeze as degenerate after one iteration)
    and returns lane 0, so a per-stream ``OdometryPipeline`` on this engine
    runs the same S-lane program as the service: the service's bit-exact
    single-stream reference. A one-lane shortcut would run another
    program on the card and break that contract.

    The reference counts its jit traces; an eager engine traces nothing.
    The service counts instead the distinct (params, S, N, M) batches its
    rounds register (``service_report()["batch_shapes"]``).
    """

    name = "slots"

    def __init__(self, chunk: int = 2048, slots: int = 8, device="cuda"):
        super().__init__(chunk, device)
        self.slots = int(slots)

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        src, dst, sv, search = self._prepare(src, dst, params, sv, dv)
        return icp(src, dst, params, T0, src_valid=sv, **search)

    def _register(self, src, dst, params, T0, sv, dv) -> ICPResult:
        """The pair at lane 0 of a ``slots``-lane batch; the other lanes
        hold sentinel rows with all-False masks."""
        dev = src.device
        if sv is None:
            sv = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
        if dv is None:
            dv = torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
        if T0 is None:
            T0 = torch.eye(4, dtype=torch.float32, device=dev)
        lane = torch.arange(self.slots, device=dev) == 0
        src_b = torch.where(lane[:, None, None], src, PAD_SENTINEL)
        dst_b = torch.where(lane[:, None, None], dst, PAD_SENTINEL)
        T0_b = T0.expand(self.slots, 4, 4).contiguous()
        res = self._register_batch(src_b, dst_b, params, T0_b,
                                   lane[:, None] & sv, lane[:, None] & dv)
        return ICPResult(*(x[0] for x in res))


class ShardedSlotEngine(SlotEngine):
    """Device-parallel slot engine: the ``"slots"`` program on every block
    of a 1-D ``("streams",)`` mesh (``core.distributed.stream_sharded_icp``).

    The fleet width is ``devices * lanes_per_device``; each device runs the
    slot engine's per-call program (scrub, mask, the target augmented once,
    the stop-early loop) over its own ``lanes_per_device`` lanes, with no
    cross-device traffic, the blocks in lockstep. The block program is
    fixed by ``lanes_per_device`` alone, so a lane's result has the same
    bits for any number of blocks at equal block width, and at D=1 it is
    the ``"slots"`` engine's at ``slots=lanes_per_device`` (the same calls
    on the same shapes). Across widths the agreement is float tolerance.

    ``devices`` is an int (0: every card, or one block on the CPU; the
    first D cards when ``device`` is CUDA, D blocks on the CPU when it is
    the CPU) or an explicit tuple of devices, repeats allowed, which then
    decides alone. Both stay hashable, so ``get_engine`` shares the
    engine. ``register`` embeds a single pair at lane 0 of the S-lane
    sharded batch (inherited from :class:`SlotEngine`), so a standalone
    ``OdometryPipeline`` on this engine is the sharded service's bit-exact
    reference. ``register_batch`` returns the fleet's result on the mesh's
    first device; :meth:`register_blocks` takes and returns per-block
    tensors, each on its device.
    """

    name = "sharded-slots"

    def __init__(self, chunk: int = 2048, lanes_per_device: int = 2,
                 devices=0, device="cuda"):
        blocks = dist.fleet_devices(devices, device)
        self.lanes_per_device = int(lanes_per_device)
        self.devices = len(blocks)
        super().__init__(chunk, slots=self.devices * self.lanes_per_device,
                         device=blocks[0])
        self._mesh = dist.streams_mesh(blocks)

    @property
    def mesh(self) -> dist.Mesh:
        """The ``("streams",)`` mesh the fleet is sharded over."""
        return self._mesh

    def place(self, x, dtype=None) -> list[torch.Tensor]:
        """An ``(S, ...)`` fleet tensor as its lane blocks, each on its
        device (the reference's ``sharding()`` placement)."""
        return dist.split_lanes(self._mesh, x, dtype)

    def register_blocks(self, src_blocks, dst_blocks,
                        params: ICPParams | None = None, *,
                        initial_transforms, src_valid,
                        dst_valid) -> list[ICPResult]:
        """The fleet registration on already placed lane blocks (lists of
        ``(L, ...)`` tensors, one a mesh device); one result per block."""
        return dist.stream_sharded_blocks(
            self._mesh, src_blocks, dst_blocks, self._default_params(params),
            initial_transforms=initial_transforms, src_valid=src_valid,
            dst_valid=dst_valid, prepare=self._prepare)

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        return dist.stream_sharded_icp(self._mesh, src, dst, params,
                                       initial_transforms=T0, src_valid=sv,
                                       dst_valid=dv, prepare=self._prepare)


class DistributedEngine(RegistrationEngine):
    """Fleet-mode engine: frames split over ``"data"``, each target over
    ``"model"`` (``core.distributed.batched_icp_sharded``, the legacy
    point-sharded path), on a ``(n, 1)`` ``("data", "model")`` mesh over
    the local cards (one CPU device on the CPU) or a caller's mesh.

    As in the reference: both clouds are scrubbed first; the frame count
    is padded to a multiple of the data extent by repeating frame 0 and
    the result sliced back; the plane minimiser's normals are estimated on
    the unsharded targets with their true valid mask, before masked target
    rows move to the far sentinel; a warm start pre-transforms the sources
    and is composed into the result; a single pair runs as a batch of one.
    Results lie on the mesh's first device.
    """

    name = "distributed"

    def __init__(self, chunk: int = 2048, mesh: dist.Mesh | None = None,
                 frame_axes=("data",), target_axes=("model",),
                 device="cuda"):
        if mesh is None:
            devs = dist.fleet_devices(0, device)
            mesh = dist.Mesh(np.array(devs, dtype=object).reshape(-1, 1),
                             ("data", "model"))
        super().__init__(chunk, device=mesh.devices.flat[0])
        self._mesh = mesh
        self._frame_axes = tuple(frame_axes)
        self._target_axes = tuple(target_axes)

    @property
    def mesh(self) -> dist.Mesh:
        return self._mesh

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        src, sv = scrub_nonfinite(src, sv)
        dst, dv = scrub_nonfinite(dst, dv)
        frame_div = int(np.prod([self._mesh.shape[ax]
                                 for ax in self._frame_axes]))
        b = src.shape[0]
        pad = (-b) % frame_div

        def rep(x):
            if x is None or pad == 0:
                return x
            return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])

        src, dst, T0, sv, dv = map(rep, (src, dst, T0, sv, dv))
        normals = None
        if params.minimizer == "point_to_plane":
            normals = _auto_target_normals(
                dst, torch.ones(dst.shape[:2], dtype=torch.bool,
                                device=dst.device) if dv is None else dv)
        dst = _mask_invalid(dst, dv)
        if T0 is not None:
            src = transform_points(T0, src)
        res = dist.batched_icp_sharded(
            self._mesh, src, dst, params, frame_axes=self._frame_axes,
            target_axes=self._target_axes, src_valid=sv, dst_normals=normals)
        if T0 is not None:
            res = res._replace(T=res.T @ T0.to(res.T.device))
        if pad:
            res = ICPResult(*(x[:b] for x in res))
        return res

    def _register(self, src, dst, params, T0, sv, dv) -> ICPResult:
        res = self._register_batch(
            src[None], dst[None], params, None if T0 is None else T0[None],
            None if sv is None else sv[None], None if dv is None else dv[None])
        return ICPResult(*(x[0] for x in res))


class CallableEngine(RegistrationEngine):
    """Adapter for a user ``nn_fn(src, dst) -> (d2, idx)`` over batched
    (..., N, 3)/(..., M, 3) clouds."""

    name = "callable"

    def __init__(self, nn_fn: Callable, chunk: int = 2048, device="cuda"):
        super().__init__(chunk, device)
        self._user_nn_fn = nn_fn

    def _nn_fn(self, params: ICPParams) -> Callable:
        return self._user_nn_fn


# -- registry ---------------------------------------------------------------
_ENGINES: dict[str, Callable[..., RegistrationEngine]] = {}
_SHARED: dict = {}  # (name, device, sorted kwargs) -> engine instance


def register_engine(name: str, factory: Callable[..., RegistrationEngine]):
    """Register an engine factory under ``name`` (last write wins)."""
    _ENGINES[name] = factory
    _SHARED.clear()
    return factory


def available_engines() -> tuple[str, ...]:
    """Registered engine names, sorted: the valid ``get_engine`` specs."""
    return tuple(sorted(_ENGINES))


def get_engine(spec, device="cuda", **kwargs) -> RegistrationEngine:
    """Resolve an engine spec: a ``RegistrationEngine`` (passed through), a
    registered name, or a bare ``nn_fn`` callable, on ``device``.

    Named engines with hashable kwargs are shared per process, so building
    ``FppsICP()`` per frame reuses one engine. Instantiate the class
    directly for a private one.
    """
    if isinstance(spec, RegistrationEngine):
        return spec
    if isinstance(spec, str):
        if spec not in _ENGINES:
            raise ValueError(f"unknown engine {spec!r}; available: "
                             f"{available_engines()}")
        dev = resolve_device(device)
        key = (spec, str(dev), tuple(sorted(kwargs.items())))
        try:
            engine = _SHARED.get(key)
        except TypeError:  # unhashable kwarg: a private engine
            return _ENGINES[spec](device=dev, **kwargs)
        if engine is None:
            engine = _SHARED[key] = _ENGINES[spec](device=dev, **kwargs)
        return engine
    if callable(spec):
        return CallableEngine(spec, device=device, **kwargs)
    raise TypeError(f"engine spec must be a name, callable or "
                    f"RegistrationEngine, got {type(spec).__name__}")


register_engine("torch", TorchEngine)
register_engine("cuda", KernelEngine)
register_engine("slots", SlotEngine)
register_engine("sharded-slots", ShardedSlotEngine)
register_engine("distributed", DistributedEngine)

# Imported for its side effect: registers the "pyramid" engine. It lives in
# its own module (the voxel and grid stack); importing it last keeps the
# pyramid -> engine -> pyramid cycle harmless.
from repro_torch.core import pyramid as _pyramid  # noqa: E402,F401
