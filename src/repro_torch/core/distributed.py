"""Multi-device FPPS: stream-sharded and point-sharded registration (port of
``repro.core.distributed``).

The reference runs these under ``shard_map`` over a JAX device mesh. PyTorch
has no ``shard_map``; the port keeps the reference's single-controller
model instead: one Python process drives every device. A :class:`Mesh` is a
numpy array of ``torch.device`` with axis names; a *shard body* is a plain
function applied to each device's contiguous block of lanes (or of target
rows), with that block's tensors on that device. Entries may repeat
(``["cuda:0", "cuda:0"]``, ``["cpu"] * 4``): the port's counterpart of XLA's
forced host device count, and the way one card (or the CPU) runs D > 1.

The production scale-out path is **stream sharding** (DESIGN.md §14): a 1-D
``("streams",)`` mesh where each device owns a contiguous block of
independent odometry streams, their scans, their registrations and their
resident submaps. Streams never exchange data, so the shard body
(:func:`stream_sharded_icp`: ``core.icp.icp`` over the device's lane block)
needs no collective. The blocks run in lockstep
(``core.icp.icp_lockstep``): every iteration issues each still-active
block's step on its own device, then reads all blocks' flags in one host
sync, so D cards do not take turns. A block whose lanes have all stopped is
not stepped again, and its result is the one it gets alone: a lane's bits
do not depend on how many blocks the fleet has, at equal block width (the
reference's weak-scaling contract).

Two **legacy single-frame** configurations are kept for registrations whose
*individual* target cloud outgrows one device:

1. **Point-sharded fleet mode** (:func:`batched_icp_sharded`): frame pairs
   over ``frame_axes``; within each frame the *target* cloud is split over
   ``target_axes``. Each iteration every target shard runs a local exact NN
   search and returns its (score, x, y, z[, nx, ny, nz]) winner tuples;
   they are copied to the frame block's home device (its device at target
   shard 0) and combined: the lowest score wins, ties going to the lower
   shard, as the reference's all-gather plus ``jnp.argmin`` does. The ICP step then
   runs once, on the home device (the reference repeats it on every
   model rank).
2. **Giant-frame mode** (:func:`icp_sharded`): one registration whose target
   is split over every target device.

On a CUDA block the local search is the brute-force NN kernel with the
shard's target augmented once per call (as ``kernels.ops.resident_nn_fn``
does); on a CPU block its plain version. The reference runs its plain XLA
search there; the kernel computes the same function. The shards compare
the kernel's own key, its four-term score, and the combine keeps the lower
shard on ties: shards are contiguous row blocks, so the result is one
search's, bit for bit, first-index ties included. With several target axes
the port combines in the global shard order (row-major over
``target_axes``), which is that answer; the reference's first-axis-first
combine may pick another tied row. Padded target rows must carry the far
sentinel: the combine has no mask channel, so a shard with no valid row
returns finite but far winners.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.icp import ICPParams, ICPResult, icp_lockstep
from repro_torch.core.nn_search import gather_rows
from repro_torch.device import resolve_device, round_up
from repro_torch.kernels import ref
from repro_torch.kernels.nn_search import BLOCK_N, TILE_M, nn_search_kernel


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named device grid: ``devices`` (a numpy object array of
    ``torch.device``, one dimension per axis) and ``axis_names``.
    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape``.
    Entries may repeat, and may be ``meta`` devices (shapes only: the
    dry-run's production meshes). Unhashable, so an engine given a mesh is
    private to its caller (``core.engine.get_engine``)."""

    __hash__ = None

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_indexed(resolve_device(d)) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, shape="
                f"{self.shape})")


def fleet_devices(devices=0, device="cuda") -> list[torch.device]:
    """The devices of a D-block fleet.

    ``devices`` is an explicit sequence (entries may repeat), or an int D:
    the first D cards when ``device`` is CUDA, D blocks on the CPU when it
    is the CPU; 0 or None means every card (one block on the CPU). Asking
    for more cards than exist raises (``device.resolve_device``)."""
    if devices is not None and not isinstance(devices, (int, np.integer)):
        out = [_indexed(resolve_device(d)) for d in devices]
        if not out:
            raise ValueError("an explicit device list must not be empty")
        return out
    dev = resolve_device(device)
    n = int(devices or 0)
    if n < 0:
        raise ValueError(f"devices must be >= 1 (0: all), got {n}")
    if dev.type == "cpu":
        return [dev] * (n or 1)
    n = n or torch.cuda.device_count()
    return [resolve_device(f"cuda:{i}") for i in range(n)]


def streams_mesh(devices=None) -> Mesh:
    """The 1-D ``("streams",)`` mesh stream sharding runs on.

    An int takes the first N cards (None: all), raising outside ``[1,
    torch.cuda.device_count()]``; a sequence names the devices, repeats
    allowed (``["cuda:0"] * 2``, ``["cpu"] * 4``). Device ``d`` owns lane
    block ``[d*L, (d+1)*L)`` of every ``(S, ...)`` fleet tensor.
    """
    if isinstance(devices, (int, np.integer)) and devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    return Mesh(fleet_devices(devices, "cuda"), ("streams",))


# -- stream sharding (the production scale-out path) --------------------------

def split_lanes(mesh: Mesh, x, dtype=None) -> list:
    """An ``(S, ...)`` tensor or array as the mesh's D contiguous lane
    blocks, each on its device (no copy where it already is there); None
    gives D Nones."""
    devs = list(mesh.devices.flat)
    if x is None:
        return [None] * len(devs)
    x = torch.as_tensor(x, dtype=dtype)
    if x.shape[0] % len(devs):
        raise ValueError(f"lane count {x.shape[0]} must divide the streams "
                         f"mesh size {len(devs)}")
    L = x.shape[0] // len(devs)
    return [x[d * L:(d + 1) * L].to(dev) for d, dev in enumerate(devs)]


def gather_lanes(results: Sequence[ICPResult], device) -> ICPResult:
    """Per-block results as one ``(S, ...)`` result on ``device``."""
    return ICPResult(*(torch.cat([x.to(device) for x in leaves])
                       for leaves in zip(*results)))


def stream_sharded_blocks(mesh: Mesh, src_blocks, dst_blocks,
                          params: ICPParams = ICPParams(), *,
                          initial_transforms, src_valid, dst_valid,
                          nn_fn: Callable | None = None,
                          prepare: Callable | None = None
                          ) -> list[ICPResult]:
    """The shard body over already placed lane blocks: one list entry per
    mesh device, each ``(L, ...)`` on that device; returns one result per
    block, on its device.

    ``prepare(src, dst, params, src_valid, dst_valid) -> (src, dst,
    src_valid, search)`` runs once per block before the loop (an engine's
    frame-scope target preparation, ``search`` the extra ``icp`` keywords);
    without it every block searches with ``nn_fn`` (default: the plain
    brute force with ``dst_valid`` masking)."""
    if len(src_blocks) != mesh.size:
        raise ValueError(f"{len(src_blocks)} lane blocks for a mesh of "
                         f"{mesh.size} devices")
    calls = []
    for src, dst, T0, sv, dv in zip(src_blocks, dst_blocks,
                                    initial_transforms, src_valid,
                                    dst_valid):
        if prepare is None:
            search = dict(nn_fn=nn_fn, dst_valid=dv)
        else:
            src, dst, sv, search = prepare(src, dst, params, sv, dv)
        calls.append(dict(source=src, target=dst, initial_transform=T0,
                          src_valid=sv, **search))
    return icp_lockstep(calls, params)


def stream_sharded_icp(mesh: Mesh, src_b, dst_b,
                       params: ICPParams = ICPParams(), *,
                       initial_transforms=None, src_valid=None,
                       dst_valid=None, nn_fn: Callable | None = None,
                       prepare: Callable | None = None) -> ICPResult:
    """S independent registrations sharded over a ``("streams",)`` mesh.

    Every ``(S, ...)`` input splits along its lane axis; each device runs
    ``core.icp.icp`` over its own contiguous block of ``S / D`` lanes, with
    no cross-device traffic; the blocks step in lockstep. Masks and warm
    starts default as in ``core.icp.icp`` (every finite row valid, the
    identity); ``nn_fn`` swaps the correspondence searcher as there, and
    ``prepare`` is :func:`stream_sharded_blocks`'s. The result is gathered
    on the mesh's first device. A lane's result has the same bits for any
    mesh size at equal lanes per device.
    """
    S = src_b.shape[0]
    D = mesh.shape["streams"]
    if S % D:
        raise ValueError(f"lane count {S} must divide the streams mesh "
                         f"size {D}")
    f32, b8 = torch.float32, torch.bool
    results = stream_sharded_blocks(
        mesh, split_lanes(mesh, src_b, f32), split_lanes(mesh, dst_b, f32),
        params, initial_transforms=split_lanes(mesh, initial_transforms, f32),
        src_valid=split_lanes(mesh, src_valid, b8),
        dst_valid=split_lanes(mesh, dst_valid, b8), nn_fn=nn_fn,
        prepare=prepare)
    return gather_lanes(results, mesh.devices.flat[0])


# -- legacy point-sharded paths -------------------------------------------------

def _device_grid(mesh: Mesh, frame_axes: Sequence[str],
                 target_axes: Sequence[str]) -> list[list[torch.device]]:
    """``grid[f][t]``: the device of frame block ``f`` and target shard
    ``t``, each index row-major over its axes. Mesh axes in neither group
    take coordinate 0 (the reference repeats the work along them)."""
    names = mesh.axis_names
    for ax in (*frame_axes, *target_axes):
        if ax not in names:
            raise ValueError(f"axis {ax!r} is not in the mesh's {names}")
    if set(frame_axes) & set(target_axes):
        raise ValueError(f"frame_axes {tuple(frame_axes)} and target_axes "
                         f"{tuple(target_axes)} overlap")
    sizes = mesh.shape
    grid = []
    for f_idx in np.ndindex(*(sizes[a] for a in frame_axes)):
        row = []
        for t_idx in np.ndindex(*(sizes[a] for a in target_axes)):
            coord = [0] * len(names)
            for ax, i in zip((*frame_axes, *target_axes), f_idx + t_idx):
                coord[names.index(ax)] = i
            row.append(mesh.devices[tuple(coord)])
        grid.append(row)
    return grid


def _split_rows(x: torch.Tensor, devices: Sequence[torch.device]):
    """Contiguous blocks of the (..., M, C) rows of ``x``, one a device."""
    m, k = x.shape[-2], len(devices)
    if m % k:
        raise ValueError(f"{m} target rows must divide over {k} target "
                         f"shards")
    step = m // k
    return [x[..., t * step:(t + 1) * step, :].to(dev)
            for t, dev in enumerate(devices)]


def _combine(cands: Sequence[tuple]) -> tuple:
    """Winner of per-shard ``(score, *payload)`` candidates, all on one
    device: the lowest score wins, the lower shard on ties."""
    best = cands[0]
    for cand in cands[1:]:
        better = cand[0] < best[0]
        best = tuple(torch.where(better.reshape(better.shape
                                                + (1,) * (x.dim()
                                                          - better.dim())),
                                 x, b) for x, b in zip(cand, best))
    return best


def _augment_shards(targets: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard's augmented target operand, built once, on its device."""
    return [ref.augment_target(t, pad_to=round_up(t.shape[-2], TILE_M))
            for t in targets]


def _search_shards(src: torch.Tensor, dst_augs: Sequence[torch.Tensor],
                   payload: Callable) -> tuple:
    """Exact NN of ``src`` (..., n, 3) over target shards, with one search's
    answer: ``(d2, *payload)`` on ``src``'s device.

    Each shard runs the NN kernel on the source with its ``|p'|²`` row left
    out, so it returns the kernel's own key, the four-term score; the
    lowest score wins across shards, the lower shard on ties (so the lower
    global index, as in one search), and ``|p'|²`` is added to the winner
    once and clamped at 0, as the kernel's wrapper does. Comparing the
    finished d² instead could break a tie that rounding makes where the
    four-term scores differ. ``payload(t, idx)`` gives the columns shard
    ``t`` contributes for its local winners ``idx``."""
    home, n = src.device, src.shape[-2]
    src_aug = ref.augment_source(src, pad_to=round_up(n, BLOCK_N))
    four = src_aug.clone()
    four[..., 4, :] = 0.0
    cands = []
    for t, dst_aug in enumerate(dst_augs):
        score, idx = nn_search_kernel(four.to(dst_aug.device), dst_aug)
        score, idx = score[..., :n], idx[..., :n]
        cands.append(tuple(c.to(home) for c in (score,) + payload(t, idx)))
    score, *rest = _combine(cands)
    return ((score + src_aug[..., 4, :n]).clamp_min(0.0), *rest)


def _sharded_correspond(targets: Sequence[torch.Tensor],
                        normals: Sequence[torch.Tensor] | None = None):
    """``correspond_fn`` of a frame (block) whose target rows are split
    into ``targets``, one shard a device (``normals`` split alike): each
    shard's target is augmented once here; each call copies the moved
    source to every shard, searches locally and combines the (d², x, y,
    z[, nx, ny, nz]) winners on the source's device."""
    dst_augs = _augment_shards(targets)

    def payload(t, idx):
        cols = (gather_rows(targets[t], idx),)
        if normals is not None:
            cols += (gather_rows(normals[t], idx),)
        return cols

    def correspond(src_t):
        return _search_shards(src_t, dst_augs, payload)

    return correspond


def distributed_nn_search(mesh: Mesh, src, dst, *,
                          target_axes: Sequence[str] = ("model",)):
    """Sharded exact NN ``(d2, global idx)``, for tests and benchmarks.

    ``src`` (N, 3) is searched on every target shard; ``dst`` (M, 3) is
    split into contiguous row blocks over ``target_axes``. The global index
    is the shard's row offset plus the local index; the result, one
    search's answer, lies on the first shard's device."""
    shards = _device_grid(mesh, (), tuple(target_axes))[0]
    src = torch.as_tensor(src, dtype=torch.float32).to(shards[0])
    parts = _split_rows(torch.as_tensor(dst, dtype=torch.float32), shards)
    offsets = np.cumsum([0] + [p.shape[-2] for p in parts])
    return tuple(_search_shards(
        src, _augment_shards(parts),
        lambda t, idx: (idx + int(offsets[t]),)))


def icp_sharded(mesh: Mesh, source, target, params: ICPParams = ICPParams(),
                *, target_axes: Sequence[str] = ("data", "model"),
                fixed_iterations: bool = False,
                dst_normals=None) -> ICPResult:
    """LEGACY giant-frame ICP: one registration, the target split over
    ``target_axes`` (city-scale map-to-scan; the module docstring says when
    stream sharding is the better choice). The result lies on the first
    target shard's device.

    ``dst_normals`` (M, 3), needed for ``minimizer="point_to_plane"``, is
    split with the target; estimate it on the *unsharded* cloud.
    """
    if params.minimizer == "point_to_plane" and dst_normals is None:
        raise ValueError("icp_sharded with minimizer='point_to_plane' "
                         "needs dst_normals (estimate on the full target)")
    shards = _device_grid(mesh, (), tuple(target_axes))[0]
    f32 = torch.float32
    targets = _split_rows(torch.as_tensor(target, dtype=f32), shards)
    normals = (None if dst_normals is None else
               _split_rows(torch.as_tensor(dst_normals, dtype=f32), shards))
    call = dict(source=torch.as_tensor(source, dtype=f32).to(shards[0]),
                target=None,
                correspond_fn=_sharded_correspond(targets, normals))
    return icp_lockstep([call], params, stop_early=not fixed_iterations)[0]


def shard_inputs(mesh: Mesh, src_batch, dst_batch,
                 frame_axes: Sequence[str] = ("data",),
                 target_axes: Sequence[str] = ("model",)):
    """Place ``(F, N, 3)`` sources and ``(F, M, 3)`` targets as
    :func:`batched_icp_sharded` runs them: a list with one ``(F/Df, N, 3)``
    source block per frame block, on its home device, and a list per frame
    block of its target row shards, each on its device."""
    grid = _device_grid(mesh, tuple(frame_axes), tuple(target_axes))
    src = torch.as_tensor(src_batch, dtype=torch.float32)
    dst = torch.as_tensor(dst_batch, dtype=torch.float32)
    b = src.shape[0]
    if b % len(grid):
        raise ValueError(f"{b} frames must divide over {len(grid)} frame "
                         f"blocks")
    L = b // len(grid)
    return ([src[f * L:(f + 1) * L].to(row[0]) for f, row in
             enumerate(grid)],
            [_split_rows(dst[f * L:(f + 1) * L], row) for f, row in
             enumerate(grid)])


def batched_icp_sharded(mesh: Mesh, src_batch, dst_batch,
                        params: ICPParams = ICPParams(), *,
                        frame_axes: Sequence[str] = ("data",),
                        target_axes: Sequence[str] = ("model",),
                        fixed_iterations: bool = True,
                        src_valid=None, dst_normals=None) -> ICPResult:
    """LEGACY point-sharded fleet mode: ``(F, N, 3)`` sources onto ``(F, M,
    3)`` targets, frames over ``frame_axes``, each frame's target over
    ``target_axes``; for fleet-scale serving use :func:`stream_sharded_icp`
    (the ``"sharded-slots"`` engine), which needs no per-iteration combine.
    The inputs are tensors or arrays, or the placed lists of
    :func:`shard_inputs`; the result lies on the first frame block's home
    device.

    The frame blocks step in lockstep, by default for exactly
    ``max_iterations`` (the reference's fixed schedule). ``src_valid`` (F,
    N) zero-weights padded source rows; padded *target* rows must carry the
    far sentinel (the combine has no mask channel). ``dst_normals`` (F, M,
    3), needed for the plane minimiser, is split like the targets and rides
    the combine as three more columns.
    """
    if params.minimizer == "point_to_plane" and dst_normals is None:
        raise ValueError("batched_icp_sharded with "
                         "minimizer='point_to_plane' needs dst_normals "
                         "(estimate per frame on the unsharded targets)")
    grid = _device_grid(mesh, tuple(frame_axes), tuple(target_axes))
    if isinstance(src_batch, list):
        src_blocks, dst_blocks = src_batch, dst_batch
    else:
        src_blocks, dst_blocks = shard_inputs(mesh, src_batch, dst_batch,
                                              frame_axes, target_axes)
    sizes = [s.shape[0] for s in src_blocks]
    offsets = np.cumsum([0] + sizes)
    calls = []
    for f, (src, targets) in enumerate(zip(src_blocks, dst_blocks)):
        lo, hi = int(offsets[f]), int(offsets[f + 1])
        sv = (torch.ones(src.shape[:2], dtype=torch.bool) if src_valid is None
              else torch.as_tensor(src_valid[lo:hi], dtype=torch.bool))
        normals = (None if dst_normals is None else _split_rows(
            torch.as_tensor(dst_normals[lo:hi], dtype=torch.float32),
            grid[f]))
        calls.append(dict(source=src, target=None, src_valid=sv.to(src.device),
                          correspond_fn=_sharded_correspond(targets,
                                                            normals)))
    results = icp_lockstep(calls, params, stop_early=not fixed_iterations)
    return gather_lanes(results, grid[0][0])
