"""Rolling local voxel submap for streaming scan-to-map odometry (port of
``repro.data.submap``).

Frame-to-frame odometry chains per-pair errors into a random walk; each
scan registers against a persistent *local map* instead. The map is built
from the port's fixed-shape primitives:

  * **insert**: each registered scan is fused into the map by one
    ``voxel_downsample`` pass over ``concat(map, scan)``: per occupied voxel
    the centroid of old map points and new scan points, so the map grows
    (new cells) and refines (revisited cells average across frames).
    Capacity is static (``SubmapParams.capacity`` rows and a validity mask,
    collate sentinel conventions).
  * **eviction**: cells farther than ``evict_radius`` from the ego drop out
    of the fuse.
  * **re-anchoring**: the lattice origin snaps to the voxel grid centred on
    the ego at every insert, so queries from a moving ego stay inside
    ``dims``, and anything the ego outran is reported as out of the lattice
    instead of matched to a boundary cell.

**Storage modes** (``SubmapParams.storage``):

  * ``"fp32"``: world-frame points and a bool validity mask (13 B per row);
  * ``"fp16"``: half-precision offsets from the fp32 lattice origin, invalid
    rows parked at +inf so validity is ``isfinite`` (6 B per row). Every
    fuse decodes to world-frame fp32, runs the fp32 fuse and re-encodes.

The state is a plain tuple of tensors on one device (``empty_state`` /
``fuse_state`` / ``state_views``); every function takes an optional leading
batch dimension, each lane computed as a single fuse would be (the
reference vmaps). :class:`Submap` is the single-stream wrapper.

Differences from the reference, by design: the centroids are the port's
float64 segment sums (``data.voxelize``), where the reference sums in
float32, so fp32 map points differ by up to ~5e-7 m and an fp16 offset can
differ by one fp16 ulp; cell sets, validity, origins and ``dropped`` counts
are the same. The reference's jitted ``_fuse`` (bare triples) has no
counterpart: :func:`fuse_state` serves both layouts.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.collate import PAD_SENTINEL
from repro_torch.data.voxelize import (VoxelGrid, build_voxel_grid,
                                       voxel_downsample)
from repro_torch.device import resolve_device

STORAGE_MODES = ("fp32", "fp16")


class SubmapParams(NamedTuple):
    """Static submap configuration; same fields and defaults as the
    reference.

    ``dims * voxel_size`` is the lattice extent in metres: size it to cover
    the eviction sphere (``2 * evict_radius``). ``capacity`` is the static
    cell budget; occupied voxels beyond it are dropped deterministically by
    ``voxel_downsample`` and counted by ``Submap.dropped_cells``.
    """

    voxel_size: float = 0.5
    capacity: int = 16384
    dims: tuple[int, int, int] = (192, 192, 48)   # 96 m x 96 m x 24 m
    evict_radius: float = 45.0
    storage: str = "fp32"


def submap_params_from_reference(d: dict) -> SubmapParams:
    """``SubmapParams`` from the reference's ``SubmapParams._asdict()``.

    Raises ``ValueError`` on a field the port does not know, so a new
    reference setting cannot be dropped silently.
    """
    unknown = sorted(set(d) - set(SubmapParams._fields))
    if unknown:
        raise ValueError(f"reference SubmapParams fields unknown to the "
                         f"port: {unknown}")
    d = dict(d)
    if "dims" in d:
        d["dims"] = tuple(int(x) for x in d["dims"])
    return SubmapParams(**d)


# -- functional state API ----------------------------------------------------
#
# A submap's state is a tuple of tensors on one device:
#   fp32: (points (..., cap, 3) f32 world-frame, valid (..., cap) bool,
#          origin (..., 3) f32)
#   fp16: (store (..., cap, 3) f16 origin-relative offsets, origin (..., 3))
# The origin is always the LAST leaf; fp16 validity is isfinite of the
# stored offsets (+inf rows are the invalid sentinels).

def empty_state(params: SubmapParams, device="cuda",
                batch: tuple[int, ...] = ()) -> tuple:
    """The idle (no points) state for ``params`` on ``device``, with
    optional leading ``batch`` dimensions."""
    dev = resolve_device(device)
    lead = tuple(batch)
    cap = int(params.capacity)
    origin = torch.zeros(lead + (3,), dtype=torch.float32, device=dev)
    if params.storage == "fp16":
        store = torch.full(lead + (cap, 3), float("inf"),
                           dtype=torch.float16, device=dev)
        return store, origin
    points = torch.full(lead + (cap, 3), PAD_SENTINEL, dtype=torch.float32,
                        device=dev)
    valid = torch.zeros(lead + (cap,), dtype=torch.bool, device=dev)
    return points, valid, origin


def submap_state_from_reference(leaves, params: SubmapParams,
                                device="cuda") -> tuple:
    """The reference's state tuple (numpy arrays, either storage mode, with
    or without a batch dimension) as the port's state on ``device``."""
    dev = resolve_device(device)
    leaves = tuple(leaves)
    dtypes = ((torch.float16, torch.float32) if params.storage == "fp16"
              else (torch.float32, torch.bool, torch.float32))
    if len(leaves) != len(dtypes):
        raise ValueError(f"{params.storage} state has {len(dtypes)} leaves, "
                         f"got {len(leaves)}")
    return tuple(torch.tensor(np.asarray(leaf), dtype=dt, device=dev)
                 for leaf, dt in zip(leaves, dtypes))


def state_views(state: tuple, params: SubmapParams):
    """Decode a state to registration-target form: ``(points f32
    world-frame, valid bool, origin)``. Invalid rows carry
    ``PAD_SENTINEL`` in both modes; fp32 returns its leaves untouched, fp16
    decodes ``origin + offset`` in fp32."""
    if params.storage == "fp16":
        store, origin = state
        valid = torch.isfinite(store[..., 0])
        points = torch.where(valid[..., None],
                             origin.unsqueeze(-2) + store.to(torch.float32),
                             PAD_SENTINEL)
        return points, valid, origin
    points, valid, origin = state
    return points, valid, origin


def encode_state(points, valid, origin, params: SubmapParams) -> tuple:
    """Pack decoded ``(points, valid, origin)`` into the storage layout."""
    if params.storage == "fp16":
        store = torch.where(valid[..., None], points - origin.unsqueeze(-2),
                            float("inf"))
        return store.to(torch.float16), origin
    return points, valid, origin


def _fuse_core(map_pts, map_valid, new_pts, new_valid, center,
               params: SubmapParams):
    """One insert + evict + re-anchor step on decoded fp32 state. Returns
    ``(points, valid, origin, dropped_cells)`` at ``params.capacity``
    rows."""
    dev = map_pts.device
    v = torch.tensor(params.voxel_size, dtype=torch.float32, device=dev)
    dims = torch.tensor(params.dims, dtype=torch.float32, device=dev)
    center = center.to(torch.float32)
    # Re-anchor: lattice centred on the ego, snapped to the voxel grid.
    origin = torch.floor((center - 0.5 * dims * v) / v) * v
    pts = torch.cat([map_pts, new_pts.to(torch.float32)], dim=-2)
    valid = torch.cat([map_valid, new_valid], dim=-1)
    # Evict by distance from the ego (sentinel pad rows are far anyway)...
    d = pts - center.unsqueeze(-2)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    valid = valid & (d2 <= params.evict_radius ** 2)
    # ...and drop anything outside the re-anchored lattice.
    ic = torch.floor((pts - origin.unsqueeze(-2)) / v)
    valid = valid & ((ic >= 0) & (ic < dims)).all(-1)
    fused, fused_valid, dropped = voxel_downsample(
        pts, v, max_points=params.capacity, valid=valid, origin=origin,
        with_stats=True)
    return fused, fused_valid, origin, dropped


def fuse_state(state: tuple, new_pts, new_valid, center,
               params: SubmapParams):
    """Fuse a world-frame scan (``(..., N, 3)``, mask ``(..., N)``, ego
    ``center`` ``(..., 3)``) into a state. Returns ``(state', occupied,
    dropped)``: the post-fuse valid-cell count and the occupied cells the
    capacity could not hold, ``(...)`` each. The fuse runs in fp32 in both
    storage modes."""
    map_pts, map_valid, _ = state_views(state, params)
    fused, fused_valid, origin, dropped = _fuse_core(
        map_pts, map_valid, new_pts, new_valid, center, params)
    new_state = encode_state(fused, fused_valid, origin, params)
    return new_state, fused_valid.sum(-1), dropped


def state_bytes(params: SubmapParams) -> int:
    """Device bytes of one resident submap's cell payload (the origin leaf
    excluded): 13 B per row in fp32, 6 B in fp16."""
    return sum(leaf.nbytes for leaf in empty_state(params, "cpu")[:-1])


class Submap:
    """Rolling local map on one device: static-capacity fused cloud and
    validity mask.

    ``points``/``valid`` follow collate conventions (invalid rows carry
    ``PAD_SENTINEL``), so the map is a registration target as it is; both
    are decoded views of :attr:`state`. ``dropped_cells`` is the sticky
    saturation counter: the running total of occupied voxels the capacity
    could not hold.
    """

    def __init__(self, params: SubmapParams = SubmapParams(),
                 device="cuda"):
        if params.storage not in STORAGE_MODES:
            raise ValueError(f"storage must be one of {STORAGE_MODES}, "
                             f"got {params.storage!r}")
        self.params = params
        self.device = resolve_device(device)
        self.state = empty_state(params, self.device)
        self.frames_inserted = 0
        self.dropped_cells = 0

    def insert(self, points, center, valid=None) -> None:
        """Fuse a (N, 3) map-frame cloud; evict and re-anchor around
        ``center`` (the ego position in map frame, (3,))."""
        dev = self.device
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        if valid is None:
            valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=dev)
        else:
            valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        self.state, _, dropped = fuse_state(
            self.state, pts, valid,
            torch.as_tensor(center, dtype=torch.float32, device=dev),
            self.params)
        self.frames_inserted += 1
        self.dropped_cells += int(dropped)

    # -- decoded views -----------------------------------------------------
    @property
    def points(self) -> torch.Tensor:
        """Decoded (capacity, 3) f32 cell centroids (invalid rows at the
        sentinel)."""
        return state_views(self.state, self.params)[0]

    @property
    def valid(self) -> torch.Tensor:
        """(capacity,) bool mask of occupied cells."""
        return state_views(self.state, self.params)[1]

    @property
    def origin(self) -> torch.Tensor:
        """Lattice anchor of the rolling window, (3,) f32 world coords."""
        return self.state[-1]

    def target(self):
        """(points, valid): the registration target."""
        pts, valid, _ = state_views(self.state, self.params)
        return pts, valid

    def grid(self) -> VoxelGrid:
        """Counting-sort grid over the live map, anchored at the rolling
        origin."""
        pts, valid, origin = state_views(self.state, self.params)
        return build_voxel_grid(pts, self.params.voxel_size,
                                self.params.dims, valid=valid, origin=origin)

    # -- diagnostics -------------------------------------------------------
    @property
    def size(self) -> int:
        """Occupied voxels (valid map points)."""
        return int(self.valid.sum())

    def occupancy(self) -> float:
        """Fraction of the static capacity in use (1.0 = saturated; check
        ``dropped_cells`` to tell an exact fit from truncation)."""
        return self.size / int(self.params.capacity)
