"""Voxel-grid hashing (port of ``repro.data.voxelize``).

Two bounded, fixed-shape structures over a point cloud:

  * :func:`voxel_downsample`: centroid reduction over occupied voxels, with
    a static ``max_points`` capacity and a validity mask. Invalid output rows
    carry the far ``PAD_SENTINEL``, the collator's convention.
  * :func:`build_voxel_grid`: the cloud sorted by linearised cell id plus
    dense per-cell ``(start, count)`` tables over a static ``dims`` lattice,
    the counting-sort grid that ``core.nn_search_grid`` gathers from.

Both take an optional leading batch dimension: points (B, M, 3) give tables
(B, C), and every lane is sorted by the same batched ``argsort`` call (one
sort with the lane as the most significant key), not by a loop over lanes.

Row order follows the reference exactly, because it decides which cells
``max_points`` drops, the centroids' row order and which points the grid
searcher's ``max_per_cell`` truncates: the grid uses a stable argsort of the
cell ids, the downsample three stable sorts from the minor coordinate to the
major one (``jnp.lexsort``). Centroid sums are deterministic: a float64
prefix sum along the sorted rows (a sequential scan per column, no atomics),
differenced at each cell's first and last row.

The voxel size is held as a 0-d tensor on the cloud's device: on the card a
division by a CPU scalar is computed as a product with its reciprocal, which
would move cell boundaries by an ulp against the CPU.

Semantics kept from the reference: stored points outside the lattice clip
into the boundary cells; queries resolve with ``cell_coords(..., clip=False)``
so an out-of-lattice query sees an honest empty neighbourhood.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.data.collate import PAD_SENTINEL

_INT_LIMIT = 2.0 ** 30  # float pre-clamp before the int32 cast
_TAIL_CELL = 2 ** 30    # downsample cell coordinate of invalid rows


class VoxelGrid(NamedTuple):
    """Sorted counting-sort grid over one cloud or a batch of clouds.

    ``points``/``point_ids`` are the cloud reordered by linearised cell id
    (invalid rows sort to the tail and are unreachable through the tables);
    ``start``/``count`` are dense per-cell tables of length ``prod(dims)``.
    Every tensor may carry a leading batch dimension; ``dims`` is a Python
    tuple shared by all lanes.
    """

    points: torch.Tensor      # (..., M, 3) f32, sorted by cell id
    point_ids: torch.Tensor   # (..., M) i32: original row of each point
    start: torch.Tensor       # (..., C) i32: first sorted row of each cell
    count: torch.Tensor       # (..., C) i32: valid points in each cell
    origin: torch.Tensor      # (..., 3) f32: corner of cell [0, 0, 0]
    voxel_size: torch.Tensor  # 0-d f32 on the grid's device
    dims: tuple[int, int, int]

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def _dims_tensor(dims, device) -> torch.Tensor:
    return torch.tensor(dims, dtype=torch.int32, device=device)


def cell_coords(points: torch.Tensor, origin: torch.Tensor,
                voxel_size: torch.Tensor, dims: tuple[int, int, int], *,
                clip: bool = True) -> torch.Tensor:
    """(..., N, 3) points, (..., 3) origin -> (..., N, 3) int32 cell coords.

    ``clip=True`` (the build-time convention) clips into ``dims``;
    ``clip=False`` keeps out-of-range coordinates so queries can detect
    that they left the lattice. The float coordinate is first clamped to
    +-2^30 so far sentinels (1e6 pads, 1e15 mask coordinates) stay ordinary
    out-of-range integers.
    """
    ic = torch.floor((points - origin.unsqueeze(-2)) / voxel_size)
    ic = ic.clamp(-_INT_LIMIT, _INT_LIMIT).to(torch.int32)
    if clip:
        hi = _dims_tensor(dims, ic.device) - 1
        ic = torch.minimum(ic.clamp_min(0), hi)
    return ic


def linear_cell_ids(ic: torch.Tensor, dims: tuple[int, int, int]
                    ) -> torch.Tensor:
    """(..., 3) lattice coords -> (...,) linearised ids (row-major, z
    fastest)."""
    _, ny, nz = dims
    return (ic[..., 0] * ny + ic[..., 1]) * nz + ic[..., 2]


def _default_origin(points: torch.Tensor, valid: torch.Tensor | None,
                    v: torch.Tensor) -> torch.Tensor:
    """The valid-point minimum less half a voxel, snapped down to the
    lattice, so boundary points never land at a negative coordinate."""
    if valid is not None:
        points = torch.where(valid[..., None], points, float("inf"))
    lo = points.amin(-2) - 0.5 * v
    return torch.floor(lo / v) * v


def _take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[..., order, :]`` per lane for (..., M, C) ``x``."""
    return x.gather(-2, order[..., None].expand(*order.shape, x.shape[-1]))


def voxel_downsample(points: torch.Tensor, voxel_size, *, max_points: int,
                     valid: torch.Tensor | None = None,
                     origin: torch.Tensor | None = None,
                     with_stats: bool = False):
    """Centroid voxel downsample with static output capacity.

    Args:
      points: (..., M, 3) cloud(s).
      voxel_size: cell edge length in metres.
      max_points: output capacity. Occupied cells beyond it are dropped in
        cell order (highest cell coordinates first).
      valid: optional (..., M) bool; invalid rows join no centroid.
      origin: optional (..., 3) lattice anchor (default: the valid minimum
        snapped to the lattice).
      with_stats: also return the number of occupied cells that did not
        fit the capacity.

    Returns:
      ``(centroids, out_valid[, dropped])``: (..., max_points, 3) f32 with
      ``PAD_SENTINEL`` in invalid rows, (..., max_points) bool, and (...)
      int32.
    """
    m = points.shape[-2]
    lead = points.shape[:-2]
    cap = min(int(max_points), m)
    pts = points.to(torch.float32)
    dev = pts.device
    v = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    if origin is None:
        origin = _default_origin(pts, valid, v)
    ic = torch.floor((pts - origin.unsqueeze(-2)) / v).to(torch.int32)
    if valid is not None:
        ic = torch.where(valid[..., None], ic, _TAIL_CELL)
    # jnp.lexsort((z, y, x)): stable sorts from the minor key to the major.
    order = torch.arange(m, device=dev).expand(lead + (m,))
    for axis in (2, 1, 0):
        key = ic[..., axis].gather(-1, order)
        order = order.gather(-1, torch.argsort(key, dim=-1, stable=True))
    ics = _take_rows(ic, order)
    vs = (valid.gather(-1, order) if valid is not None
          else torch.ones(lead + (m,), dtype=torch.bool, device=dev))
    new_cell = (ics != ics.roll(1, dims=-2)).any(-1)
    new_cell[..., 0] = True
    seg = torch.cumsum(new_cell, -1) - 1  # compacted cell index, int64
    occupied = torch.where(vs, seg, -1).amax(-1) + 1
    dropped = (occupied - cap).clamp_min(0).to(torch.int32)
    # Deterministic segment sums: a float64 running sum of (x, y, z, 1)
    # over the sorted rows, differenced at each cell's row range.
    w = vs.to(torch.float64)[..., None]
    acc = torch.cat([_take_rows(pts, order).to(torch.float64) * w, w], -1)
    acc = torch.cat([acc.new_zeros(lead + (1, 4)), torch.cumsum(acc, -2)],
                    -2)
    cells = torch.arange(cap, device=dev).expand(lead + (cap,)).contiguous()
    lo = torch.searchsorted(seg, cells)
    hi = torch.searchsorted(seg, cells, right=True)
    sums = (_take_rows(acc, hi) - _take_rows(acc, lo)).to(torch.float32)
    cnt = sums[..., 3]
    out_valid = cnt > 0
    centroids = sums[..., :3] / cnt.clamp_min(1.0)[..., None]
    centroids = torch.where(out_valid[..., None], centroids, PAD_SENTINEL)
    if cap < int(max_points):  # honour the requested static capacity
        pad = int(max_points) - cap
        centroids = torch.cat([centroids, centroids.new_full(
            lead + (pad, 3), PAD_SENTINEL)], -2)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(lead + (pad,))],
                              -1)
    if with_stats:
        return centroids, out_valid, dropped
    return centroids, out_valid


def build_voxel_grid(points: torch.Tensor, voxel_size,
                     dims: tuple[int, int, int], *,
                     valid: torch.Tensor | None = None,
                     origin: torch.Tensor | None = None) -> VoxelGrid:
    """Counting-sort voxel grid over (..., M, 3) ``points`` (once per frame).

    ``origin`` defaults to the valid-point minimum snapped to the lattice,
    so a lattice of ``dims * voxel_size`` metres anchored at the cloud
    covers the scene. Invalid rows get the tail id ``prod(dims)``: they sort
    last and no table entry reaches them.
    """
    dims = tuple(int(d) for d in dims)
    num_cells = dims[0] * dims[1] * dims[2]
    pts = points.to(torch.float32)
    dev = pts.device
    v = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    if origin is None:
        origin = _default_origin(pts, valid, v)
    ids = linear_cell_ids(cell_coords(pts, origin, v, dims), dims)
    if valid is not None:
        ids = torch.where(valid, ids, num_cells)
    order = torch.argsort(ids, dim=-1, stable=True)
    # Integer counts: exact in any order, so the scatter is deterministic.
    count = ids.new_zeros(ids.shape[:-1] + (num_cells + 1,),
                          dtype=torch.int64)
    count.scatter_add_(-1, ids.to(torch.int64), torch.ones_like(
        ids, dtype=torch.int64))
    count = count[..., :num_cells]
    start = torch.cumsum(count, -1) - count
    return VoxelGrid(points=_take_rows(pts, order),
                     point_ids=order.to(torch.int32),
                     start=start.to(torch.int32), count=count.to(torch.int32),
                     origin=origin.to(torch.float32), voxel_size=v, dims=dims)
