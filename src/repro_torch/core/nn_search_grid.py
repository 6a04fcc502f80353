"""Grid-bucketed nearest-neighbour search (port of
``repro.core.nn_search_grid``).

Each query scans only the (2·rings+1)³ neighbourhood of its voxel, gathered
through the counting-sort tables of :class:`repro_torch.data.voxelize.VoxelGrid`:
O(27·K) candidates per query instead of O(M), with ``K = max_per_cell``.

Exactness contract (the reference's): when the true nearest neighbour lies
within ``rings * voxel_size`` of the query and its cell did not overflow
``max_per_cell``, the result equals the exact searcher's. Overflowing cells
keep their first ``max_per_cell`` points in stable original order. A query
with an empty neighbourhood gets ``d2 = +inf`` and index 0, or, with
``exact_fallback=True``, a brute-force answer. Queries outside the lattice
keep their unclipped cell, so only lattice cells their window really
overlaps contribute.

Everything takes an optional leading batch dimension: src (..., N, 3)
against a grid built from (..., M, 3).
"""
from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from repro_torch.data.voxelize import VoxelGrid, cell_coords, linear_cell_ids
from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel

# Far-but-finite coordinate of masked candidate slots: d2 ~ 1e30 stays
# inside fp32 and never wins against a metric-scale candidate.
_MASK_COORD = 1.0e15

# The resident grid of a full-resolution search (the pyramid's polish, the
# fused iteration): 128 m x 128 m x 32 m at 1 m cells, anchored per cloud.
DEFAULT_GRID_DIMS: tuple[int, int, int] = (128, 128, 32)


def grid_voxel_size(gate: float, grid_voxel: float | None = None) -> float:
    """Cell size of a resident grid: ``grid_voxel``, else ``max(1, gate)``,
    so that every gate-passing correspondence lies in the 27-cell
    neighbourhood and is found exactly."""
    return float(grid_voxel) if grid_voxel is not None else max(1.0, gate)


class GridQueryStats(NamedTuple):
    """Diagnostics of one candidate gather, (...) f32 per lane.

    ``overflow_frac``: queries with a neighbour cell truncated by
    ``max_per_cell``. ``empty_frac``: queries with an empty neighbourhood
    (the rows that come back ``d2 = inf``). ``dropped_frac``: truncated
    candidates over all candidates the neighbourhoods hold.
    ``out_of_lattice``: queries whose own cell lies outside ``dims``.
    """

    overflow_frac: torch.Tensor
    empty_frac: torch.Tensor
    dropped_frac: torch.Tensor
    out_of_lattice: torch.Tensor


@functools.cache
def _neighbor_offsets(rings: int) -> tuple:
    """(2r+1)³ neighbourhood offsets, x major; rings=1 is the 27-cell case."""
    span = range(-rings, rings + 1)
    return tuple(itertools.product(span, span, span))


def _lane_take(table: torch.Tensor, idx: torch.Tensor,
               nlead: int) -> torch.Tensor:
    """``table[b, idx[b]]`` per lane, with int32 indices.

    ``table`` is (*lead, L) or (*lead, L, C) with ``nlead`` lane dimensions,
    ``idx`` (*lead, ...) int32; the result has ``idx.shape`` (+ (C,)). The
    lane offsets b·L stay in int32: 8 lanes of 524,288 cells or 131,072
    points are far below 2^31.
    """
    lead = table.shape[:nlead]
    rows = table.shape[nlead]
    flat = table.reshape((-1,) + table.shape[nlead + 1:])
    if nlead:
        lanes = torch.arange(flat.shape[0] // rows, dtype=torch.int32,
                             device=idx.device) * rows
        idx = idx + lanes.view(lead + (1,) * (idx.dim() - nlead))
    out = flat.index_select(0, idx.reshape(-1))
    return out.view(idx.shape + flat.shape[1:])


def _neighbourhood(src: torch.Tensor, grid: VoxelGrid, rings: int):
    """(cell ids (..., N, C) clipped into the lattice, in-bounds mask,
    query cell coords (..., N, 3), dims tensor)."""
    dims = grid.dims
    dims_t = torch.tensor(dims, dtype=torch.int32, device=src.device)
    icq = cell_coords(src.to(torch.float32), grid.origin, grid.voxel_size,
                      dims, clip=False)
    off = torch.tensor(_neighbor_offsets(rings), dtype=torch.int32,
                       device=src.device)
    nbr = icq[..., None, :] + off                            # (..., N, C, 3)
    in_bounds = ((nbr >= 0) & (nbr < dims_t)).all(-1)
    cid = linear_cell_ids(torch.minimum(nbr.clamp_min(0), dims_t - 1), dims)
    return cid, in_bounds, icq, dims_t


def _gather(src: torch.Tensor, grid: VoxelGrid, max_per_cell: int,
            rings: int):
    """Candidate coordinates and where they came from.

    Returns ``(cand_pts, pos, cand_valid, start, kept)``: (..., N, C·K, 3)
    f32 with masked slots at ``_MASK_COORD``; (..., N, C·K) int32 sorted-row
    positions (0 where masked) and bool validity; (..., N, C) int32 first
    sorted row and kept count of each neighbour cell. Slot ``c·K + k`` holds
    row ``start[c] + k``.
    """
    cid, in_bounds, _, _ = _neighbourhood(src, grid, rings)
    nlead = grid.start.dim() - 1
    start = _lane_take(grid.start, cid, nlead)
    kept = torch.where(in_bounds, _lane_take(grid.count, cid,
                                             nlead).clamp_max(max_per_cell), 0)
    k = torch.arange(max_per_cell, dtype=torch.int32, device=src.device)
    cand_valid = k < kept[..., None]                          # (..., N, C, K)
    pos = torch.where(cand_valid, start[..., None] + k, 0)
    pos, cand_valid = pos.flatten(-2), cand_valid.flatten(-2)
    cand_pts = _lane_take(grid.points, pos, nlead)
    # In place: cand_pts is a fresh tensor, the largest of the gather.
    cand_pts.masked_fill_(~cand_valid[..., None], _MASK_COORD)
    return cand_pts, pos, cand_valid, start, kept


def grid_order(grid: VoxelGrid, values: torch.Tensor) -> torch.Tensor:
    """Per-point ``values`` (..., M, C) of the grid's cloud, in original
    order, put in the grid's sorted order (row ``i`` is point
    ``grid.point_ids[i]``): the ``payload`` of
    :func:`gather_candidate_points`."""
    return _lane_take(values, grid.point_ids, grid.start.dim() - 1)


def gather_candidate_points(src: torch.Tensor, grid: VoxelGrid,
                            max_per_cell: int, rings: int = 1,
                            payload: torch.Tensor | None = None):
    """The (..., N, C·K, 3) candidate coordinates of
    :func:`gather_candidates` alone, for passes that carry the winner's
    coordinates and need no target index (the fused moment pass).

    With ``payload`` (..., M, C) in the grid's sorted order
    (:func:`grid_order`), also the (..., N, C·K, C) payload rows of the
    same slots, 0 where masked: ``(cand_pts, cand_payload)``.
    """
    cand_pts, pos, cand_valid, _, _ = _gather(src, grid, max_per_cell, rings)
    if payload is None:
        return cand_pts
    cand_payload = _lane_take(payload, pos, grid.start.dim() - 1)
    cand_payload.masked_fill_(~cand_valid[..., None], 0.0)
    return cand_pts, cand_payload


def gather_candidates(src: torch.Tensor, grid: VoxelGrid, max_per_cell: int,
                      rings: int = 1):
    """Each query's neighbourhood candidate set.

    Returns ``(cand_pts, cand_idx, cand_valid)``: (..., N, C·K, 3) f32,
    (..., N, C·K) int32 and (..., N, C·K) bool with C = (2·rings+1)³.
    Masked slots carry ``_MASK_COORD`` coordinates (so an argmin may skip
    the mask) and index 0 before the id map; ``cand_idx`` is in the
    original target order.
    """
    cand_pts, pos, cand_valid, _, _ = _gather(src, grid, max_per_cell, rings)
    cand_idx = _lane_take(grid.point_ids, pos, grid.start.dim() - 1)
    return cand_pts, cand_idx, cand_valid


def neighborhood_stats(src: torch.Tensor, grid: VoxelGrid,
                       max_per_cell: int = 32,
                       rings: int = 1) -> GridQueryStats:
    """What :func:`gather_candidates` would drop for these queries: table
    lookups only, cheap enough to log per frame."""
    cid, in_bounds, icq, dims_t = _neighbourhood(src, grid, rings)
    cnt = torch.where(in_bounds, _lane_take(grid.count, cid,
                                            grid.count.dim() - 1), 0)
    kept = cnt.clamp_max(max_per_cell)
    dropped = (cnt - kept).sum(-1).to(torch.float32)
    total = cnt.sum(-1).to(torch.float32)
    n = float(src.shape[-2])
    in_lattice = ((icq >= 0) & (icq < dims_t)).all(-1)
    return GridQueryStats(
        overflow_frac=(cnt > max_per_cell).any(-1).sum(-1) / n,
        empty_frac=(kept.sum(-1) == 0).sum(-1) / n,
        dropped_frac=dropped.sum(-1) / total.sum(-1).clamp_min(1.0),
        out_of_lattice=(~in_lattice).sum(-1) / n)


def take_slot(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Row ``slot`` of each query's candidate axis: (..., N, CK[, 3]),
    (..., N) -> (..., N[, 3])."""
    index = slot.long()[..., None]
    if x.dim() > slot.dim() + 1:
        return x.gather(-2, index[..., None].expand(
            *slot.shape, 1, x.shape[-1]))[..., 0, :]
    return x.gather(-1, index)[..., 0]


def nn_search_grid(src: torch.Tensor, grid: VoxelGrid, *,
                   max_per_cell: int = 32, rings: int = 1,
                   exact_fallback: bool = False,
                   dst: torch.Tensor | None = None,
                   dst_valid: torch.Tensor | None = None,
                   chunk: int = 2048, return_points: bool = False,
                   with_stats: bool = False):
    """NN of each src point among its grid-neighbourhood candidates.

    The candidate sweep is ``kernels.nn_search_grid.candidate_sweep_kernel``:
    the CUDA kernel on CUDA tensors, its plain version on CPU tensors. Its
    d² is the direct form of the plain version, bit for bit, so it is the
    winner's exact squared distance. Only the winning slot is mapped back
    to its target row (``start[c] + k`` for slot ``c·K + k``); empty
    neighbourhoods are read from the kept counts.

    Args:
      src: (..., N, 3) queries; grid: the target's :func:`build_voxel_grid`.
      max_per_cell / rings: see :func:`gather_candidates`.
      exact_fallback: brute-force rows whose neighbourhood is empty (needs
        ``dst``). The reference's ``lax.cond`` becomes a Python ``if`` on
        ``bool(any(empty))``: one host sync per call, and the full sweep
        runs only when such a row exists.
      dst / dst_valid / chunk: fallback inputs, as for ``core.nn_search``.
      return_points: also return the matched points.
      with_stats: also return the :class:`GridQueryStats`.

    Returns:
      ``(d2, idx[, matched][, stats])``: (..., N) f32 exact squared
      distances (+inf for empty neighbourhoods without fallback), (..., N)
      int32 indices into the original target order.
    """
    cand_pts, _, _, start, kept = _gather(src, grid, max_per_cell, rings)
    srcf = src.to(torch.float32)
    best_d2, slot = candidate_sweep_kernel(srcf, cand_pts)
    matched = take_slot(cand_pts, slot)
    has_cand = (kept > 0).any(-1)
    cell = torch.div(slot, max_per_cell, rounding_mode="floor")
    pos = take_slot(start, cell) + slot - cell * max_per_cell
    best_idx = _lane_take(grid.point_ids, torch.where(has_cand, pos, 0),
                          grid.start.dim() - 1)
    best_d2 = torch.where(has_cand, best_d2, float("inf"))
    best_idx = torch.where(has_cand, best_idx, 0)
    if exact_fallback:
        if dst is None:
            raise ValueError("exact_fallback=True requires dst")
        if bool((~has_cand).any()):  # host sync
            from repro_torch.core.nn_search import nn_search
            fb_d2, fb_idx, fb_pts = nn_search(srcf, dst, chunk=chunk,
                                              dst_valid=dst_valid,
                                              return_points=True)
            best_d2 = torch.where(has_cand, best_d2, fb_d2)
            best_idx = torch.where(has_cand, best_idx, fb_idx)
            matched = torch.where(has_cand[..., None], matched,
                                  fb_pts.to(torch.float32))
    out = [best_d2.clamp_min(0.0), best_idx]
    if return_points:
        out.append(matched)
    if with_stats:
        out.append(neighborhood_stats(src, grid, max_per_cell, rings))
    return tuple(out)


def grid_nn_fn(grid: VoxelGrid, *, max_per_cell: int = 32, rings: int = 1):
    """Resident-grid searcher with the ``core.icp`` ``nn_fn`` contract: the
    grid is built once per frame and closed over; the returned function
    ignores its second argument and returns the 3-tuple
    ``(d2, idx, matched)``."""

    def nn_fn(src, _target=None):
        return nn_search_grid(src, grid, max_per_cell=max_per_cell,
                              rings=rings, return_points=True)

    return nn_fn
