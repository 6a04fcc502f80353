"""Per-point surface normals over voxel-grid neighbourhoods (port of
``repro.data.normals``).

The point-to-plane minimiser needs a unit normal per target point: fit a
plane to each point's neighbourhood and take its normal.

  * Neighbourhoods come from the counting-sort grid
    (``data.voxelize.build_voxel_grid``) through the grid searcher's
    candidate gather (``core.nn_search_grid``): (2·rings+1)³·K candidates
    per point, never O(M).
  * The moments are taken in query-relative coordinates (``x - p``), which
    avoids the cancellation of raw moments at scene scale (coordinates
    ~50 m, covariances ~voxel²).
  * The smallest-variance axis comes from the port's 3x3 Jacobi SVD
    (``core.svd3x3``), batched over every row at once.
  * Invalid rows (too few neighbours, padded rows, degenerate
    neighbourhoods) get a **zero** normal and ``False`` validity; a zero
    normal adds nothing to the point-to-plane normal equations.

Two neighbourhood modes:

  * ``"knn"`` (default): the k nearest candidates. The reference's
    ``lax.top_k(-d2, k)`` puts equal distances lower slot first;
    ``torch.topk`` promises no order on ties, so the port takes the first
    k of a *stable* ascending sort. Rows are swept ``params.chunk`` at a
    time, so the live candidate tensor is (..., chunk, 27·K, 3).
  * ``"radius"``: every candidate within ``radius`` metres, through
    ``kernels.normals.moment_sweep`` in one call: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors. The reference's XLA radius
    path and its Pallas kernel are one path here.

Every function takes an optional leading batch dimension: points (B, N, 3)
with a batched grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.nn_search_grid import gather_candidate_points
from repro_torch.core.svd3x3 import svd3x3
from repro_torch.data.voxelize import VoxelGrid, build_voxel_grid
from repro_torch.kernels.normals import moment_sweep

# Candidate slots whose d2 exceeds this are sentinel slots (their
# coordinates sit at ~1e15; real scene distances are < 1e4 m²).
_SENTINEL_D2 = 1.0e12

# Default lattice, the pyramid's finest-level grid, so one VoxelGrid can
# serve both normal estimation and the grid search.
DEFAULT_GRID_DIMS: tuple[int, int, int] = (128, 128, 32)


class NormalParams(NamedTuple):
    """Normal-estimation settings; same fields and defaults as the
    reference."""

    k: int = 16                    # neighbours per point ("knn" mode)
    radius: float = 1.0            # gate in metres ("radius" mode)
    neighborhood: str = "knn"      # "knn" | "radius"
    voxel_size: float = 1.0        # candidate-grid cell edge
    grid_dims: tuple[int, int, int] = DEFAULT_GRID_DIMS
    max_per_cell: int = 32         # candidate capacity per cell
    rings: int = 1                 # neighbourhood half-width in cells
    min_neighbors: int = 3         # a plane fit needs >= 3 points
    chunk: int = 2048              # query rows per knn sweep


def normal_params_from_reference(d: dict) -> NormalParams:
    """``NormalParams`` from the reference's ``NormalParams._asdict()``.

    Raises ``ValueError`` on a field the port does not know, so a new
    reference setting cannot be dropped silently.
    """
    unknown = sorted(set(d) - set(NormalParams._fields))
    if unknown:
        raise ValueError(f"reference NormalParams fields unknown to the "
                         f"port: {unknown}")
    d = dict(d)
    if "grid_dims" in d:
        d["grid_dims"] = tuple(d["grid_dims"])
    return NormalParams(**d)


def accumulate_moments(rel: torch.Tensor, w: torch.Tensor):
    """Weighted moment sums of query-relative offsets.

    ``rel`` (..., C, 3) offsets ``x_j - p``, ``w`` (..., C) weights ->
    ``(cnt, s, ss)``: (...,) Σw, (..., 3) Σw·rel, (..., 3, 3) Σw·rel·relᵀ.
    Products and sums are elementwise (no matmul, so no TF32).
    """
    wf = w.to(torch.float32)
    relf = rel.to(torch.float32)
    rw = relf * wf[..., None]
    cnt = wf.sum(-1)
    s = rw.sum(-2)
    ss = (rw[..., :, :, None] * relf[..., :, None, :]).sum(-3)
    return cnt, s, ss


def split_moments(m: torch.Tensor):
    """(..., 10) sums in ``kernels.ref.NORMAL_MOMENTS`` order -> ``(cnt, s,
    ss)`` with the symmetric (..., 3, 3) second moments."""
    cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz = m.unbind(-1)
    s = torch.stack([sx, sy, sz], -1)
    ss = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                      torch.stack([sxy, syy, syz], -1),
                      torch.stack([sxz, syz, szz], -1)], -2)
    return cnt, s, ss


def moments_to_normals(cnt: torch.Tensor, s: torch.Tensor, ss: torch.Tensor,
                       *, min_neighbors: int = 3):
    """Moment sums -> ``(normals, valid)`` through the covariance's
    smallest-variance axis.

    The covariance ``E[rel·relᵀ] - mean·meanᵀ`` is shift-invariant, so the
    query-relative sums serve. A row needs ``min_neighbors`` samples and
    spread in two directions: the middle singular value must exceed 1e-5 of
    the largest (relative, since fp32 roundoff leaves ~eps·σ₀² on σ₁ even
    for an exact line). Invalid rows get a zero normal.
    """
    denom = cnt.clamp_min(1.0)
    mean = s / denom[..., None]
    cov = ss / denom[..., None, None] - mean[..., :, None] * mean[..., None, :]
    cov = 0.5 * (cov + cov.mT)
    _, sing, Vt = svd3x3(cov)
    normal = Vt[..., 2, :]
    norm = torch.sqrt((normal * normal).sum(-1, keepdim=True))
    normal = normal / norm.clamp_min(1e-30)
    valid = ((cnt >= min_neighbors) & (sing[..., 0] > 1e-12)
             & (sing[..., 1] > 1e-5 * sing[..., 0]))
    return torch.where(valid[..., None], normal, 0.0), valid


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   viewpoint: torch.Tensor | None = None) -> torch.Tensor:
    """Flip each normal toward ``viewpoint`` (default: the sensor origin),
    PCL's ``flipNormalTowardsViewpoint``."""
    to_vp = -points if viewpoint is None else viewpoint - points
    flip = (normals * to_vp).sum(-1) < 0.0
    return torch.where(flip[..., None], -normals, normals)


def knn_slots(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest of each row of ``d2`` (..., C): their slots, lower
    slot first among equal distances (``lax.top_k(-d2, k)``'s order)."""
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def _knn_moments(points: torch.Tensor, grid: VoxelGrid,
                 params: NormalParams):
    """Moment sums of the k nearest candidates of every row, swept
    ``params.chunk`` rows at a time."""
    parts = []
    for start in range(0, points.shape[-2], params.chunk):
        blk = points[..., start:start + params.chunk, :]
        cand = gather_candidate_points(blk, grid, params.max_per_cell,
                                       params.rings)
        rel = cand - blk[..., None, :]
        d2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
              + rel[..., 2] * rel[..., 2])
        sel = knn_slots(d2, min(params.k, d2.shape[-1]))
        w = d2.gather(-1, sel) < _SENTINEL_D2
        rel_sel = rel.gather(-2, sel[..., None].expand(*sel.shape, 3))
        parts.append(accumulate_moments(rel_sel, w))
    # The row axis of cnt, s and ss.
    return tuple(torch.cat(x, dim=axis)
                 for x, axis in zip(zip(*parts), (-1, -2, -3)))


def _neighborhood_moments(points: torch.Tensor, grid: VoxelGrid,
                          params: NormalParams):
    """``(cnt, s, ss)`` of every row's neighbourhood in ``params``'s mode."""
    if params.neighborhood == "knn":
        return _knn_moments(points, grid, params)
    if params.neighborhood == "radius":
        cand = gather_candidate_points(points, grid, params.max_per_cell,
                                       params.rings)
        return split_moments(moment_sweep(points, cand, params.radius))
    raise ValueError(f"unknown neighborhood {params.neighborhood!r}; "
                     f"expected 'knn' or 'radius'")


def estimate_normals(points: torch.Tensor,
                     params: NormalParams = NormalParams(), *,
                     valid: torch.Tensor | None = None,
                     viewpoint: torch.Tensor | None = None,
                     grid: VoxelGrid | None = None):
    """A unit normal per point of a (..., N, 3) cloud.

    ``valid`` (..., N) marks real rows (padded rows get zero normals and
    ``False``); ``viewpoint`` (3,) orients them (default: the origin);
    ``grid`` is a prebuilt ``build_voxel_grid`` over ``points`` (the
    pyramid's resident grid), built here when absent. Returns
    ``(normals, normal_valid)``: (..., N, 3) float32, zero where invalid,
    and the (..., N) bool mask.
    """
    pts = points.to(torch.float32)
    if grid is None:
        grid = build_voxel_grid(pts, params.voxel_size, params.grid_dims,
                                valid=valid)
    cnt, s, ss = _neighborhood_moments(pts, grid, params)
    normals, nvalid = moments_to_normals(cnt, s, ss,
                                         min_neighbors=params.min_neighbors)
    normals = orient_normals(pts, normals, viewpoint)
    if valid is not None:
        nvalid = nvalid & valid
        normals = torch.where(nvalid[..., None], normals, 0.0)
    return normals, nvalid


def estimate_normals_batch(points: torch.Tensor,
                           params: NormalParams = NormalParams(), *,
                           valid: torch.Tensor | None = None,
                           viewpoint: torch.Tensor | None = None):
    """The reference's batched entry point (a vmap there): normals of a
    (B, N, 3) frame batch in one :func:`estimate_normals` call over the
    batch dimension, with ``valid`` (B, N) defaulting to all rows."""
    if points.dim() != 3:
        raise ValueError(f"points must be (B, N, 3), got "
                         f"{tuple(points.shape)}")
    if valid is None:
        valid = torch.ones(points.shape[:2], dtype=torch.bool,
                           device=points.device)
    return estimate_normals(points, params, valid=valid, viewpoint=viewpoint)


def default_target_normals(target: torch.Tensor,
                           valid: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Target normals at the default settings, for every ICP path that
    estimates them when the plane minimiser runs without explicit normals
    (``core.icp`` and the engines; the pyramid uses its own grid).

    Runs on the true cloud with its true valid mask, before any
    sentinel-masking of padded rows: sentinel rows at 1e6 m would otherwise
    pollute the boundary cells' neighbourhoods.
    """
    return estimate_normals(target, NormalParams(), valid=valid)[0]

