"""Coarse-to-fine ICP pyramid over voxel-downsampled clouds (port of
``repro.core.pyramid``).

  * **Coarse levels.** Both clouds are voxel-downsampled to centroids
    (``data.voxelize.voxel_downsample``) and a few fixed iterations run a
    brute-force search on the small clouds, with the gate widened to
    ``max(gate, 1.5 * voxel)``. The search is the brute-force kernel
    wrapper against the downsampled target (``kernels.ops.resident_nn_fn``;
    invalid centroid rows already carry ``PAD_SENTINEL``): the CUDA kernel
    on the card, its plain version on the CPU. The reference runs XLA's
    brute force there, which computes the same function.
  * **Finest level.** A full-resolution polish over a resident voxel grid
    (``data.voxelize.build_voxel_grid``, built once per frame): each
    iteration runs the grid candidate sweep
    (``core.nn_search_grid.grid_nn_fn``), or with
    ``ICPParams.fused`` the fused moment pass (``kernels.fused_icp``).
    With ``grid_voxel >= max_correspondence_distance`` every gate-passing
    correspondence is found exactly. For the point-to-plane minimiser the
    polish estimates knn target normals once per frame over the same grid
    (``data.normals``); the coarse levels stay point-to-point.

The reference's ``use_kernel`` and ``interpret`` switches have no
counterpart: the device of the tensors decides between a kernel and its
plain version. Every function takes an optional leading batch dimension
(the reference's ``vmap``): a batch of B frames runs each stage as one call,
so a polish iteration is one kernel launch for the whole batch.

Exposed as :func:`icp_pyramid` and as the ``"pyramid"`` engine
(``get_engine("pyramid")``, ``FppsICP(engine="pyramid")``).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import RegistrationEngine, register_engine
from repro_torch.core.icp import (ICPParams, ICPResult, icp,
                                  icp_fixed_iterations, scrub_nonfinite)
from repro_torch.core.nn_search import gather_rows
from repro_torch.core.nn_search_grid import (DEFAULT_GRID_DIMS,
                                             GridQueryStats, grid_nn_fn,
                                             grid_voxel_size,
                                             neighborhood_stats)
from repro_torch.data.voxelize import build_voxel_grid, voxel_downsample
from repro_torch.kernels import build
from repro_torch.kernels.ops import resident_nn_fn

# Coarse schedule entries: (voxel_size_m, iterations[, max_points]). The
# default is one coarse pass, 4 m centroids capped at 8192 points, then the
# full-resolution grid polish.
DEFAULT_LEVELS: tuple = ((4.0, 6, 8192),)
# The finest level's lattice is ``core.nn_search_grid.DEFAULT_GRID_DIMS``,
# imported above and so also ``core.pyramid.DEFAULT_GRID_DIMS``.


def _norm_level(level, cloud_size: int):
    """(voxel, iters[, max_points]) -> (voxel, iters, capacity<=cloud)."""
    if len(level) == 2:
        voxel, iters = level
        cap = cloud_size
    else:
        voxel, iters, cap = level
    return float(voxel), int(iters), min(int(cap), cloud_size)


def icp_pyramid(source: torch.Tensor, target: torch.Tensor,
                params: ICPParams = ICPParams(), *,
                levels: tuple = DEFAULT_LEVELS,
                grid_dims: tuple[int, int, int] = DEFAULT_GRID_DIMS,
                grid_voxel: float | None = None,
                max_per_cell: int = 32, rings: int = 1,
                initial_transform: torch.Tensor | None = None,
                src_valid: torch.Tensor | None = None,
                dst_valid: torch.Tensor | None = None,
                fixed: bool = False) -> ICPResult:
    """Coarse-to-fine ICP: ``levels`` coarse passes, then a
    full-resolution grid polish of ``params.max_iterations`` iterations.

    ``source`` (..., N, 3) and ``target`` (..., M, 3). ``fixed=True`` runs
    the polish for exactly ``max_iterations`` with the freeze mask and no
    host sync (the batch path); otherwise it stops when every lane
    converged. Returns the polish stage's :class:`ICPResult`.
    """
    # Imported here: these modules import the core package.
    from repro_torch.data.normals import NormalParams, estimate_normals
    from repro_torch.kernels.fused_icp import make_fused_fn

    n, m = source.shape[-2], target.shape[-2]
    # Scrub first: a NaN row would poison the lattice origin and every
    # centroid its cell touches.
    source, src_valid = scrub_nonfinite(source, src_valid)
    target, dst_valid = scrub_nonfinite(target, dst_valid)
    T = initial_transform
    for level in levels:
        voxel, iters, cap = _norm_level(level, m)
        src_l, sv_l = voxel_downsample(source, voxel,
                                       max_points=min(cap, n),
                                       valid=src_valid)
        dst_l, _ = voxel_downsample(target, voxel, max_points=cap,
                                    valid=dst_valid)
        # Coarse levels stay point-to-point with no robust weight and no
        # fusion: centroids do not lie on the surfaces they summarise.
        p_l = params._replace(
            max_iterations=iters,
            max_correspondence_distance=max(
                params.max_correspondence_distance, 1.5 * voxel),
            minimizer="point_to_point", robust_kernel="none", fused=False)
        res = icp_fixed_iterations(src_l, dst_l, p_l, initial_transform=T,
                                   nn_fn=resident_nn_fn(dst_l),
                                   src_valid=sv_l)
        T = res.T

    gv = grid_voxel_size(params.max_correspondence_distance, grid_voxel)
    grid = build_voxel_grid(target, gv, grid_dims, valid=dst_valid)
    normals = None
    if params.minimizer == "point_to_plane":
        # One grid serves the search and the normals (knn at the grid's
        # voxel, lattice, capacity and rings).
        np_l = NormalParams(voxel_size=gv, grid_dims=tuple(grid_dims),
                            max_per_cell=max_per_cell, rings=rings)
        normals, _ = estimate_normals(target, np_l, valid=dst_valid,
                                      grid=grid)
    runner = icp_fixed_iterations if fixed else icp
    if params.fused:
        fused_fn = make_fused_fn(grid, params, normals,
                                 max_per_cell=max_per_cell, rings=rings)
        return runner(source, None, params, initial_transform=T,
                      fused_fn=fused_fn, src_valid=src_valid)
    nn_fn = grid_nn_fn(grid, max_per_cell=max_per_cell, rings=rings)

    def correspond(src_t):
        d2, idx, matched = nn_fn(src_t)
        if normals is None:
            return d2, matched
        return d2, matched, gather_rows(normals, idx)

    return runner(source, None, params, initial_transform=T,
                  correspond_fn=correspond, src_valid=src_valid)


def polish_stats(source: torch.Tensor, target: torch.Tensor,
                 params: ICPParams = ICPParams(), *,
                 grid_dims: tuple[int, int, int] = DEFAULT_GRID_DIMS,
                 grid_voxel: float | None = None,
                 max_per_cell: int = 32, rings: int = 1,
                 dst_valid: torch.Tensor | None = None) -> GridQueryStats:
    """Overflow, empty, dropped and out-of-lattice fractions of the polish
    stage's candidate gather for ``source`` against the grid the polish
    would build over ``target``."""
    grid = build_voxel_grid(
        target, grid_voxel_size(params.max_correspondence_distance,
                                grid_voxel), grid_dims, valid=dst_valid)
    return neighborhood_stats(source, grid, max_per_cell, rings)


class PyramidEngine(RegistrationEngine):
    """Coarse-to-fine engine: voxel pyramid + resident-grid finest level.

    Constructor kwargs are hashable, so named ``get_engine("pyramid", ...)``
    instances are shared per process:

      levels:        coarse schedule, ((voxel_m, iters[, max_points]), ...)
      grid_dims:     finest-level lattice extent (cells per axis)
      grid_voxel:    finest-level cell size; None -> max(1.0, gate)
      max_per_cell:  candidate capacity per cell (overflow truncates)
      rings:         neighbourhood half-width in cells

    ``register`` stops once the polish converged (one host sync per
    iteration); ``register_batch`` runs the fixed schedule for the batch.
    """

    name = "pyramid"
    _KERNELS = ("nn_search", "nn_search_grid", "fused_icp")

    def __init__(self, chunk: int = 2048, levels: tuple = DEFAULT_LEVELS,
                 grid_dims: tuple[int, int, int] = DEFAULT_GRID_DIMS,
                 grid_voxel: float | None = None, max_per_cell: int = 32,
                 rings: int = 1, device="cuda"):
        super().__init__(chunk, device)
        self._levels = tuple(tuple(lv) for lv in levels)
        self._grid_dims = tuple(grid_dims)
        self._grid_voxel = grid_voxel
        self._max_per_cell = max_per_cell
        self._rings = rings

    def setup(self) -> None:
        """Initialise the card and build the three kernels (in parallel)."""
        super().setup()
        if self.device.type == "cuda":
            build.build_all(self._KERNELS)

    def _pyramid_kwargs(self) -> dict:
        return dict(levels=self._levels, grid_dims=self._grid_dims,
                    grid_voxel=self._grid_voxel,
                    max_per_cell=self._max_per_cell, rings=self._rings)

    def polish_stats(self, source, target, params: ICPParams | None = None,
                     *, dst_valid=None, device=None) -> GridQueryStats:
        """Candidate-gather diagnostics of this engine's polish stage (see
        :func:`polish_stats`)."""
        params = self._default_params(params)
        dev = self._device(device)
        return polish_stats(
            torch.as_tensor(source, dtype=torch.float32, device=dev),
            torch.as_tensor(target, dtype=torch.float32, device=dev),
            params, grid_dims=self._grid_dims, grid_voxel=self._grid_voxel,
            max_per_cell=self._max_per_cell, rings=self._rings,
            dst_valid=(None if dst_valid is None else torch.as_tensor(
                dst_valid, dtype=torch.bool, device=dev)))

    def _register(self, src, dst, params, T0, sv, dv) -> ICPResult:
        return icp_pyramid(src, dst, params, initial_transform=T0,
                           src_valid=sv, dst_valid=dv,
                           **self._pyramid_kwargs())

    def _register_batch(self, src, dst, params, T0, sv, dv) -> ICPResult:
        return icp_pyramid(src, dst, params, initial_transform=T0,
                           src_valid=sv, dst_valid=dv, fixed=True,
                           **self._pyramid_kwargs())


register_engine("pyramid", PyramidEngine)
