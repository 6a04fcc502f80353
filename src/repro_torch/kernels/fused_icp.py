"""Wrapper of the fused ICP kernel (port of ``repro.kernels.fused_icp``).

One fused pass per ICP iteration: the grid candidate sweep, the winner's
exact d², the distance gate, the ``src_valid`` mask, the huber/tukey IRLS
weight and the moment planes per query, then one sum per plane:

  * point-to-point, 18 planes (``P2P_MOMENTS``); the host epilogue
    (``core.transform.estimate_from_moments`` and ``rmse_from_moments``)
    turns the sums into the rigid step and the RMSE;
  * point-to-plane, 45 planes (``P2PLANE_MOMENTS``): the winner's normal is
    taken from the candidate normals at the winning slot, the weight is on
    the plane residual, and the 6x6 normal equations come out of the sums
    (``core.point_to_plane.solve_normal_equations``).

``prune=True`` adds the bf16 candidate screen at ``gate * ref.PRUNE_MARGIN``;
a within-gate candidate always passes it, so the planes are the same bits
with and without it (``kernels.ref.fused_moment_planes``).

:func:`moment_planes` (called by :func:`fused_moment_sweep`) dispatches on
the device of its tensors:

  * CPU tensors: the plain version, :func:`repro_torch.kernels.ref.fused_moment_planes`;
  * CUDA tensors: the hand-written kernel ``csrc/fused_icp.cu``, or an
    error. There is no fallback from the card to the plain version.

Either way the (..., P, N) planes are summed over N with ``torch.sum``
(no float atomics, the same sums from run to run).
``fused_moment_sweep.launches`` counts the kernel's launches.

:class:`FusedConfig` is the kernel's launch setting, the axes that the
autotune sweep (``repro_torch.tools.autotune_fused``) ranks: warps (one a
query) per block, and the prune. It replaces the reference's TPU tiles
``bn``/``bc``. Every setting gives the same bits. :func:`fused_resources`
(the counterpart of the reference's VMEM model ``fused_vmem_bytes``) and
:func:`fused_cost_model` are the Table II analogue on the H100.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.nn_search_grid import (DEFAULT_GRID_DIMS,
                                             gather_candidate_points,
                                             grid_order, grid_voxel_size)
from repro_torch.data.voxelize import VoxelGrid, build_voxel_grid
from repro_torch.kernels import build, ref
from repro_torch.kernels.nn_search_grid import check_candidates

# Moment-plane order (the kernel's output contract).
_RMSE_BLOCK = (
    "px", "py", "pz", "qx", "qy", "qz",
    "pq00", "pq01", "pq02", "pq10", "pq11", "pq12",
    "pq20", "pq21", "pq22", "pp", "qq",
)
_AA = tuple(f"a{k}{li}" for k in range(6) for li in range(k, 6))  # 21
_RA = tuple(f"ra{k}" for k in range(6))
P2P_MOMENTS = ("w",) + _RMSE_BLOCK                         # 18 planes
P2PLANE_MOMENTS = ("w",) + _AA + _RA + _RMSE_BLOCK         # 45 planes


def moment_names(plane: bool) -> tuple[str, ...]:
    return P2PLANE_MOMENTS if plane else P2P_MOMENTS


# The warps-per-block values csrc/fused_icp.cu instantiates.
WARPS_PER_BLOCK = (2, 4, 8, 16)


class FusedConfig(NamedTuple):
    """The fused kernel's launch setting: ``warps_per_block`` queries (one
    warp each) a block, one of :data:`WARPS_PER_BLOCK`, and ``prune``, the
    bf16 candidate screen. The defaults are the setting the kernel ran
    with before the sweep existed; ``python -m
    repro_torch.tools.autotune_fused --apply`` says whether the card ranks
    another first. On CPU tensors neither applies: the plain version runs."""

    warps_per_block: int = 8
    prune: bool = False


DEFAULT_CONFIG = FusedConfig()


def _check_warps(warps_per_block: int) -> None:
    if warps_per_block not in WARPS_PER_BLOCK:
        raise ValueError(f"warps_per_block must be one of {WARPS_PER_BLOCK}, "
                         f"got {warps_per_block!r}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("fused_icp")
    lib.fpps_fused.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fpps_fused.restype = ctypes.c_int
    lib.fpps_fused_attributes.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.fpps_fused_attributes.restype = ctypes.c_int
    lib.fpps_fused_planes.argtypes = [ctypes.c_int]
    lib.fpps_fused_planes.restype = ctypes.c_int
    for plane in (False, True):
        if lib.fpps_fused_planes(int(plane)) != len(moment_names(plane)):
            raise RuntimeError("csrc/fused_icp.cu plane count disagrees with "
                               "moment_names")
    return lib


def moment_planes(q: torch.Tensor, cand: torch.Tensor, sv: torch.Tensor,
                  cand_normals: torch.Tensor | None = None, *, gate: float,
                  robust_kernel: str = "none", robust_scale: float = 0.5,
                  prune: bool = False,
                  warps_per_block: int = DEFAULT_CONFIG.warps_per_block
                  ) -> torch.Tensor:
    """Per-query moment planes of the fused pass, (..., P, N) float32 in
    ``moment_names(cand_normals is not None)`` order, for q (..., N, 3),
    cand (..., N, CK, 3), sv (..., N) and cand_normals (..., N, CK, 3)
    float32: the kernel on CUDA tensors (counted in
    ``fused_moment_sweep.launches``) at ``warps_per_block`` queries a
    block, the plain version on CPU tensors."""
    check_candidates(q, cand)
    _check_warps(warps_per_block)
    plane = cand_normals is not None
    if plane and (cand_normals.shape != cand.shape
                  or cand_normals.dtype != torch.float32
                  or cand_normals.device != cand.device):
        raise ValueError(f"cand_normals must be float32 {tuple(cand.shape)} "
                         f"on {cand.device}, got {cand_normals.dtype} "
                         f"{tuple(cand_normals.shape)}")
    kw = dict(gate=gate, robust_kernel=robust_kernel,
              robust_scale=robust_scale, prune=prune)
    if q.device.type == "cpu":
        return ref.fused_moment_planes(q, cand, sv, cand_normals, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no fused moment pass for device {q.device}")
    if sv.shape != q.shape[:-1] or sv.dtype != torch.float32:
        raise ValueError(f"sv must be float32 {tuple(q.shape[:-1])}, got "
                         f"{sv.dtype} {tuple(sv.shape)}")
    q, sv, cand = q.contiguous(), sv.contiguous(), cand.contiguous()
    cand_n = cand_normals.contiguous() if plane else None
    n = q.shape[-2]
    planes = torch.empty(q.shape[:-2] + (len(moment_names(plane)), n),
                         dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fpps_fused(
            q.data_ptr(), sv.data_ptr(), cand.data_ptr(),
            cand_n.data_ptr() if plane else None, planes.data_ptr(),
            q.numel() // 3, n, cand.shape[-2], float(gate) ** 2, int(prune),
            ref.prune_limit(gate),
            ref.ROBUST_CODES[robust_kernel], float(robust_scale),
            max(float(robust_scale), 1e-12), warps_per_block, stream)
    if err != 0:
        raise RuntimeError(f"fused_moment_sweep kernel launch failed: CUDA "
                           f"error {err}")
    fused_moment_sweep.launches += 1
    return planes


def fused_moment_sweep(q: torch.Tensor, cand: torch.Tensor,
                       src_valid: torch.Tensor | None = None,
                       cand_normals: torch.Tensor | None = None, *,
                       gate: float, robust_kernel: str = "none",
                       robust_scale: float = 0.5, prune: bool = False,
                       warps_per_block: int = DEFAULT_CONFIG.warps_per_block
                       ) -> dict:
    """One fused candidate pass: NN min + gate + IRLS weight + moments.

    Args:
      q: (..., N, 3) transformed source points (the iteration's queries).
      cand: (..., N, CK, 3) candidate coordinates (masked slots = sentinel).
      src_valid: optional (..., N) bool/float mask; invalid rows weigh 0.
      cand_normals: (..., N, CK, 3) candidate normals, invalid slots 0; they
        select the point-to-plane moment set.
      gate / robust_kernel / robust_scale: the ``ICPParams`` weighting.
      prune: the bf16 candidate screen at ``gate * ref.PRUNE_MARGIN``.
      warps_per_block: the kernel's queries a block (:class:`FusedConfig`).

    Returns:
      dict mapping ``moment_names(plane)`` to (...) float32 sums over the N
      queries.
    """
    if robust_kernel not in ref.ROBUST_CODES:
        raise ValueError(f"unknown robust kernel {robust_kernel!r}")
    sv = (torch.ones(q.shape[:-1], dtype=torch.float32, device=q.device)
          if src_valid is None else src_valid.to(torch.float32))
    planes = moment_planes(q, cand, sv, cand_normals, gate=gate,
                           robust_kernel=robust_kernel,
                           robust_scale=robust_scale, prune=prune,
                           warps_per_block=warps_per_block)
    sums = planes.sum(-1)
    names = moment_names(cand_normals is not None)
    return {name: sums[..., k] for k, name in enumerate(names)}


fused_moment_sweep.launches = 0


class PointMoments(NamedTuple):
    """Σ-moments of one point-to-point iteration, with the batch's leading
    dimensions."""
    sw: torch.Tensor   # Σw
    sp: torch.Tensor   # (..., 3) Σw·p
    sq: torch.Tensor   # (..., 3) Σw·q
    spq: torch.Tensor  # (..., 3, 3) Σw·p⊗q (raw, uncentred)
    spp: torch.Tensor  # Σw·|p|²
    sqq: torch.Tensor  # Σw·|q|²


class PlaneMoments(NamedTuple):
    """Σ-moments of one point-to-plane iteration, with the batch's leading
    dimensions."""
    sw: torch.Tensor
    A: torch.Tensor    # (..., 6, 6) Σw·a⊗a, a = [p×n; n]
    b: torch.Tensor    # (..., 6) −Σw·r·a (the Gauss-Newton right-hand side)
    sp: torch.Tensor
    sq: torch.Tensor
    spq: torch.Tensor
    spp: torch.Tensor
    sqq: torch.Tensor


def _assemble(s: dict, plane: bool = False):
    """The sums of :func:`fused_moment_sweep` as :class:`PointMoments` or,
    with ``plane``, :class:`PlaneMoments`."""
    sp = torch.stack([s["px"], s["py"], s["pz"]], -1)
    sq = torch.stack([s["qx"], s["qy"], s["qz"]], -1)
    spq = torch.stack([torch.stack([s[f"pq{i}{j}"] for j in range(3)], -1)
                       for i in range(3)], -2)
    if not plane:
        return PointMoments(sw=s["w"], sp=sp, sq=sq, spq=spq, spp=s["pp"],
                            sqq=s["qq"])
    A = torch.stack([torch.stack([s[f"a{min(k, li)}{max(k, li)}"]
                                  for li in range(6)], -1)
                     for k in range(6)], -2)
    b = -torch.stack([s[f"ra{k}"] for k in range(6)], -1)
    return PlaneMoments(sw=s["w"], A=A, b=b, sp=sp, sq=sq, spq=spq,
                        spp=s["pp"], sqq=s["qq"])


def make_fused_fn(grid: VoxelGrid, params, target_normals=None, *,
                  max_per_cell: int = 32, rings: int = 1,
                  config: FusedConfig = DEFAULT_CONFIG):
    """Resident-grid fused iteration: ``fused_fn(src_t, src_valid)`` ->
    :class:`PointMoments`, or :class:`PlaneMoments` for the point-to-plane
    minimiser.

    The voxel grid is built once per frame and closed over; each iteration
    runs the candidate gather and one fused pass. Point-to-point gathers
    coordinates only (the pass carries the winner's coordinates and needs no
    target index). Point-to-plane needs ``target_normals`` (..., M, 3) of
    the grid's cloud (invalid rows 0): they are put in the grid's sorted
    order once here and gathered with the coordinates each iteration.
    ``params`` is a ``core.icp.ICPParams`` (gate, minimiser and robust
    fields), ``config`` the kernel's launch setting and prune.
    """
    _check_warps(config.warps_per_block)
    plane = params.minimizer == "point_to_plane"
    if plane and target_normals is None:
        raise ValueError("minimizer='point_to_plane' needs target_normals "
                         "for the fused iteration (the kernel takes the "
                         "winner's normal from the candidate normals)")
    sorted_normals = (grid_order(grid, target_normals.to(torch.float32))
                      if plane else None)

    def fused_fn(src_t: torch.Tensor, src_valid: torch.Tensor | None = None):
        cand = gather_candidate_points(src_t, grid, max_per_cell, rings,
                                       payload=sorted_normals)
        cand_pts, cand_n = cand if plane else (cand, None)
        sums = fused_moment_sweep(
            src_t.to(torch.float32), cand_pts, src_valid, cand_n,
            gate=params.max_correspondence_distance,
            robust_kernel=params.robust_kernel,
            robust_scale=params.robust_scale, prune=config.prune,
            warps_per_block=config.warps_per_block)
        return _assemble(sums, plane)

    return fused_fn


def default_fused_fn(target: torch.Tensor, params, *,
                     dst_valid: torch.Tensor | None = None,
                     target_normals: torch.Tensor | None = None,
                     config: FusedConfig = DEFAULT_CONFIG):
    """The fused iteration for a raw (..., M, 3) target: a counting-sort
    grid over ``DEFAULT_GRID_DIMS`` with voxel ``max(1, gate)``
    (``core.nn_search_grid.grid_voxel_size``: every gate-passing
    correspondence is found), then :func:`make_fused_fn` with
    ``target_normals`` for the point-to-plane minimiser. The reference's
    grid and tile kwargs have no caller here and are not ported."""
    grid = build_voxel_grid(
        target.to(torch.float32),
        grid_voxel_size(params.max_correspondence_distance),
        DEFAULT_GRID_DIMS, valid=dst_valid)
    return make_fused_fn(grid, params, target_normals, config=config)


# -- resource and cost models (the reference's Table II analogue) -----------

def fused_resources(config: FusedConfig = DEFAULT_CONFIG, *,
                    plane: bool = False, ck: int = 27 * 32,
                    device=None) -> dict:
    """What one launch setting of the fused kernel takes (the counterpart
    of the reference's VMEM model ``fused_vmem_bytes``).

    The numbers ``csrc/fused_icp.cu`` fixes: threads and queries a block,
    the planes, the bytes a warp reads per query (its ``ck``-slot candidate
    row, the query, its mask and, for point-to-plane, the winner's normal)
    and writes (one fp32 a plane), and the static shared bytes (none: the
    warp's argmin runs in shuffles). With a CUDA ``device`` also ``card``:
    the compiled instantiation's registers, local (spill) bytes, static
    shared bytes, resident blocks per SM and occupancy there
    (:func:`repro_torch.kernels.build.kernel_attributes`); any other device
    raises, since the attributes are the card's.
    """
    _check_warps(config.warps_per_block)
    planes = len(moment_names(plane))
    out = dict(warps_per_block=config.warps_per_block,
               prune=bool(config.prune), plane=bool(plane),
               threads_per_block=32 * config.warps_per_block,
               queries_per_block=config.warps_per_block, planes=planes,
               read_bytes_per_query=12 * ck + 12 + 4 + (12 if plane else 0),
               write_bytes_per_query=4 * planes, static_shared_bytes=0)
    if device is not None:
        out["card"] = build.kernel_attributes(
            lambda res: _library().fpps_fused_attributes(
                config.warps_per_block, int(plane), int(config.prune), res),
            threads=out["threads_per_block"], device=device)
    return out


def fused_cost_model(n: int, ck: int, *, plane: bool = False) -> dict:
    """FLOP and HBM-byte totals of one iteration over ``n`` queries of
    ``ck`` candidate slots: the fused pass against the separate chain
    (candidate sweep, winner gather, gate and weight, moments), each with
    its terms.

    The reference's formulas (``repro.kernels.fused_icp.fused_cost_model``)
    where the port does the same work: the distances (8 FLOP a slot), the
    epilogue (60 or 160 FLOP a query), the candidate gather's write, the
    queries and masks, the plane write, the chain's sweep outputs and its
    eager passes. Where the counts differ:

      * the port picks the winner by its slot, not by one-hot selects, so
        it has none of the reference's ``(2 + 3 or 6)·n·ck`` select FLOP;
      * its (P, N) planes are summed by ``torch.sum`` outside the kernel:
        ``P·n`` FLOP and a re-read of the planes (``plane_sum``);
      * the point-to-plane kernel reads the candidate coordinates and the
        winner's normal (12 bytes a query), not all six gathered planes;
      * the chain's winner gather reads the ``n`` winning rows (and, for
        point-to-plane, their normals), not the candidate matrix again,
        and its gather writes coordinates only.
    """
    planes = len(moment_names(plane))
    coord_bytes = 3 * n * ck * 4
    cand_bytes = (6 if plane else 3) * n * ck * 4
    dist_flops = 8 * n * ck
    epilogue_flops = (160 if plane else 60) * n
    fused = dict(
        flops_terms=dict(distance=dist_flops, epilogue=epilogue_flops,
                         plane_sum=planes * n),
        bytes_terms=dict(gather_write=cand_bytes,
                         candidate_read=coord_bytes + (12 * n if plane
                                                       else 0),
                         queries=4 * n * 4, planes_write=planes * n * 4,
                         plane_sum=planes * n * 4))
    chain = dict(
        flops_terms=dict(distance=dist_flops, epilogue=epilogue_flops,
                         covariance=2 * 3 * n * 3),
        bytes_terms=dict(gather_write=coord_bytes, candidate_read=coord_bytes,
                         queries=3 * n * 4,
                         sweep_out=2 * (n * 4 + n * 4),
                         winner_gather=2 * 12 * n * (2 if plane else 1),
                         passes=6 * (3 * n * 4)))
    for d in (fused, chain):
        d["flops"] = sum(d["flops_terms"].values())
        d["hbm_bytes"] = sum(d["bytes_terms"].values())
        d["flop_per_byte"] = d["flops"] / d["hbm_bytes"]
    return {"fused": fused, "chain": chain,
            "hbm_ratio": chain["hbm_bytes"] / fused["hbm_bytes"]}
