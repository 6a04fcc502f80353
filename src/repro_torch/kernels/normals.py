"""Wrapper of the normals moment-sweep kernel (port of
``repro.kernels.normals``).

``core.nn_search_grid`` materialises each query's neighbourhood as a dense
(..., N, CK, 3) candidate matrix with sentinel slots; :func:`moment_sweep`
reduces it to ten radius-gated moment sums per query, and
``data.normals.moments_to_normals`` turns those into a normal. The device of
the tensors decides what runs:

  * CPU tensors: the plain version, :func:`repro_torch.kernels.ref.normal_moments`;
  * CUDA tensors: the hand-written kernel ``csrc/normals.cu``, or an error.
    There is no fallback from the card to the plain version.

``moment_sweep.launches`` counts the kernel's launches: one per call on CUDA
tensors, however many frames the batch holds.

The reference's ``estimate_normals_pallas`` is :func:`estimate_normals_radius`
here: ``data.normals.estimate_normals`` in radius mode, which reaches
:func:`moment_sweep`, so the reference's XLA radius path and its Pallas path
are one path in the port.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.nn_search_grid import check_candidates


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("normals")
    lib.fpps_moment_sweep.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.fpps_moment_sweep.restype = ctypes.c_int
    lib.fpps_normal_moments.restype = ctypes.c_int
    if lib.fpps_normal_moments() != len(ref.NORMAL_MOMENTS):
        raise RuntimeError("csrc/normals.cu moment count disagrees with "
                           "ref.NORMAL_MOMENTS")
    return lib


def moment_sweep(q: torch.Tensor, cand: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Radius-gated moment sums of every query's candidate offsets.

    Args:
      q: (..., N, 3) float32 queries.
      cand: (..., N, CK, 3) float32 candidates, masked slots at the sentinel.
      radius: neighbourhood gate in metres.

    Returns:
      (..., N, 10) float32 in ``ref.NORMAL_MOMENTS`` order: the count, Σd
      and the six unique entries of Σd·dᵀ of the offsets d = cand − q with
      d² <= radius².
    """
    check_candidates(q, cand)
    if q.device.type == "cpu":
        return ref.normal_moments(q, cand, radius)
    if q.device.type != "cuda":
        raise ValueError(f"no moment sweep for device {q.device}")
    q, cand = q.contiguous(), cand.contiguous()
    out = torch.empty(q.shape[:-1] + (len(ref.NORMAL_MOMENTS),),
                      dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fpps_moment_sweep(q.data_ptr(), cand.data_ptr(),
                                    out.data_ptr(), q.numel() // 3,
                                    cand.shape[-2], float(radius) ** 2,
                                    stream)
    if err != 0:
        raise RuntimeError(f"moment_sweep kernel launch failed: CUDA error "
                           f"{err}")
    moment_sweep.launches += 1
    return out


moment_sweep.launches = 0


def estimate_normals_radius(points: torch.Tensor, params=None, *,
                            valid: torch.Tensor | None = None,
                            viewpoint: torch.Tensor | None = None,
                            grid=None):
    """Radius-mode normal estimation through the moment sweep: the
    contract of ``data.normals.estimate_normals`` with
    ``neighborhood="radius"`` (default ``NormalParams(neighborhood=
    "radius")``). Raises ``ValueError`` for any other mode, as the
    reference's ``estimate_normals_pallas`` does: the k-NN selection is a
    sort, not a streaming sweep."""
    # Imported here: data.normals imports this module for moment_sweep.
    from repro_torch.data.normals import NormalParams, estimate_normals
    if params is None:
        params = NormalParams(neighborhood="radius")
    if params.neighborhood != "radius":
        raise ValueError("the moment sweep is radius-mode only; got "
                         f"neighborhood={params.neighborhood!r}")
    return estimate_normals(points, params, valid=valid,
                            viewpoint=viewpoint, grid=grid)
