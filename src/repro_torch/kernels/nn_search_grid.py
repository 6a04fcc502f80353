"""Wrapper of the grid candidate-sweep kernel (port of
``repro.kernels.nn_search_grid``).

``core.nn_search_grid`` materialises each query's neighbourhood as a dense
(..., N, CK, 3) candidate matrix with sentinel slots;
:func:`candidate_sweep_kernel` reduces it to the winning slot per query
(``core.nn_search_grid.nn_search_grid`` maps that slot back to its target
row). The device of the tensors decides what runs:

  * CPU tensors: the plain version, :func:`repro_torch.kernels.ref.candidate_sweep`;
  * CUDA tensors: the hand-written kernel ``csrc/nn_search_grid.cu``, or an
    error. There is no fallback from the card to the plain version.

``candidate_sweep_kernel.launches`` counts the kernel's launches: one per
call on CUDA tensors, however many frames the batch holds.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

WARPS_PER_BLOCK = 8  # csrc kWarpsPerBlock: queries per block

_c_void_p = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("nn_search_grid")
    lib.fpps_candidate_sweep.argtypes = [_c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, _c_void_p]
    lib.fpps_candidate_sweep.restype = ctypes.c_int
    lib.fpps_grid_warps_per_block.restype = ctypes.c_int
    if lib.fpps_grid_warps_per_block() != WARPS_PER_BLOCK:
        raise RuntimeError("csrc/nn_search_grid.cu block size disagrees with "
                           "kernels/nn_search_grid.py")
    return lib


def check_candidates(q: torch.Tensor, cand: torch.Tensor) -> None:
    """Raise unless q (..., N, 3) and cand (..., N, CK, 3) are fp32 on one
    device with matching leading dimensions."""
    for name, t in (("q", q), ("cand", cand)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if (q.dim() < 2 or q.shape[-1] != 3 or cand.dim() != q.dim() + 1
            or cand.shape[-1] != 3 or cand.shape[:-2] != q.shape[:-1]):
        raise ValueError(f"q must be (..., N, 3) and cand (..., N, CK, 3); "
                         f"got {tuple(q.shape)} and {tuple(cand.shape)}")
    if cand.shape[-2] == 0 or q.shape[-2] == 0:
        raise ValueError("no queries or no candidate slots")
    if q.device != cand.device:
        raise ValueError(f"q and cand on different devices: {q.device} vs "
                         f"{cand.device}")


def candidate_sweep_kernel(q: torch.Tensor, cand: torch.Tensor):
    """Nearest candidate slot of every query.

    Args:
      q: (..., N, 3) float32 queries.
      cand: (..., N, CK, 3) float32 candidates, masked slots at the sentinel.

    Returns:
      ``(best_d2, best_slot)``: (..., N) float32, unclamped, and (..., N)
      int32; the lowest slot wins among equal d².
    """
    check_candidates(q, cand)
    if q.device.type == "cpu":
        return ref.candidate_sweep(q, cand)
    if q.device.type != "cuda":
        raise ValueError(f"no candidate sweep for device {q.device}")
    q, cand = q.contiguous(), cand.contiguous()
    rows = q.numel() // 3
    best_d2 = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    best_slot = torch.empty(q.shape[:-1], dtype=torch.int32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fpps_candidate_sweep(q.data_ptr(), cand.data_ptr(),
                                       best_d2.data_ptr(),
                                       best_slot.data_ptr(), rows,
                                       cand.shape[-2], stream)
    if err != 0:
        raise RuntimeError(f"candidate_sweep kernel launch failed: CUDA "
                           f"error {err}")
    candidate_sweep_kernel.launches += 1
    return best_d2, best_slot


candidate_sweep_kernel.launches = 0
