"""Wrapper of the brute-force NN kernel (port of
``repro.kernels.nn_search.nn_search_kernel``).

:func:`nn_search_kernel` takes pre-augmented operands (``kernels.ref``) and
returns the running (min score, argmin) per source column. The device of
the tensors decides what runs:

  * CPU tensors: the plain version, :func:`repro_torch.kernels.ref.blocked_argmin`;
  * CUDA tensors: the hand-written kernel ``csrc/nn_search.cu``, or an error.
    There is no fallback from the card to the plain version.

``nn_search_kernel.launches`` counts the kernel's launches (one per call on
a CUDA tensor, however many frames the batch holds) so a run can show that
its main path went through the kernel. A call is one device kernel: the
target-axis splits are merged inside it (``csrc/nn_search.cu``).
:func:`smem_bytes` is the kernel's shared-memory budget (the counterpart of
the reference's VMEM model ``vmem_bytes``) and, on the card, its compiled
resources.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

AUG_ROWS = ref.AUG_ROWS
THREADS = 256   # threads per block (csrc kThreads)
BLOCK_N = 512   # queries per block (256 threads x 2): N must be a multiple
TILE_M = 128    # targets per shared-memory tile: M must be a multiple
STAGES = 4      # tiles in flight (csrc kStages)
SUM_ROWS = 4    # operand rows a tile holds (csrc kRows: the four-term sum)
# The M split (``num_splits``), chosen by timing split rules on an H100:
# about two blocks per SM, so one frame runs in one wave; ranges of at
# most 16 tiles, so a batch's many blocks balance across the SMs; and at
# least two tiles, so a range's loads overlap its sweep.
BLOCKS_PER_SM = 2
MAX_TILES_PER_SPLIT = 16
MIN_TILES_PER_SPLIT = 2

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("nn_search")
    lib.fpps_nn_search.argtypes = [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p]
    lib.fpps_nn_search.restype = _c_int
    lib.fpps_nn_block_n.restype = _c_int
    lib.fpps_nn_tile_m.restype = _c_int
    lib.fpps_nn_attributes.argtypes = [ctypes.POINTER(_c_int)]
    lib.fpps_nn_attributes.restype = _c_int
    if (lib.fpps_nn_block_n(), lib.fpps_nn_tile_m()) != (BLOCK_N, TILE_M):
        raise RuntimeError("csrc/nn_search.cu tile sizes disagree with "
                           "kernels/nn_search.py")
    return lib


def smem_bytes(device=None) -> dict:
    """The NN kernel's shared memory a block, as ``csrc/nn_search.cu`` fixes
    it: the ring of ``STAGES`` target tiles (``SUM_ROWS`` x ``TILE_M`` fp32
    each), one 8-byte ``mbarrier`` a stage and the 4-byte merge flag;
    ``total`` is their sum, the kernel's static shared bytes. With a CUDA
    ``device`` also ``card``: the compiled kernel's resources there
    (:func:`repro_torch.kernels.build.kernel_attributes`); any other device
    raises."""
    out = dict(tile_ring=STAGES * SUM_ROWS * TILE_M * 4, barriers=STAGES * 8,
               merge_flag=4, threads_per_block=THREADS,
               queries_per_block=BLOCK_N)
    out["total"] = out["tile_ring"] + out["barriers"] + out["merge_flag"]
    if device is not None:
        out["card"] = build.kernel_attributes(
            lambda res: _library().fpps_nn_attributes(res), threads=THREADS,
            device=device)
    return out


def _check(src_aug: torch.Tensor, dst_aug: torch.Tensor) -> None:
    for name, t in (("src_aug", src_aug), ("dst_aug", dst_aug)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[1] != AUG_ROWS:
            raise ValueError(f"{name} must be (B, {AUG_ROWS}, L), got "
                             f"{tuple(t.shape)}")
        if t.shape[2] == 0:
            raise ValueError(f"{name} is empty")
    if src_aug.shape[0] != dst_aug.shape[0]:
        raise ValueError(f"batch sizes differ: {src_aug.shape[0]} vs "
                         f"{dst_aug.shape[0]}")
    if src_aug.device != dst_aug.device:
        raise ValueError(f"operands on different devices: {src_aug.device} "
                         f"vs {dst_aug.device}")


def num_splits(batch: int, n: int, m: int, sm_count: int) -> int:
    """Ranges the target axis is split into: enough for ``BLOCKS_PER_SM``
    blocks per SM even for one small frame, and for ranges of at most
    ``MAX_TILES_PER_SPLIT`` tiles; never so many that a range is shorter
    than ``MIN_TILES_PER_SPLIT`` tiles (one range below that)."""
    tiles = m // TILE_M
    fill = -(-BLOCKS_PER_SM * sm_count // (batch * (n // BLOCK_N)))
    spread = -(-tiles // MAX_TILES_PER_SPLIT)
    return max(1, min(max(fill, spread), tiles // MIN_TILES_PER_SPLIT, 65535))


def nn_search_kernel(src_aug: torch.Tensor, dst_aug: torch.Tensor):
    """Nearest target column of every source column.

    Args:
      src_aug: (8, N) or (B, 8, N) float32 from ``ref.augment_source``.
      dst_aug: (8, M) or (B, 8, M) float32 from ``ref.augment_target``. On
        the card N must be a multiple of ``BLOCK_N`` and M of ``TILE_M``
        (``kernels.ops`` pads), and both must be contiguous and 16-byte
        aligned (:func:`check_kernel_shapes`).

    Returns:
      ``(best_d2, best_idx)``: (..., N) float32 scores, unclamped, and
      (..., N) int32 indices; the earliest index wins a tie.
    """
    unbatched = src_aug.dim() == 2
    if unbatched:
        src_aug, dst_aug = src_aug[None], dst_aug[None]
    _check(src_aug, dst_aug)
    if src_aug.device.type == "cpu":
        d2, idx = ref.blocked_argmin(src_aug, dst_aug)
    elif src_aug.device.type == "cuda":
        d2, idx = _launch(src_aug, dst_aug)
    else:
        raise ValueError(f"no NN search for device {src_aug.device}")
    return (d2[0], idx[0]) if unbatched else (d2, idx)


def check_kernel_shapes(src_aug: torch.Tensor, dst_aug: torch.Tensor) -> None:
    """What the kernel takes beyond :func:`nn_search_kernel`'s contract:
    (B, 8, N) / (B, 8, M) with N a multiple of ``BLOCK_N``, M of ``TILE_M``,
    B <= 65535 (the grid's z), both contiguous and 16-byte aligned (the
    target tiles are bulk copies). Raises ``ValueError`` otherwise."""
    b, _, n = src_aug.shape
    m = dst_aug.shape[2]
    if n % BLOCK_N or m % TILE_M:
        raise ValueError(f"N={n} must be a multiple of {BLOCK_N} and M={m} "
                         f"of {TILE_M}; pad with kernels.ops")
    if not (src_aug.is_contiguous() and dst_aug.is_contiguous()):
        raise ValueError("src_aug and dst_aug must be contiguous")
    if src_aug.data_ptr() % 16 or dst_aug.data_ptr() % 16:
        raise ValueError("src_aug and dst_aug must be 16-byte aligned")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535 limit")


_merge_state: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _merge_buffers(dev: torch.device, stream: int, n_keys: int,
                   n_tickets: int):
    """The split merge's state, kept per device and stream: ``n_keys``
    int64 merge keys at all ones and ``n_tickets`` int32 counters at zero.

    The kernel leaves both as it found them, so they are filled once, when
    first needed (or outgrown), and not on every call (that would be more
    device kernels). One pair per stream, because two launches that may
    overlap must not share them."""
    key = (dev.index, stream)
    state = _merge_state.get(key)
    if (state is None or state[0].numel() < n_keys
            or state[1].numel() < n_tickets):
        state = _merge_state[key] = (
            torch.full((max(n_keys, 1 << 15),), -1, dtype=torch.int64,
                       device=dev),
            torch.zeros(max(n_tickets, 1024), dtype=torch.int32, device=dev))
    return state


def _launch(src_aug: torch.Tensor, dst_aug: torch.Tensor):
    check_kernel_shapes(src_aug, dst_aug)
    b, _, n = src_aug.shape
    m = dst_aug.shape[2]
    lib = _library()
    dev = src_aug.device
    splits = num_splits(b, n, m,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    best_d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    best_idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys, tickets = _merge_buffers(dev, stream, b * n, b * (n // BLOCK_N))
        err = lib.fpps_nn_search(
            src_aug.data_ptr(), dst_aug.data_ptr(), keys.data_ptr(),
            tickets.data_ptr(), best_d2.data_ptr(), best_idx.data_ptr(),
            b, n, m, splits, stream)
    if err != 0:
        raise RuntimeError(f"nn_search kernel launch failed: CUDA error {err}")
    nn_search_kernel.launches += 1
    return best_d2, best_idx


nn_search_kernel.launches = 0
