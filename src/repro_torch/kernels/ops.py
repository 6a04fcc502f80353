"""Public wrappers around the NN kernel (port of ``repro.kernels.ops``).

They pad to the kernel's tile multiples, build the augmented operands, run
:func:`repro_torch.kernels.nn_search.nn_search_kernel`, clamp d² at 0 and
slice the padding off, with the ``(src, dst) -> (d2, idx)`` contract of
``repro_torch.core.nn_search`` so they plug into ``core.icp`` as ``nn_fn``.
Everything takes an optional leading batch dimension. The kernel runs on
CUDA tensors, its plain version on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.device import round_up
from repro_torch.kernels import ref
from repro_torch.kernels.nn_search import BLOCK_N, TILE_M, nn_search_kernel


def make_frame_engine(dst: torch.Tensor):
    """Augment a target frame once; return ``nn_fn(src, T=None)``.

    The (..., 8, M') target operand is built now and closed over (the
    paper's BRAM-resident target, DESIGN.md §2), so each ICP iteration only
    augments the small source cloud, with ``T`` (..., 4, 4) folded into it
    (``ref.augment_source``). ``nn_fn`` returns ((..., N) fp32 d² clamped at
    0, (..., N) int32 idx). Padded or invalid target rows must already
    carry the far sentinel; padded columns carry the +1e30 bias and never
    win, and padded source rows are sliced off.
    """
    dst_aug = ref.augment_target(dst, pad_to=round_up(dst.shape[-2], TILE_M))

    def nn_fn(src: torch.Tensor, T: torch.Tensor | None = None):
        n = src.shape[-2]
        src_aug = ref.augment_source(src, T, pad_to=round_up(n, BLOCK_N))
        d2, idx = nn_search_kernel(src_aug, dst_aug)
        return d2[..., :n].clamp_min(0.0), idx[..., :n]

    return nn_fn


def nn_search_cuda(src: torch.Tensor, dst: torch.Tensor,
                   T: torch.Tensor | None = None):
    """NN of each (optionally T-transformed) src (..., N, 3) point in dst
    (..., M, 3): one :func:`make_frame_engine` call."""
    return make_frame_engine(dst)(src, T)


def resident_nn_fn(dst: torch.Tensor):
    """:func:`make_frame_engine` with the ``core.icp`` contract
    ``nn_fn(src, target=None)``: the second argument is ignored in favour
    of the resident target."""
    frame = make_frame_engine(dst)

    def nn_fn(src: torch.Tensor, _target=None):
        return frame(src)

    return nn_fn
