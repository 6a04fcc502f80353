"""Public wrappers around the NN kernel (port of ``repro.kernels.ops``).

They pad to the kernel's tile multiples, build the augmented operands, run
:func:`repro_torch.kernels.nn_search.nn_search_kernel`, clamp d² at 0 and
slice the padding off, with the ``(src, dst) -> (d2, idx)`` contract of
``repro_torch.core.nn_search`` so they plug into ``core.icp`` as ``nn_fn``.
Everything takes an optional leading batch dimension.
"""
from __future__ import annotations

import torch

from repro_torch.device import round_up
from repro_torch.kernels import ref
from repro_torch.kernels.nn_search import BLOCK_N, TILE_M, nn_search_kernel


def nn_search_cuda(src: torch.Tensor, dst: torch.Tensor,
                   T: torch.Tensor | None = None):
    """NN of each (optionally T-transformed) src point in dst.

    src (..., N, 3), dst (..., M, 3), T (..., 4, 4) -> ((..., N) fp32 d2
    clamped at 0, (..., N) int32 idx). Padded targets carry the +1e30 bias
    and never win; padded source rows are sliced off.
    """
    n, m = src.shape[-2], dst.shape[-2]
    src_aug = ref.augment_source(src, T, pad_to=round_up(n, BLOCK_N))
    dst_aug = ref.augment_target(dst, pad_to=round_up(m, TILE_M))
    d2, idx = nn_search_kernel(src_aug, dst_aug)
    return d2[..., :n].clamp_min(0.0), idx[..., :n]


def resident_nn_fn(dst: torch.Tensor):
    """Searcher with the target augmented once per frame.

    Builds the (..., 8, M') augmented target now, so each ICP iteration
    only augments the small source cloud (the paper's BRAM-resident target,
    DESIGN.md §2). The returned ``nn_fn(src, target=None)`` follows the
    ``core.icp`` contract but ignores its second argument. Padded or
    invalid target rows must already carry the far sentinel.
    """
    dst_aug = ref.augment_target(dst, pad_to=round_up(dst.shape[-2], TILE_M))

    def nn_fn(src: torch.Tensor, _target=None):
        n = src.shape[-2]
        src_aug = ref.augment_source(src, pad_to=round_up(n, BLOCK_N))
        d2, idx = nn_search_kernel(src_aug, dst_aug)
        return d2[..., :n].clamp_min(0.0), idx[..., :n]

    return nn_fn
