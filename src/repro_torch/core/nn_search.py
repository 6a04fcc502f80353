"""Plain chunked brute-force nearest-neighbour search (port of
``repro.core.nn_search``): the searcher behind the ``"torch"`` engine.

Distances come from the expansion ``||p - q||² = ||p||² + ||q||² - 2 p·q``,
one fp32 ``torch.matmul`` per target chunk, with a running (min d², argmin)
carry across chunks (strict ``<``, so the earliest index wins a tie). The
winners' d² are then recomputed directly, since the expansion costs ~1e-4
absolute at scene scale. On the card the product must be IEEE fp32: TF32
keeps about three decimal digits and would mis-rank neighbours, so a CUDA
call with TF32 matmuls enabled raises.

All functions take any leading batch dimensions: src (..., N, 3),
dst (..., M, 3), dst_valid (..., M).
"""
from __future__ import annotations

import torch

from repro_torch.device import check_fp32_matmul

# Finite chunk padding: inf coordinates would make the expansion inf - inf.
# 1e15 keeps padded d2 ~1e30, beyond any metric scene.
_CHUNK_PAD = 1e15


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[..., idx, :]`` per batch: (..., M, C), (..., N) -> (..., N, C)."""
    index = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, -2, index)


def pairwise_sq_dists(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., N, 3), (..., M, 3) -> (..., N, M) squared distances from the
    matmul expansion, clamped at 0 (the reference's, which it also leaves
    outside any kernel). Raises on a CUDA tensor while TF32 matmuls are on."""
    check_fp32_matmul(src)
    sn = (src * src).sum(-1)[..., :, None]
    dn = (dst * dst).sum(-1)[..., None, :]
    return (sn + dn - 2.0 * (src @ dst.mT)).clamp_min(0.0)


def nn_search(src: torch.Tensor, dst: torch.Tensor, *, chunk: int = 2048,
              dst_valid: torch.Tensor | None = None,
              score_dtype: str = "fp32", return_points: bool = False):
    """Exact NN of each src point in dst.

    Args:
      src: (..., N, 3) queries; dst: (..., M, 3) targets.
      chunk: target chunk size, bounding the live (N, chunk) score tile.
      dst_valid: optional (..., M) bool mask; invalid targets score inf.
      score_dtype: "fp32" (default) or "bf16" (half-width score tiles; may
        mis-rank near ties, as in the reference).
      return_points: also return the winners ``dst[idx]`` (..., N, 3).

    Returns:
      ``(d2, idx[, points])``: (..., N) fp32 exact squared distance
      (inf where no target was valid), (..., N) int32 index.
    """
    check_fp32_matmul(src)
    m = dst.shape[-2]
    pad = (-m) % chunk
    if pad:
        dst = torch.cat([dst, dst.new_full(dst.shape[:-2] + (pad, 3),
                                           _CHUNK_PAD)], -2)
        if dst_valid is not None:
            dst_valid = torch.cat([dst_valid, dst_valid.new_zeros(
                dst_valid.shape[:-1] + (pad,))], -1)
    lowp = score_dtype == "bf16"
    sn = (src * src).sum(-1)
    if lowp:
        src_c, sn_c = src.to(torch.bfloat16), sn.to(torch.bfloat16)
    best_d2 = torch.full(src.shape[:-1], float("inf"), dtype=torch.float32,
                         device=src.device)
    best_idx = torch.zeros(src.shape[:-1], dtype=torch.int32,
                           device=src.device)
    for base in range(0, dst.shape[-2], chunk):
        dchunk = dst[..., base:base + chunk, :]
        dn = (dchunk * dchunk).sum(-1)
        if lowp:
            cross = src_c @ dchunk.to(torch.bfloat16).mT
            d2 = (sn_c[..., :, None] + dn.to(torch.bfloat16)[..., None, :]
                  - 2.0 * cross)
        else:
            d2 = sn[..., :, None] + dn[..., None, :] - 2.0 * (src @ dchunk.mT)
        if dst_valid is not None:
            valid = dst_valid[..., None, base:base + chunk]
            d2 = torch.where(valid, d2, float("inf"))
        local_d2, local_idx = torch.min(d2, dim=-1)
        local_d2 = local_d2.to(torch.float32)
        improved = local_d2 < best_d2
        best_d2 = torch.where(improved, local_d2, best_d2)
        best_idx = torch.where(improved, local_idx.to(torch.int32) + base,
                               best_idx)
    # Exact-d2 epilogue on the O(N) winners; keep inf where nothing valid.
    matched = gather_rows(dst, best_idx)
    diff = src - matched
    exact = (diff * diff).sum(-1).to(torch.float32)
    best_d2 = torch.where(torch.isinf(best_d2), best_d2, exact).clamp_min(0.0)
    if return_points:
        return best_d2, best_idx, matched
    return best_d2, best_idx
