"""Plain PyTorch versions of the port's CUDA kernels (port of
``repro.kernels.ref``): what each kernel is held against, and what its
wrapper runs on CPU tensors.

Brute-force NN (``csrc/nn_search.cu``). The kernel scores candidates
through an augmented inner product

    score[i, j] = src_aug[:, i] · dst_aug[:, j] = ||R p_i + t - q_j||²

with ``src_aug`` rows ``[p', 1, |p'|², 0, 0, 0]`` and ``dst_aug`` rows
``[-2q, |q|², 1, 0, 0, 0]``. Every function takes an optional leading batch
dimension: points (B, N, 3) give operands (B, 8, N).

Candidate sweep (``csrc/nn_search_grid.cu``) and fused moment pass
(``csrc/fused_icp.cu``) over per-query candidate rows (..., N, CK, 3). Their
arithmetic is written out one IEEE operation at a time (d² as
``(dx·dx + dy·dy) + dz·dz``, true divisions by a same-device tensor) in the
order the kernels use, which compile it without FMA contraction; the
winner is the lowest slot among equal d².
"""
from __future__ import annotations

import torch

from repro_torch.device import check_fp32_matmul

AUG_ROWS = 8  # fp32 sublane height of the reference; rows 5..7 stay zero
# Row-3 bias of padded target columns: they can never win the argmin.
PAD_BIAS = 1e30


def augment_target(dst: torch.Tensor, pad_to: int | None = None
                   ) -> torch.Tensor:
    """(..., M, 3) -> (..., 8, M') constant target augmentation.

    Rows 0..2 = -2q, row 3 = ||q||², row 4 = 1, rows 5..7 = 0; padded
    columns get row 3 = +1e30 (and row 4 = 1).
    """
    m = dst.shape[-2]
    mp = m if pad_to is None else pad_to
    if mp < m:
        raise ValueError(f"pad_to={mp} is smaller than M={m}")
    q = dst.to(torch.float32)
    out = q.new_zeros(dst.shape[:-2] + (AUG_ROWS, mp))
    out[..., 0:3, :m] = -2.0 * q.mT
    out[..., 3, :m] = (q * q).sum(-1)
    out[..., 4, :] = 1.0
    out[..., 3, m:] = PAD_BIAS
    return out


def augment_source(src: torch.Tensor, T: torch.Tensor | None = None,
                   pad_to: int | None = None) -> torch.Tensor:
    """(..., N, 3) [+ (..., 4, 4) T] -> (..., 8, N') source augmentation.

    p' = R p + t is folded in; rows 0..2 = p', row 3 = 1, row 4 = ||p'||²,
    rows 5..7 and padded columns = 0.
    """
    n = src.shape[-2]
    np_ = n if pad_to is None else pad_to
    if np_ < n:
        raise ValueError(f"pad_to={np_} is smaller than N={n}")
    p = src.to(torch.float32)
    if T is not None:
        T = T.to(torch.float32)
        p = p @ T[..., :3, :3].mT + T[..., None, :3, 3]
    out = p.new_zeros(src.shape[:-2] + (AUG_ROWS, np_))
    out[..., 0:3, :n] = p.mT
    out[..., 3, :n] = 1.0
    out[..., 4, :n] = (p * p).sum(-1)
    return out


def blocked_argmin(src_aug: torch.Tensor, dst_aug: torch.Tensor,
                   bm: int = 1024):
    """The kernel's contract in plain PyTorch, on augmented operands.

    (..., 8, N), (..., 8, M) -> ((..., N) fp32 best score, unclamped;
    (..., N) int32 index). Target blocks of ``bm`` columns are scored with
    one fp32 matmul each; a running minimum with strict ``<`` across
    blocks keeps the earliest index on ties.
    """
    check_fp32_matmul(src_aug)
    lead = src_aug.shape[:-2]
    n = src_aug.shape[-1]
    best_d2 = src_aug.new_full(lead + (n,), float("inf"))
    best_idx = torch.zeros(lead + (n,), dtype=torch.int32,
                           device=src_aug.device)
    src_t = src_aug.mT
    for base in range(0, dst_aug.shape[-1], bm):
        scores = src_t @ dst_aug[..., base:base + bm]
        lmin, larg = torch.min(scores, dim=-1)
        upd = lmin < best_d2
        best_d2 = torch.where(upd, lmin, best_d2)
        best_idx = torch.where(upd, larg.to(torch.int32) + base, best_idx)
    return best_d2, best_idx


def nn_search_ref(src: torch.Tensor, dst: torch.Tensor,
                  T: torch.Tensor | None = None):
    """Exact NN through the full augmented score matrix, no tiling.

    Returns ``(d2, idx)``: clamped (..., N) fp32 and (..., N) int32; ties
    resolve to the lowest index.
    """
    check_fp32_matmul(src)
    scores = augment_source(src, T).mT @ augment_target(dst)
    d2, idx = torch.min(scores, dim=-1)
    return d2.clamp_min(0.0), idx.to(torch.int32)


def nn_search_ref_blocked(src: torch.Tensor, dst: torch.Tensor,
                          T: torch.Tensor | None = None, bn: int = 128,
                          bm: int = 1024):
    """The kernel's padding and carry semantics on raw points: N padded to
    ``bn``, M to ``bm`` (padded targets biased +1e30), then
    :func:`blocked_argmin`, clamped and unpadded."""
    n, m = src.shape[-2], dst.shape[-2]
    src_aug = augment_source(src, T, pad_to=n + (-n) % bn)
    dst_aug = augment_target(dst, pad_to=m + (-m) % bm)
    d2, idx = blocked_argmin(src_aug, dst_aug, bm)
    return d2[..., :n].clamp_min(0.0), idx[..., :n]


def candidate_sweep(q: torch.Tensor, cand: torch.Tensor):
    """Rowwise argmin of the direct-form d² over each query's candidates.

    q (..., N, 3), cand (..., N, CK, 3) fp32 -> ((..., N) fp32 best d²,
    unclamped; (..., N) int32 slot, the lowest among equal d²).
    """
    d = q[..., None, :] - cand
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    best_d2, slot = torch.min(d2, dim=-1)  # first index on ties
    return best_d2, slot.to(torch.int32)


ROBUST_CODES = {"none": 0, "huber": 1, "tukey": 2}  # csrc/fused_icp.cu


def fused_moment_planes(q: torch.Tensor, cand: torch.Tensor,
                        sv: torch.Tensor, *, gate: float,
                        robust_kernel: str = "none",
                        robust_scale: float = 0.5) -> torch.Tensor:
    """Per-query point-to-point moment planes of one fused ICP pass.

    q (..., N, 3), cand (..., N, CK, 3), sv (..., N) fp32 -> (..., 18, N)
    fp32 in ``kernels.fused_icp.P2P_MOMENTS`` order: w, w·p (3), w·q (3),
    w·p⊗q (9, row-major), w·|p|², w·|q|². The winner of the candidate sweep is
    gated (``d² <= gate²``, d² recomputed from its coordinates), masked by
    ``sv`` and IRLS-weighted (huber: ``min(1, s / max(r, 1e-12))``; tukey:
    ``(1 - u²)²`` for ``u = r / max(s, 1e-12) < 1``, with ``r = sqrt(d²)``).
    """
    if robust_kernel not in ROBUST_CODES:
        raise ValueError(f"unknown robust kernel {robust_kernel!r}")
    _, slot = candidate_sweep(q, cand)
    wq = cand.gather(-2, slot.long()[..., None, None].expand(
        *slot.shape, 1, 3))[..., 0, :]
    px, py, pz = q.unbind(-1)
    qx, qy, qz = wq.unbind(-1)
    ex, ey, ez = px - qx, py - qy, pz - qz
    d2 = ex * ex + ey * ey + ez * ez
    gate2 = torch.tensor(float(gate) ** 2, dtype=torch.float32,
                         device=q.device)
    w = (d2 <= gate2).to(torch.float32) * sv
    if robust_kernel != "none":
        resid = torch.sqrt(d2.clamp_min(0.0))
        if robust_kernel == "huber":
            s = torch.tensor(float(robust_scale), dtype=torch.float32,
                             device=q.device)
            w = w * torch.clamp(s / resid.clamp_min(1e-12), max=1.0)
        else:
            c = torch.tensor(max(float(robust_scale), 1e-12),
                             dtype=torch.float32, device=q.device)
            u = resid / c
            t = 1.0 - u * u
            w = w * torch.where(u < 1.0, t * t, 0.0)
    planes = [w, w * px, w * py, w * pz, w * qx, w * qy, w * qz]
    for pi in (px, py, pz):
        for qi in (qx, qy, qz):
            planes.append(w * pi * qi)
    planes.append(w * (px * px + py * py + pz * pz))
    planes.append(w * (qx * qx + qy * qy + qz * qz))
    return torch.stack(planes, -2)
