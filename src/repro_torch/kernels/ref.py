"""Plain PyTorch versions of the port's CUDA kernels (port of
``repro.kernels.ref``): what each kernel is held against, and what its
wrapper runs on CPU tensors.

Brute-force NN (``csrc/nn_search.cu``). The kernel scores candidates
through an augmented inner product

    score[i, j] = src_aug[:, i] · dst_aug[:, j] = ||R p_i + t - q_j||²

with ``src_aug`` rows ``[p', 1, |p'|², 0, 0, 0]`` and ``dst_aug`` rows
``[-2q, |q|², 1, 0, 0, 0]``. Every function takes an optional leading batch
dimension: points (B, N, 3) give operands (B, 8, N).

Candidate sweep (``csrc/nn_search_grid.cu``), fused moment pass
(``csrc/fused_icp.cu``) and normals moment sweep (``csrc/normals.cu``) over
per-query candidate rows (..., N, CK, 3). Their arithmetic is written out one
IEEE operation at a time (d² as ``(dx·dx + dy·dy) + dz·dz``, true divisions
by a same-device tensor) in the order the kernels use, which compile it
without FMA contraction; the winner is the lowest slot among equal d². The
moment sweep's sums follow the kernel's lanes: lane l adds slots l, l + 32,
... in turn, then a butterfly over the 32 lanes, so it gives the kernel's
bits too.
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
    best_d2, slot = torch.min(_direct_d2(q[..., None, :] - cand), dim=-1)
    return best_d2, slot.to(torch.int32)  # first index on ties


def _direct_d2(d: torch.Tensor) -> torch.Tensor:
    """``(dx·dx + dy·dy) + dz·dz`` over the last axis of offsets d."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


ROBUST_CODES = {"none": 0, "huber": 1, "tukey": 2}  # csrc/fused_icp.cu
# The bf16 prune screen passes candidates within gate·PRUNE_MARGIN. Its
# distance is within (1 + 2^-8)^5 < 1.0197 of the fp32 d² (five bf16
# roundings of the fp32 offsets), so a margin whose square exceeds that keeps
# every within-gate candidate.
PRUNE_MARGIN = 1.1
assert PRUNE_MARGIN ** 2 > 1.0197


def prune_limit(gate: float) -> float:
    """The screen's bound on the bf16 d²: (gate · PRUNE_MARGIN)²."""
    return (float(gate) * PRUNE_MARGIN) ** 2


def _screen(d: torch.Tensor, gate: float) -> torch.Tensor:
    """The bf16 prune screen: True where the candidate may be within the
    gate. d (..., 3) are the fp32 offsets the exact d² is taken from; they
    are rounded to bf16 and squared and summed in bf16, then compared with
    :func:`prune_limit` in fp32, which keeps every within-gate
    candidate."""
    b = d.to(torch.bfloat16)
    d2b = b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1] + b[..., 2] * b[..., 2]
    limit = torch.tensor(prune_limit(gate), dtype=torch.float32,
                         device=d.device)
    return d2b.to(torch.float32) <= limit


def fused_moment_planes(q: torch.Tensor, cand: torch.Tensor,
                        sv: torch.Tensor,
                        cand_normals: torch.Tensor | None = None, *,
                        gate: float, robust_kernel: str = "none",
                        robust_scale: float = 0.5,
                        prune: bool = False) -> torch.Tensor:
    """Per-query moment planes of one fused ICP pass.

    q (..., N, 3), cand (..., N, CK, 3), sv (..., N) fp32 -> (..., P, N)
    fp32 in ``kernels.fused_icp.moment_names(plane)`` order.

    Point-to-point (``cand_normals`` None, P = 18): w, w·p (3), w·q (3),
    w·p⊗q (9, row-major), w·|p|², w·|q|². The winner of the candidate sweep
    is gated (``d² <= gate²``, d² recomputed from its coordinates), masked
    by ``sv`` and IRLS-weighted on r = sqrt(d²) (huber:
    ``min(1, s / max(r, 1e-12))``; tukey: ``(1 - u²)²`` for
    ``u = r / max(s, 1e-12) < 1``).

    Point-to-plane (``cand_normals`` (..., N, CK, 3), invalid slots 0; P =
    45): the winner's normal n is taken from the same slot, the IRLS weight
    is on |r| with r = n·(p − q), and the planes are w, the 21 of w·a⊗a
    (upper triangle, row-major), the 6 of w·r·a with a = [p×n; n], then the
    18-plane block above without its w.

    ``prune`` adds the bf16 screen (:func:`_screen`): screened candidates
    are left out of the argmin. A candidate within the gate is never
    screened, so the planes are the same bits with and without it. A row
    of zero weight writes +0 in every plane.
    """
    if robust_kernel not in ROBUST_CODES:
        raise ValueError(f"unknown robust kernel {robust_kernel!r}")
    d = q[..., None, :] - cand
    d2 = _direct_d2(d)
    if prune:
        d2 = torch.where(_screen(d, gate), d2, float("inf"))
    slot = torch.argmin(d2, dim=-1, keepdim=True)  # first index on ties
    index = slot[..., None].expand(*slot.shape, 3)
    wq = cand.gather(-2, index)[..., 0, :]
    px, py, pz = q.unbind(-1)
    qx, qy, qz = wq.unbind(-1)
    ex, ey, ez = px - qx, py - qy, pz - qz
    d2w = ex * ex + ey * ey + ez * ez
    gate2 = torch.tensor(float(gate) ** 2, dtype=torch.float32,
                         device=q.device)
    w = (d2w <= gate2).to(torch.float32) * sv
    plane = cand_normals is not None
    if plane:
        nx, ny, nz = cand_normals.gather(-2, index)[..., 0, :].unbind(-1)
        r = nx * ex + ny * ey + nz * ez
    if robust_kernel != "none":
        resid = r.abs() if plane else torch.sqrt(d2w.clamp_min(0.0))
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
    planes = [w]
    if plane:
        a = (py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx,
             nx, ny, nz)
        for k in range(6):
            for li in range(k, 6):
                planes.append(w * a[k] * a[li])
        for k in range(6):
            planes.append(w * r * a[k])
    planes += [w * px, w * py, w * pz, w * qx, w * qy, w * qz]
    for pi in (px, py, pz):
        for qi in (qx, qy, qz):
            planes.append(w * pi * qi)
    planes.append(w * (px * px + py * py + pz * pz))
    planes.append(w * (qx * qx + qy * qy + qz * qz))
    return torch.where(w[..., None, :] == 0.0, 0.0,
                       torch.stack(planes, -2))


NORMAL_MOMENTS = ("cnt", "sx", "sy", "sz", "sxx", "syy", "szz", "sxy",
                  "sxz", "syz")  # csrc/normals.cu's output order
WARP = 32


def normal_moments(q: torch.Tensor, cand: torch.Tensor,
                   radius: float) -> torch.Tensor:
    """Radius-gated moment sums of query-relative candidate offsets.

    q (..., N, 3), cand (..., N, CK, 3) fp32 -> (..., N, 10) fp32 in
    ``NORMAL_MOMENTS`` order: Σw, Σw·d (3) and the six unique entries of
    Σw·d·dᵀ, with d = cand − q and w = [d² <= radius²]. Masked slots at the
    far sentinel fail the gate, so no mask is needed.

    Summed in ``csrc/normals.cu``'s order: lane l of a warp adds slots l,
    l + 32, ... in turn (CK is padded to a multiple of 32 with zeros, which
    leave a sum unchanged), then the 32 lane sums are combined by a
    butterfly (offsets 16, 8, 4, 2, 1).
    """
    d = cand - q[..., None, :]
    w = (_direct_d2(d) <= torch.tensor(
        float(radius) ** 2, dtype=torch.float32, device=q.device)).to(
            torch.float32)
    wx, wy, wz = w * d[..., 0], w * d[..., 1], w * d[..., 2]
    dx, dy, dz = d.unbind(-1)
    terms = torch.stack([w, wx, wy, wz, wx * dx, wy * dy, wz * dz, wx * dy,
                         wx * dz, wy * dz], -2)            # (..., N, 10, CK)
    ck = terms.shape[-1]
    terms = torch.nn.functional.pad(terms, (0, (-ck) % WARP))
    terms = terms.unflatten(-1, (-1, WARP))                # (..., 10, J, 32)
    acc = torch.zeros_like(terms[..., 0, :])
    for j in range(terms.shape[-2]):
        acc = acc + terms[..., j, :]
    lanes = torch.arange(WARP, device=q.device)
    for offset in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ offset]
    return acc[..., 0]
