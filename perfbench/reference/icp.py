"""Plain point-to-point ICP: the benchmark's frozen reference.

What the program's ICP computes, written from the paper's four stages
(FPPS §II) in plain PyTorch over a batch of lanes, and nothing of the
program's: a brute-force nearest neighbour over the valid target rows (the
squared distance |p|² - 2 p·q + |q|² as one fp32 product of augmented
rows, then the winner's distance recomputed exactly), the
correspondence gate and an optional Huber weight, a weighted Kabsch step
in float64 with ``torch.linalg.svd``, the update of the cumulative
transform, and PCL's stop rule ``||R - I||_F² + ||t||² <= epsilon``. A lane
that has stopped keeps its state; a lane with no weight takes the identity
step and stops (degenerate). Ties go to the lowest target index.

``allow_tf32=True`` runs the matrix products in TF32, the control that has
to fail the comparison (the nearest precision below the fp32 the
configuration states). Everything else is the same code.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

DEGENERATE_WEIGHT_SUM = 1e-6


class Result(NamedTuple):
    T: torch.Tensor            # (B, 4, 4) float64
    iterations: torch.Tensor   # (B,) int64
    inlier_frac: torch.Tensor  # (B,) float64
    degenerate: torch.Tensor   # (B,) bool
    converged: torch.Tensor    # (B,) bool: stopped at epsilon


INVALID_BIAS = 1e30   # the score of an invalid target: it never wins


def _augment(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor):
    """Operands whose product is every squared distance: rows
    ``[p, 1, |p|², 0, 0, 0]`` against ``[-2q, |q|², 1, 0, 0, 0]``, with
    ``|q|²`` replaced by :data:`INVALID_BIAS` on invalid target rows."""
    a = torch.zeros(src.shape[:-1] + (8,), device=src.device)
    a[..., :3], a[..., 3], a[..., 4] = src, 1.0, (src * src).sum(-1)
    b = torch.zeros(dst.shape[:-1] + (8,), device=dst.device)
    b[..., :3], b[..., 4] = -2.0 * dst, 1.0
    b[..., 3] = torch.where(dst_valid, (dst * dst).sum(-1), INVALID_BIAS)
    return a, b


def nearest(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor,
            block: int = 8192):
    """Nearest valid target of every source row, per lane.

    ``src`` (B, N, 3), ``dst`` (B, M, 3) float32, ``dst_valid`` (B, M).
    The scores are one matrix product of augmented rows (:func:`_augment`)
    a block of targets at a time. Returns ``(d2, matched)``: the winner's
    exact squared distance (B, N) and the matched target rows (B, N, 3). A
    lane with no valid target reads infinite distance."""
    b, n, _ = src.shape
    best = torch.full((b, n), float("inf"), device=src.device)
    idx = torch.zeros((b, n), dtype=torch.int64, device=src.device)
    a, q_aug = _augment(src, dst, dst_valid)
    for j in range(0, dst.shape[1], block):
        s, i = torch.bmm(a, q_aug[:, j:j + block].mT).min(-1)
        better = s < best
        best = torch.where(better, s, best)
        idx = torch.where(better, i + j, idx)
    matched = dst.gather(1, idx[..., None].expand(-1, -1, 3))
    d2 = ((src - matched) ** 2).sum(-1)
    d2 = torch.where(best >= 0.5 * INVALID_BIAS, float("inf"), d2)
    return d2, matched


def kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted rigid fit (B, 4, 4) float64 of dst ≈ R src + t."""
    src, dst, w = src.double(), dst.double(), w.double()[..., None]
    wsum = w.sum(1).clamp_min(1e-12)
    ms, md = (src * w).sum(1) / wsum, (dst * w).sum(1) / wsum
    H = ((src - ms[:, None]) * w).mT @ (dst - md[:, None])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.mT
    d = torch.linalg.det(V @ U.mT)
    V = torch.cat([V[..., :2], V[..., 2:] * d[:, None, None]], -1)
    R = V @ U.mT
    T = torch.eye(4, dtype=torch.float64, device=src.device).repeat(
        src.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = md - (R @ ms[..., None])[..., 0]
    return T


@contextlib.contextmanager
def tf32(on: bool):
    """fp32 matrix products in TF32 (``on``) or in full fp32, restored
    after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Points (B, N, 3) moved by (B, 4, 4) transforms, in float32."""
    T = T.float()
    return (pts[..., None, :] * T[:, None, :3, :3]).sum(-1) + T[:, None, :3, 3]


def icp(src, dst, src_valid, dst_valid, *, max_iterations: int,
        gate: float, epsilon: float, huber: float | None = None,
        T0: torch.Tensor | None = None, allow_tf32: bool = False,
        block: int = 8192) -> Result:
    """Register each lane's ``src`` (B, N, 3) onto its ``dst`` (B, M, 3)
    from ``T0`` (B, 4, 4; identity when None). Masks (B, N) / (B, M)."""
    b = src.shape[0]
    dev = src.device
    T = (torch.eye(4, dtype=torch.float64, device=dev).repeat(b, 1, 1)
         if T0 is None else T0.double().clone())
    active = torch.ones(b, dtype=torch.bool, device=dev)
    iterations = torch.zeros(b, dtype=torch.int64, device=dev)
    inlier = torch.zeros(b, dtype=torch.float64, device=dev)
    degenerate = torch.zeros(b, dtype=torch.bool, device=dev)
    n_valid = src_valid.double().sum(-1).clamp_min(1.0)
    eye = torch.eye(4, dtype=torch.float64, device=dev)
    with tf32(allow_tf32):
        for _ in range(max_iterations):
            # only the lanes still moving are computed; the others keep
            # their state
            live = active.nonzero()[:, 0]
            if live.numel() == 0:
                break
            src_t = apply(T[live], src[live])
            d2, matched = nearest(src_t, dst[live], dst_valid[live], block)
            w = ((d2 <= gate * gate) & src_valid[live]).double()
            if huber is not None:
                r = d2.double().clamp_min(0.0).sqrt()
                w = w * (huber / r.clamp_min(1e-12)).clamp(max=1.0)
            wsum = w.sum(-1)
            dead = wsum <= DEGENERATE_WEIGHT_SUM
            step = torch.where(dead[:, None, None], eye,
                               kabsch(src_t, matched, w))
            delta = (((step[:, :3, :3] - eye[:3, :3]) ** 2).sum((-2, -1))
                     + (step[:, :3, 3] ** 2).sum(-1))
            T[live] = step @ T[live]
            iterations[live] += 1
            inlier[live] = wsum / n_valid[live]
            degenerate[live] |= dead
            active[live] = (delta > epsilon) & ~dead
    return Result(T, iterations, inlier, degenerate, ~active & ~degenerate)


def restep(src, dst, src_valid, dst_valid, T, gate: float,
           huber: float | None = None) -> torch.Tensor:
    """The step (B,) the reference takes from transforms ``T`` (B, 4, 4),
    in the stop rule's own measure, PCL's ``||R - I||_F² + ||t||²``: at a
    converged answer about the rule's epsilon, up to the correspondences
    that near-ties move."""
    r = icp(src, dst, src_valid, dst_valid, max_iterations=1, gate=gate,
            epsilon=0.0, huber=huber, T0=T)
    step = r.T @ torch.linalg.inv(T.double())
    eye = torch.eye(3, dtype=torch.float64, device=T.device)
    return (((step[:, :3, :3] - eye) ** 2).sum((-2, -1))
            + (step[:, :3, 3] ** 2).sum(-1))


def pose_errors(A, B):
    """Translation distance (m) and rotation angle (rad) between two
    stacks of (n, 4, 4) poses, in float64 NumPy."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    t = np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=-1)
    # ||R_a - R_b||_F = 2 sqrt(2) sin(angle / 2), exact for small angles
    chord = np.linalg.norm(A[:, :3, :3] - B[:, :3, :3], axis=(1, 2))
    return t, 2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0, 1))
