"""SE(3) utilities and Kabsch estimation (port of ``repro.core.transform``).

The math of FPPS §II: the rigid transform ``T = [[R, t], [0, 1]]``, its
application, and the SVD-based estimation step minimising
``Σ w_i ||q_i - (R p_i + t)||²``. Every function takes any leading batch
dimensions (``T`` (..., 4, 4), points (..., N, 3)), so the batched ICP loop
runs one call per stage for a whole frame batch where the reference vmaps.
"""
from __future__ import annotations

import torch

from repro_torch.core.svd3x3 import svd3x3


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous transform from R (..., 3, 3), t (..., 3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply T (..., 4, 4) to points (..., N, 3): ``p @ Rᵀ + t``."""
    return points @ T[..., :3, :3].mT + T[..., None, :3, 3]


def rotation_from_axis_angle(axis: torch.Tensor,
                             angle: torch.Tensor | float) -> torch.Tensor:
    """Rodrigues' formula; ``axis`` (..., 3) need not be normalised."""
    axis = axis / (torch.sqrt((axis * axis).sum(-1, keepdim=True)) + 1e-12)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    kx, ky, kz = axis.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky], -1),
                     torch.stack([kz, zero, -kx], -1),
                     torch.stack([-ky, kx, zero], -1)], -2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def random_rigid_transform(max_angle: float = 0.5,
                           max_translation: float = 1.0, *,
                           generator: torch.Generator | None = None,
                           device="cpu",
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """A random SE(3) transform (4, 4) for tests and synthetic data.

    The reference's function: a rotation by Rodrigues' formula about a
    normal-drawn axis through an angle uniform in ``[-max_angle,
    max_angle)``, and a translation uniform in ``[-max_translation,
    max_translation)`` per axis. The draws come from ``generator`` (a CPU
    ``torch.Generator``; the global one when None), so they differ from the
    reference's JAX PRNG draws for any seed. Drawn on the CPU, then moved to
    ``device``: one seed gives the same transform on every device.
    """
    axis = torch.randn(3, generator=generator, dtype=dtype)
    angle = (torch.rand((), generator=generator, dtype=dtype) * 2.0 - 1.0
             ) * max_angle
    t = (torch.rand(3, generator=generator, dtype=dtype) * 2.0 - 1.0
         ) * max_translation
    return make_transform(rotation_from_axis_angle(axis, angle), t).to(device)


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactor expansion."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def estimate_from_covariance(H: torch.Tensor, src_mean: torch.Tensor,
                             dst_mean: torch.Tensor) -> torch.Tensor:
    """Kabsch from a cross-covariance H (..., 3, 3) and the two centroids.

    A proper rotation: when det(V Uᵀ) < 0 the axis of the smallest singular
    value is flipped (column 2 of V scaled by the determinant, i.e. the
    reference's ``V @ diag(1, 1, det) @ Uᵀ``).
    """
    U, _, Vt = svd3x3(H)
    V = Vt.mT
    det = _det3(V @ U.mT)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * det[..., None, None]], -1)
    R = V @ U.mT
    t = dst_mean - (R @ src_mean[..., None])[..., 0]
    return make_transform(R, t)


def estimate_rigid_transform(src: torch.Tensor, dst: torch.Tensor,
                             weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Weighted Kabsch: the rigid T minimising Σ w_i ||dst_i - (R src_i + t)||².

    ``src``/``dst`` are (..., N, 3) corresponding points; ``weights``
    (..., N) carries the correspondence-distance gate (zero-weight pairs
    add nothing to the covariance).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights.to(src.dtype)[..., None]
    wsum = w.sum(-2).clamp_min(1e-12)
    src_mean = (src * w).sum(-2) / wsum
    dst_mean = (dst * w).sum(-2) / wsum
    src_c = src - src_mean[..., None, :]
    dst_c = dst - dst_mean[..., None, :]
    H = (src_c * w).mT @ dst_c
    return estimate_from_covariance(H, src_mean, dst_mean)


def estimate_from_moments(sw: torch.Tensor, sp: torch.Tensor,
                          sq: torch.Tensor, spq: torch.Tensor
                          ) -> torch.Tensor:
    """Weighted Kabsch from raw moment sums: sw = Σw (...), sp = Σw·p and
    sq = Σw·q (..., 3), spq = Σw·p⊗q (..., 3, 3)."""
    wsum = sw.clamp_min(1e-12)[..., None]
    H = spq - sp[..., :, None] * sq[..., None, :] / wsum[..., None]
    return estimate_from_covariance(H, sp / wsum, sq / wsum)


def transform_delta(T: torch.Tensor) -> torch.Tensor:
    """PCL's transformationEpsilon metric: ||R - I||_F² + ||t||²."""
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    return (((T[..., :3, :3] - eye) ** 2).sum((-2, -1))
            + (T[..., :3, 3] ** 2).sum(-1))


def rmse(src: torch.Tensor, dst: torch.Tensor,
         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Root mean square correspondence error over the point axis."""
    d2 = ((src - dst) ** 2).sum(-1)
    if weights is None:
        return torch.sqrt(d2.mean(-1))
    w = weights.to(src.dtype)
    return torch.sqrt((d2 * w).sum(-1) / w.sum(-1).clamp_min(1e-12))


def rmse_from_moments(T_delta: torch.Tensor, sw: torch.Tensor,
                      sp: torch.Tensor, sq: torch.Tensor, spq: torch.Tensor,
                      spp: torch.Tensor, sqq: torch.Tensor) -> torch.Tensor:
    """Post-step weighted RMSE from moment sums, without the residuals:

        Σw‖Rp+t−q‖² = spp + sqq + sw‖t‖² + 2 t·(R sp) − 2 tr(R spq) − 2 t·sq
    """
    R = T_delta[..., :3, :3].to(torch.float32)
    t = T_delta[..., :3, 3].to(torch.float32)
    R_sp = (R @ sp[..., None])[..., 0]
    tr = torch.diagonal(R @ spq, dim1=-2, dim2=-1).sum(-1)
    total = (spp + sqq + sw * (t * t).sum(-1) + 2.0 * (t * R_sp).sum(-1)
             - 2.0 * tr - 2.0 * (t * sq).sum(-1))
    return torch.sqrt(total.clamp_min(0.0) / sw.clamp_min(1e-12))
