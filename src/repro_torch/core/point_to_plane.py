"""Point-to-plane estimation and robust IRLS weights (port of
``repro.core.point_to_plane``).

The point-to-plane error ``E(T) = Σ w_i (n_iᵀ (T p_i − q_i))²`` has no
closed form; each ICP iteration takes one Gauss-Newton step under the
small-angle parameterisation ``R ≈ I + [ω]×``. With ``x = (ω, t)`` and the
per-pair Jacobian row ``a_i = [p_i × n_i; n_i]`` the normal equations are

    (Σ w_i a_i a_iᵀ) x = − Σ w_i r_i a_i,       r_i = n_iᵀ (p_i − q_i)

a damped 6x6 solve, then Rodrigues on ω, so the step is a proper rigid
transform. :func:`robust_weights` applies on top of the distance gate, on
the residual the active minimiser optimises.

Every function takes any leading batch dimensions. The 6x6 solve is
``torch.linalg.solve_ex`` with ``check_errors=False``: ``torch.linalg.solve``
checks its result on the host, which would synchronise every iteration of
``icp_fixed_iterations`` and ``icp_batch``.
"""
from __future__ import annotations

import torch

from repro_torch.core import transform as tf

ROBUST_KERNELS = ("none", "huber", "tukey")


def robust_weights(residual: torch.Tensor, kind: str,
                   scale: float) -> torch.Tensor:
    """IRLS weight per unsigned residual (metres); ``scale`` is huber's
    delta or tukey's cutoff c.

      none:  w = 1
      huber: w = min(1, scale / |r|)
      tukey: w = (1 - (r/scale)²)² for |r| < scale, else 0
    """
    if kind == "none":
        return torch.ones_like(residual)
    r = residual.abs()
    if kind == "huber":
        return torch.clamp(scale / r.clamp_min(1e-12), max=1.0)
    if kind == "tukey":
        u = r / max(scale, 1e-12)
        return torch.where(u < 1.0, (1.0 - u * u) ** 2, 0.0)
    raise ValueError(
        f"unknown robust kernel {kind!r}; expected one of {ROBUST_KERNELS}")


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor,
                           damping: float = 1e-6) -> torch.Tensor:
    """Damped Gauss-Newton solve and exact exponentiation.

    ``A`` (..., 6, 6) = Σ w a aᵀ and ``b`` (..., 6) = −Σ w r a with
    a = [p×n; n]. The Levenberg damping ``damping * max(trace(A) / 6,
    1e-12)`` is scaled by the mean of diag(A), so it is unit-consistent
    across the rotation and translation blocks. Returns the (..., 4, 4)
    incremental rigid transform (float32).
    """
    A = A.to(torch.float32)
    b = b.to(torch.float32)
    lam = damping * (torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
                     / 6.0).clamp_min(1e-12)
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    x, _ = torch.linalg.solve_ex(A + lam[..., None, None] * eye, b[..., None],
                                 check_errors=False)
    omega, t = x[..., :3, 0], x[..., 3:, 0]
    angle = torch.sqrt((omega * omega).sum(-1))
    return tf.make_transform(tf.rotation_from_axis_angle(omega, angle), t)


def solve_point_to_plane(src: torch.Tensor, dst: torch.Tensor,
                         normals: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         damping: float = 1e-6) -> torch.Tensor:
    """One Gauss-Newton step of the point-to-plane objective.

    ``src`` (..., N, 3) already carries the cumulative transform (the step
    is about the identity, as for Kabsch); ``dst`` (..., N, 3) are the
    matched target points and ``normals`` (..., N, 3) their unit normals,
    zero rows contributing nothing (their Jacobian row is zero);
    ``weights`` (..., N) are the gate/robust weights (None: all ones).
    Returns the (..., 4, 4) incremental rigid transform.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights.to(torch.float32)
    p = src.to(torch.float32)
    q = dst.to(torch.float32)
    n = normals.to(torch.float32)
    r = (n * (p - q)).sum(-1)                                    # (..., N)
    a = torch.cat([torch.linalg.cross(p, n, dim=-1), n], -1)     # (..., N, 6)
    aw = a * w[..., None]
    A = aw.mT @ a                                                # (..., 6, 6)
    b = -(aw.mT @ r[..., None])[..., 0]                          # (..., 6)
    return solve_normal_equations(A, b, damping).to(src.dtype)


def point_to_plane_rmse(src: torch.Tensor, dst: torch.Tensor,
                        normals: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted RMS of the plane residual n·(p − q) over the point axis."""
    r = (normals * (src - dst)).sum(-1)
    if weights is None:
        return torch.sqrt((r * r).mean(-1))
    w = weights.to(src.dtype)
    return torch.sqrt((r * r * w).sum(-1) / w.sum(-1).clamp_min(1e-12))
