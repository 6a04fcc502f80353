"""Robust IRLS weights (port of ``repro.core.point_to_plane``, in part).

Only what the point-to-point path uses is here: ``ROBUST_KERNELS`` and
:func:`robust_weights`, applied on top of the distance gate. The
point-to-plane Gauss-Newton solve comes with slice 3 (ROADMAP queue 1,
item 4).
"""
from __future__ import annotations

import torch

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
