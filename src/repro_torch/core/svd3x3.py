"""Batched 3x3 SVD via one-sided Jacobi rotations (port of
``repro.core.svd3x3``).

The reference avoids ``jnp.linalg.svd`` for a fixed-latency, backend-
independent routine, and its sign conventions feed the Kabsch step, so the
port keeps the same algorithm rather than calling ``torch.linalg.svd``:
8 fixed sweeps over the pivots (0,1), (0,2), (1,2), the same Golub & Van
Loan ``tau``/sign rule, singular values sorted descending, and the same
rank-deficiency repair of U. Everything runs over any leading batch
dimensions, so one call serves a whole frame batch.

Run eagerly on the card this is a few hundred small launches per call;
fusing it is later work (see ``PERF.md``).
"""
from __future__ import annotations

import torch

_PIVOTS = ((0, 1), (0, 2), (1, 2))
_EPS = 1e-30


def _jacobi_rotation(a_pp, a_qq, a_pq):
    """Givens (c, s) zeroing the (p,q) off-diagonal of the implicit Gram
    matrix (Golub & Van Loan §8.4), elementwise over the batch."""
    small = a_pq.abs() < _EPS
    tau = (a_qq - a_pp) / (2.0 * torch.where(small, _EPS, a_pq))
    # sign(0) must be +1 here: a_pp == a_qq with a_pq != 0 needs a 45° turn.
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t


def _rotate_columns(X, p, q, c, s):
    """X <- X G in place, with G rotating columns p and q."""
    xp, xq = X[..., :, p], X[..., :, q]
    new_p = c * xp - s * xq
    new_q = s * xp + c * xq
    X[..., :, p] = new_p
    X[..., :, q] = new_q


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.sqrt(_dot(v, v)).clamp_min(_EPS)[..., None]


def _any_orthogonal(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit ``u``: Gram-Schmidt of the axis
    least aligned with it (first such axis on ties)."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    axis = eye[u.abs().argmin(-1)]
    return _unit(axis - _dot(axis, u)[..., None] * u)


def svd3x3(M: torch.Tensor, sweeps: int = 8):
    """SVD of (..., 3, 3) matrices: ``(U, S, Vt)`` with M = U diag(S) Vt.

    Singular values come sorted descending; U and Vt are orthogonal, with
    no sign convention beyond S >= 0 (the reference's contract).
    """
    dtype = M.dtype
    A = M.to(torch.float32).clone()
    V = torch.eye(3, dtype=torch.float32, device=M.device).expand_as(A)
    V = V.clone()
    for _ in range(sweeps):
        for p, q in _PIVOTS:
            col_p, col_q = A[..., :, p], A[..., :, q]
            c, s = _jacobi_rotation(_dot(col_p, col_p), _dot(col_q, col_q),
                                    _dot(col_p, col_q))
            c, s = c[..., None], s[..., None]
            _rotate_columns(A, p, q, c, s)
            _rotate_columns(V, p, q, c, s)

    # Column norms are the singular values; normalised columns are U.
    s = torch.sqrt((A * A).sum(-2))
    order = torch.argsort(-s, dim=-1, stable=True)
    s = torch.gather(s, -1, order)
    cols = order[..., None, :].expand_as(A)
    A = torch.gather(A, -1, cols)
    V = torch.gather(V, -1, cols)
    # Rank-deficient columns (zero singular value) get a synthesised
    # orthonormal direction, sign-matched so U diag(S) Vt is unchanged;
    # valid Jacobi columns are kept (forcing det(U)=+1 would break
    # reflections).
    U = A / s.clamp_min(_EPS)[..., None, :]
    tol = 1e-12 * s[..., 0].clamp_min(_EPS)
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=M.device)
    u0 = torch.where((s[..., 0] > tol)[..., None], U[..., :, 0], e0)
    u1_raw = U[..., :, 1] - _dot(U[..., :, 1], u0)[..., None] * u0
    u1_norm = torch.sqrt(_dot(u1_raw, u1_raw))
    keep1 = (s[..., 1] > tol) & (u1_norm > 1e-20)
    u1 = torch.where(keep1[..., None],
                     u1_raw / u1_norm.clamp_min(_EPS)[..., None],
                     _any_orthogonal(u0))
    u2_cross = torch.linalg.cross(u0, u1, dim=-1)
    sign = torch.where(_dot(u2_cross, U[..., :, 2]) < 0.0, -1.0, 1.0)
    u2 = torch.where((s[..., 2] > tol)[..., None],
                     sign[..., None] * u2_cross, u2_cross)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U.to(dtype), s.to(dtype), V.mT.to(dtype)
