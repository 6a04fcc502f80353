"""Per-frame registration health: OK / SUSPECT / FAILED verdicts (§12).

Port of ``repro.core.health``: the same signals, thresholds, arithmetic
(numpy, float64) and ``reasons`` strings. The one change is where the
result comes from: :func:`assess_registration` takes the port's
``ICPResult`` (tensors, possibly on the card) and fetches it to the host
as one copy (:func:`host_result`), not as one sync per field.

A streaming registration stack has plenty of per-frame quality signals
lying around — it just never reads them together. This module distils the
signals already latent in the pipeline into one
:class:`RegistrationHealth` verdict the recovery cascade
(``repro_torch.core.odometry``) can act on:

  * **inlier fraction** — gate+robust weight mass over valid source rows
    (``ICPResult.inlier_frac``). Collapses under occlusion, dropout and
    low overlap.
  * **final inlier RMSE** — the last iteration's weighted residual
    (``ICPResult.rmse``). A converged-but-high value means the optimiser
    stalled on a biased fixed point (ghost clusters, heavy-tailed noise);
    the per-iteration *trend* ends here, so this is the trend's endpoint.
  * **degenerate flag** — the zero-inlier freeze (``core.icp``): no
    correspondence evidence at all.
  * **pose jump vs. the motion model** — translation / rotation distance
    between the registered pose and the constant-velocity prediction. A
    physically implausible jump on a smooth platform is the classic
    symptom of a wrong-basin convergence, *invisible* to residual metrics
    (the wrong basin often fits tightly).
  * **grid out-of-lattice fraction** — ``GridQueryStats.out_of_lattice``
    of the scan against the submap grid: how much of the scan falls
    outside mapped space (low overlap / teleport symptom).
  * **normal-equation conditioning** — eigenvalue ratio of the 6x6
    Gauss-Newton normal matrix ``A = Σ w·a aᵀ`` (``a = [p×n; n]``, the
    point-to-plane system of ``core.point_to_plane``; the fused kernel's
    ``PlaneMoments.A`` is exactly this matrix). A near-singular A means
    the scene does not constrain all six DoF — corridors, tunnels, open
    fields — and the solve amplifies noise along the null directions.

Thresholds are two-tier (``suspect_*`` / ``failed_*``): any FAILED signal
fails the frame, any SUSPECT signal marks it suspect, otherwise OK. All
inputs are host scalars/arrays — assessment happens between frames, off
the device hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

OK = "ok"
SUSPECT = "suspect"
FAILED = "failed"
VERDICTS = (OK, SUSPECT, FAILED)

_RANK = {OK: 0, SUSPECT: 1, FAILED: 2}


class HealthThresholds(NamedTuple):
    """Two-tier signal thresholds. ``suspect_*`` trips the cascade's
    retry tiers; ``failed_*`` means the result must not be trusted even
    as a hint. Defaults are sized for the synthetic KITTI protocol
    (metre-scale scenes, ~1 m gates); ``inf`` disables a signal."""

    # Inlier mass is robust-weight mass, not a correspondence count: with
    # a huber kernel healthy streaming frames sit near 0.3-0.5, so the
    # suspect line must sit well below the healthy band.
    suspect_inlier_frac: float = 0.22   # below → SUSPECT
    failed_inlier_frac: float = 0.08    # below → FAILED
    suspect_rmse: float = 0.60          # above → SUSPECT (metres)
    failed_rmse: float = 1.50
    suspect_pose_jump: float = 1.00     # metres vs. motion-model prediction
    failed_pose_jump: float = 3.00
    suspect_rot_jump: float = 0.20      # radians vs. prediction
    failed_rot_jump: float = 0.60
    suspect_out_of_lattice: float = 0.25
    failed_out_of_lattice: float = 0.60
    # 6x6 normal-equation eigenvalue ratio of the scan's own plane
    # system: a clean 360° LiDAR-like scan sits near 1e3; sector crops /
    # heavy occlusion push past 1e4 (pose under-constrained along the
    # unseen directions). Degradation-only by default (failed = inf): a
    # sparse scan whose *normals* collapse (extreme dropout reads 1e30+)
    # can still be registered point-to-point, so conditioning justifies
    # quarantine, not a hard reject.
    suspect_condition: float = 6.0e3
    failed_condition: float = float("inf")


def health_thresholds_from_reference(d: dict) -> HealthThresholds:
    """``HealthThresholds`` from the reference's ``_asdict()``. Raises
    ``ValueError`` on a field the port does not know."""
    unknown = sorted(set(d) - set(HealthThresholds._fields))
    if unknown:
        raise ValueError(f"reference HealthThresholds fields unknown to the "
                         f"port: {unknown}")
    return HealthThresholds(**d)


class RegistrationHealth(NamedTuple):
    """One frame's verdict plus the signals that produced it. ``reasons``
    names every non-OK signal as ``"signal:level"`` so logs and tests can
    see *why* a frame tripped, not just that it did."""

    verdict: str
    inlier_frac: float
    rmse: float
    degenerate: bool
    pose_jump_m: float
    rot_jump_rad: float
    out_of_lattice: float
    condition: float
    reasons: tuple[str, ...]

    @property
    def ok(self) -> bool:
        return self.verdict == OK


def pose_jump(T: np.ndarray, T_ref: np.ndarray) -> tuple[float, float]:
    """(translation metres, rotation radians) between two 4x4 poses."""
    T = np.asarray(T, np.float64)
    T_ref = np.asarray(T_ref, np.float64)
    dt = float(np.linalg.norm(T[:3, 3] - T_ref[:3, 3]))
    R = T[:3, :3] @ T_ref[:3, :3].T
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return dt, float(np.arccos(cos))


def plane_normal_matrix(points: np.ndarray, normals: np.ndarray,
                        valid: np.ndarray | None = None,
                        weights: np.ndarray | None = None) -> np.ndarray:
    """The 6x6 Gauss-Newton normal matrix ``A = Σ w·a aᵀ``, ``a=[p×n; n]``.

    This is the matrix the point-to-plane step solves
    (``core.point_to_plane``) and the fused kernel accumulates as
    ``PlaneMoments.A`` — built host-side from a cloud + normals so health
    probes (and tests) can measure observability without running a solve.
    """
    p = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    a = np.concatenate([np.cross(p, n), n], axis=-1)          # (N, 6)
    w = np.ones(p.shape[0]) if weights is None else np.asarray(weights,
                                                               np.float64)
    if valid is not None:
        w = w * np.asarray(valid, np.float64)
    return (a * w[:, None]).T @ a


def normal_equation_condition(A: np.ndarray) -> float:
    """Eigenvalue ratio λ_max/λ_min of a symmetric PSD 6x6 system.

    ~1e0–1e3: well-observed pose. Beyond ``suspect_condition`` the scene
    leaves some rigid motion unconstrained (corridor: translation along
    the axis; plane: the two in-plane translations + yaw) and the solve
    amplifies noise along those directions.
    """
    w = np.linalg.eigvalsh(np.asarray(A, np.float64))
    lo = max(float(w[0]), 1e-30)
    return float(w[-1]) / lo


def _grade(reasons: list, name: str, value: float, suspect: float,
           failed: float, *, above: bool = True) -> str:
    """Grade one scalar signal; non-finite values of an *error-like*
    signal (above=True) are FAILED outright."""
    if not np.isfinite(value):
        level = FAILED if above else OK
    elif above:
        level = (FAILED if value >= failed
                 else SUSPECT if value >= suspect else OK)
    else:
        level = (FAILED if value <= failed
                 else SUSPECT if value <= suspect else OK)
    if level != OK:
        reasons.append(f"{name}:{level}")
    return level


def host_result(result):
    """``result`` with its tensor fields as numpy arrays, fetched together.

    An ``ICPResult`` (or a plain tuple) of tensors, on the card or the CPU,
    is packed into one float64 vector and fetched with one ``.cpu()``, then
    split back into fields of their own shapes and dtypes: float32, int32
    and bool values pass through float64 exactly, so each field holds the
    bits that its own ``.cpu()`` would give. Anything else (the
    reference's results, host fakes) is returned as it is.
    """
    if not (isinstance(result, tuple) and result
            and all(isinstance(x, torch.Tensor) for x in result)):
        return result
    dev = result[0].device
    flat = torch.cat([x.to(dev, torch.float64).reshape(-1)
                      for x in result]).cpu().numpy()
    out, at = [], 0
    for x in result:
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        out.append(flat[at:at + x.numel()].reshape(tuple(x.shape))
                   .astype(dtype))
        at += x.numel()
    return type(result)(*out) if hasattr(result, "_fields") else tuple(out)


def assess_registration(result, *, predicted: np.ndarray | None = None,
                        thresholds: HealthThresholds = HealthThresholds(),
                        out_of_lattice: float | None = None,
                        condition: float | None = None) -> RegistrationHealth:
    """Distil one registration into a :class:`RegistrationHealth`.

    ``result`` is an ``ICPResult``-shaped object (``T``, ``rmse``,
    ``inlier_frac``, ``degenerate`` — host or device scalars).
    ``predicted`` is the motion model's pose prediction; without it the
    jump signals are skipped (first frames, pairwise protocol).
    ``out_of_lattice`` / ``condition`` are optional probe results
    (``neighborhood_stats`` / :func:`normal_equation_condition`) — pass
    what the call site has; absent signals never trip.
    """
    t = thresholds
    result = host_result(result)
    inlier = float(result.inlier_frac)
    rmse = float(result.rmse)
    degenerate = bool(result.degenerate)
    pose = np.asarray(result.T, np.float64)

    reasons: list[str] = []
    levels = [
        _grade(reasons, "inlier_frac", inlier, t.suspect_inlier_frac,
               t.failed_inlier_frac, above=False),
        _grade(reasons, "rmse", rmse, t.suspect_rmse, t.failed_rmse),
    ]
    if degenerate:
        levels.append(FAILED)
        reasons.append("degenerate:failed")
    if not np.all(np.isfinite(pose)):
        levels.append(FAILED)
        reasons.append("nonfinite_pose:failed")
        jump_t = jump_r = float("inf")
    elif predicted is not None:
        jump_t, jump_r = pose_jump(pose, predicted)
        levels.append(_grade(reasons, "pose_jump", jump_t,
                             t.suspect_pose_jump, t.failed_pose_jump))
        levels.append(_grade(reasons, "rot_jump", jump_r,
                             t.suspect_rot_jump, t.failed_rot_jump))
    else:
        jump_t = jump_r = 0.0
    if out_of_lattice is not None:
        levels.append(_grade(reasons, "out_of_lattice",
                             float(out_of_lattice),
                             t.suspect_out_of_lattice,
                             t.failed_out_of_lattice))
    if condition is not None:
        levels.append(_grade(reasons, "condition", float(condition),
                             t.suspect_condition, t.failed_condition))

    verdict = max(levels, key=_RANK.get, default=OK)
    return RegistrationHealth(
        verdict=verdict, inlier_frac=inlier, rmse=rmse,
        degenerate=degenerate, pose_jump_m=float(jump_t),
        rot_jump_rad=float(jump_r),
        out_of_lattice=float(out_of_lattice or 0.0),
        condition=float(condition or 1.0), reasons=tuple(reasons))
