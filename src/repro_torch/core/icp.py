"""ICP, the FPPS pipeline, as one batched eager loop (port of
``repro.core.icp``).

Each iteration runs the paper's four stages (§II): correspondence search,
the distance gate folded into weighted Kabsch, the update of the cumulative
transform (the original source is always re-transformed by it), and the
convergence check ``transform_delta(T_step) <= epsilon``.

Where the reference builds ``lax.while_loop``, ``lax.scan`` and ``vmap``
programs, the port writes one loop over any leading batch dimensions
(``source`` (..., N, 3), ``T`` (..., 4, 4)). A lane whose last step moved
less than epsilon is frozen: its state no longer changes.

  * :func:`icp` stops as soon as no lane is active, at the cost of one host
    sync per iteration (the reference's while loop);
  * :func:`icp_fixed_iterations` and :func:`icp_batch` always run
    ``max_iterations`` with the freeze mask and no host sync (the
    reference's scan and its vmap).

Only the point-to-point minimiser of the paper is ported so far; the
point-to-plane minimiser and the fused single-pass iteration raise
``NotImplementedError`` until slice 3 (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import transform as tf
from repro_torch.core.nn_search import gather_rows, nn_search
from repro_torch.core.point_to_plane import ROBUST_KERNELS, robust_weights
from repro_torch.data.collate import PAD_SENTINEL

MINIMIZERS = ("point_to_point", "point_to_plane")
_LATER = "slice 3 (ROADMAP queue 1, item 4)"


def scrub_nonfinite(points: torch.Tensor | None,
                    valid: torch.Tensor | None = None):
    """Sentinel-mask non-finite rows at the engine boundary (DESIGN.md §12).

    Rows of (..., N, 3) ``points`` holding a NaN or inf are replaced by the
    far ``PAD_SENTINEL`` (never wins an argmin, always fails the gate) and
    dropped from the (..., N) ``valid`` mask. All-finite input comes back
    unchanged; ``points=None`` passes through.
    """
    if points is None:
        return None, valid
    finite = torch.isfinite(points).all(-1)
    valid = finite if valid is None else valid & finite
    return torch.where(valid[..., None], points, PAD_SENTINEL), valid


class ICPParams(NamedTuple):
    """Registration settings; same fields and defaults as the reference."""
    max_iterations: int = 50
    max_correspondence_distance: float = 1.0
    transformation_epsilon: float = 1e-5
    chunk: int = 2048  # target-cloud tile size of the plain NN sweep
    score_dtype: str = "fp32"  # "bf16": half-width distance tiles
    minimizer: str = "point_to_point"  # "point_to_plane": slice 3
    robust_kernel: str = "none"        # | "huber" | "tukey"
    robust_scale: float = 0.5          # huber delta / tukey cutoff, metres
    fused: bool = False  # single-pass fused iteration: slice 3


class ICPState(NamedTuple):
    """Loop state; every field has the batch's leading dimensions."""
    T: torch.Tensor           # (..., 4, 4) cumulative transform
    delta: torch.Tensor       # last incremental transform_delta
    rmse: torch.Tensor        # inlier RMSE after the last step
    iteration: torch.Tensor   # int32
    inlier_frac: torch.Tensor
    degenerate: torch.Tensor  # bool: a step saw zero gate/robust weight


class ICPResult(NamedTuple):
    """Registration result; tensors with the batch's leading dimensions."""
    T: torch.Tensor
    rmse: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    inlier_frac: torch.Tensor
    degenerate: torch.Tensor


# Total weight below this is "no correspondence evidence": the Kabsch
# covariance is all zeros, so the step freezes instead of solving.
_DEGENERATE_WEIGHT_SUM = 1e-6


def _check_params(params: ICPParams) -> None:
    """Raise for settings the port does not run (yet)."""
    if params.minimizer not in MINIMIZERS:
        raise ValueError(f"unknown minimizer {params.minimizer!r}; "
                         f"expected one of {MINIMIZERS}")
    if params.robust_kernel not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {params.robust_kernel!r}; "
                         f"expected one of {ROBUST_KERNELS}")
    if params.minimizer == "point_to_plane":
        raise NotImplementedError("minimizer='point_to_plane' is not ported "
                                  f"yet: {_LATER}")
    if params.fused:
        raise NotImplementedError(f"ICPParams.fused is not ported yet: "
                                  f"{_LATER}")


def params_from_reference(d: dict) -> ICPParams:
    """``ICPParams`` from the reference's ``ICPParams._asdict()``.

    Raises ``ValueError`` on a field the port does not know, so a new
    reference setting cannot be dropped silently.
    """
    unknown = sorted(set(d) - set(ICPParams._fields))
    if unknown:
        raise ValueError(f"reference ICPParams fields unknown to the port: "
                         f"{unknown}")
    return ICPParams(**d)


def result_to_numpy(result: ICPResult) -> ICPResult:
    """The same ``ICPResult`` with every field as a numpy array."""
    return ICPResult(*(np.asarray(x.detach().cpu()) for x in result))


def _icp_iteration(source: torch.Tensor, state: ICPState, params: ICPParams,
                   correspond_fn: Callable,
                   src_valid: torch.Tensor | None = None) -> ICPState:
    """One ICP step for every lane. ``correspond_fn(src_t) -> (d2,
    matched)``; ``src_valid`` (..., N) gives padded rows zero weight and
    keeps them out of the inlier fraction's denominator."""
    dtype = source.dtype
    src_t = tf.transform_points(state.T, source)
    d2, matched = correspond_fn(src_t)
    weights = (d2 <= params.max_correspondence_distance ** 2).to(dtype)
    if src_valid is not None:
        weights = weights * src_valid.to(dtype)
    if params.robust_kernel != "none":
        weights = weights * robust_weights(torch.sqrt(d2.clamp_min(0.0)),
                                           params.robust_kernel,
                                           params.robust_scale)
    wsum = weights.sum(-1)
    # Zero-inlier freeze: with no weight the Kabsch step is singular. Take
    # the identity step instead (the lane then stops), report rmse = inf,
    # and set the sticky ``degenerate`` flag.
    degenerate = wsum <= _DEGENERATE_WEIGHT_SUM
    T_step = tf.estimate_rigid_transform(src_t, matched, weights)
    eye = torch.eye(4, dtype=dtype, device=source.device)
    T_delta = torch.where(degenerate[..., None, None], eye, T_step)
    err = tf.rmse(tf.transform_points(T_delta, src_t), matched, weights)
    if src_valid is None:
        inlier_frac = weights.mean(-1)
    else:
        inlier_frac = wsum / src_valid.to(dtype).sum(-1).clamp_min(1.0)
    return ICPState(T=T_delta @ state.T, delta=tf.transform_delta(T_delta),
                    rmse=torch.where(degenerate, float("inf"), err),
                    iteration=state.iteration + 1, inlier_frac=inlier_frac,
                    degenerate=state.degenerate | degenerate)


def _default_correspond_fn(target: torch.Tensor, params: ICPParams,
                           nn_fn: Callable | None,
                           dst_valid: torch.Tensor | None) -> Callable:
    if nn_fn is None:
        # The plain searcher's exact-d2 epilogue gathers the winners
        # already; ask for them instead of gathering twice.
        def nn_fn(s, t):
            return nn_search(s, t, chunk=params.chunk,
                             score_dtype=params.score_dtype,
                             dst_valid=dst_valid, return_points=True)
    elif dst_valid is not None:
        # Custom searchers take only (src, dst): move masked targets far
        # outside any metric scene so they never win nor pass the gate.
        target = torch.where(dst_valid[..., None], target, PAD_SENTINEL)

    def correspond(src_t):
        out = nn_fn(src_t, target)
        if len(out) == 3:
            return out[0], out[2]
        return out[0], gather_rows(target, out[1])

    return correspond


def _select(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` on active lanes, ``old`` on frozen ones."""
    mask = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
    return torch.where(mask, new, old)


def _run(source, target, params: ICPParams, initial_transform, nn_fn,
         correspond_fn, src_valid, dst_valid, stop_early: bool) -> ICPResult:
    _check_params(params)
    source, src_valid = scrub_nonfinite(source, src_valid)
    target, dst_valid = scrub_nonfinite(target, dst_valid)
    if correspond_fn is None:
        correspond_fn = _default_correspond_fn(target, params, nn_fn,
                                               dst_valid)
    lead = source.shape[:-2]
    dtype, dev = source.dtype, source.device
    if initial_transform is None:
        initial_transform = torch.eye(4, dtype=dtype, device=dev).expand(
            lead + (4, 4))
    inf = torch.full(lead, float("inf"), dtype=dtype, device=dev)
    state = ICPState(T=initial_transform, delta=inf, rmse=inf,
                     iteration=torch.zeros(lead, dtype=torch.int32,
                                           device=dev),
                     inlier_frac=torch.zeros(lead, dtype=dtype, device=dev),
                     degenerate=torch.zeros(lead, dtype=torch.bool,
                                            device=dev))
    eps = params.transformation_epsilon
    for _ in range(params.max_iterations):
        active = state.delta > eps
        if stop_early and not bool(active.any()):
            break
        new = _icp_iteration(source, state, params, correspond_fn, src_valid)
        state = ICPState(*(_select(active, n, o) for n, o in zip(new, state)))
    converged = (state.delta <= eps) & ~state.degenerate
    return ICPResult(T=state.T, rmse=state.rmse, iterations=state.iteration,
                     converged=converged, inlier_frac=state.inlier_frac,
                     degenerate=state.degenerate)


def icp(source: torch.Tensor, target: torch.Tensor | None,
        params: ICPParams = ICPParams(),
        initial_transform: torch.Tensor | None = None,
        nn_fn: Callable | None = None,
        correspond_fn: Callable | None = None,
        src_valid: torch.Tensor | None = None,
        dst_valid: torch.Tensor | None = None) -> ICPResult:
    """Align ``source`` (..., N, 3) onto ``target`` (..., M, 3).

    ``nn_fn(src, dst) -> (d2, idx[, points])`` swaps the correspondence
    searcher (default: the plain chunked brute force with native
    ``dst_valid`` masking); it is called on batched (..., N, 3) clouds.
    ``correspond_fn(src_t) -> (d2, matched)`` replaces the whole stage
    (``target`` may then be None). ``src_valid``/``dst_valid`` mask
    padded rows. Non-finite rows are sentinel-masked first
    (:func:`scrub_nonfinite`). Stops when no lane is active, with one host
    sync per iteration.
    """
    return _run(source, target, params, initial_transform, nn_fn,
                correspond_fn, src_valid, dst_valid, stop_early=True)


def icp_fixed_iterations(source, target, params: ICPParams = ICPParams(),
                         initial_transform=None, nn_fn=None,
                         correspond_fn=None, src_valid=None,
                         dst_valid=None) -> ICPResult:
    """:func:`icp` run for exactly ``max_iterations`` steps with the freeze
    mask and no host sync: a fixed schedule, like the reference's scan."""
    return _run(source, target, params, initial_transform, nn_fn,
                correspond_fn, src_valid, dst_valid, stop_early=False)


def icp_batch(sources: torch.Tensor, targets: torch.Tensor,
              params: ICPParams = ICPParams(),
              initial_transforms: torch.Tensor | None = None,
              nn_fn: Callable | None = None,
              src_valid: torch.Tensor | None = None,
              dst_valid: torch.Tensor | None = None) -> ICPResult:
    """Register ``sources[k]`` (B, N, 3) onto ``targets[k]`` (B, M, 3).

    The fixed-iteration loop over the whole batch at once: the per-lane
    freeze keeps each pair's early-convergence result, so it matches a
    per-pair :func:`icp` to float tolerance. ``src_valid`` (B, N) and
    ``dst_valid`` (B, M) come from ``collate_pairs``; ``initial_transforms``
    is an optional (B, 4, 4) warm start. Every result field has a leading
    batch axis.
    """
    return icp_fixed_iterations(sources, targets, params, initial_transforms,
                                nn_fn=nn_fn, src_valid=src_valid,
                                dst_valid=dst_valid)
