"""AdamW and Adafactor (port of ``repro.optim.optimizers``).

The reference's formulas, op for op, in fp32: the global-norm clip first,
the step counted before the learning rate is read, the bias corrections
of an fp32 step, the weight decay inside the update; Adafactor adds
``eps`` to g², decays with ``min(decay, 1 - t^-0.8)`` and divides by
``max(1, rms(u) / clip_threshold)``. ``torch.optim.AdamW`` rounds its bias
correction and weight decay in another order, so it is not used.

The port's optimizers work in place on a model's ``nn.Parameter``s (the
reference's jitted step donates its state, so the old one is gone there
too): ``init(model) -> OptState`` and ``update(grads, state, model) ->
(model, OptState)``, ``grads`` a dict of the model's parameter names to
gradients. The step count stays on the host (an int), so the schedule and
the bias corrections are host scalars and a step makes no host sync.

Layout: AdamW is elementwise and keeps its moments per port parameter
(``inner = {"m": {name: ...}, "v": {name: ...}}``). Adafactor factors
every leaf of two or more dims, and the reference's leaves are its
``groups`` leaves stacked over the repeats: a stacked norm scale (reps, d)
is factored, and the update clip's rms spans the stack. So Adafactor works
on the reference's leaves (``models.lm.reference_layout``; a model without
an arch config, every parameter its own leaf): its state is keyed by the
reference's "/"-joined paths, each step stacks a leaf's gradients and
parameters, and writes the updated repeats back.
``Optimizer.state_logical_axes(param_axes)`` gives the state's logical
axes over the reference's state layout (``train_step.state_to_reference``):
AdamW's ``m`` / ``v`` mirror the parameters, Adafactor's factored moments
take a leaf's names but the last (``vr``) or the second last (``vc``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.launch.partition import map_names
from repro_torch.models import lm

f32 = np.float32


class OptState(NamedTuple):
    step: int
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.nn.Module], OptState]
    update: Callable[[dict, OptState, torch.nn.Module],
                     tuple[torch.nn.Module, OptState]]
    name: str = ""
    axes_fn: Callable[[Any], OptState] | None = None

    def state_logical_axes(self, param_axes):
        """Optimizer-state logical axes mirroring param axes (a tree of
        logical-name tuples in the reference's parameter layout)."""
        return self.axes_fn(param_axes)


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (every gradient times min(1, max_norm / max(norm, 1e-12)), the
    global L2 norm as an fp32 device scalar)."""
    leaves = list(grads.values())
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    return dict(zip(grads, torch._foreach_mul(leaves, scale))), gnorm


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in params.named_parameters()}
        return OptState(step=0, inner={"m": zeros(), "v": zeros()})

    @torch.no_grad()
    def update(grads, state: OptState, params):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = float(lr_fn(step))
        b1c = float(f32(1.0) - f32(b1) ** f32(step))
        b2c = float(f32(1.0) - f32(b2) ** f32(step))
        names = [n for n, _ in params.named_parameters()]
        p = [params.get_parameter(n) for n in names]
        g = [grads[n].float() for n in names]
        m = [state.inner["m"][n] for n in names]
        v = [state.inner["v"][n] for n in names]
        # the formulas one elementwise op at a time over every leaf at once
        # (multi-tensor kernels; no op fused, so each rounds as the
        # reference's): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        del g2
        # delta = (m / b1c) / (sqrt(v / b2c) + eps) + wd p; p -= lr delta
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_div_(delta, den)
        del den
        torch._foreach_add_(delta, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(p, delta)
        return params, OptState(step=step, inner=state.inner)

    return Optimizer(init=init, update=update, name="adamw",
                     axes_fn=lambda param_axes: OptState(
                         step=(), inner={"m": param_axes, "v": param_axes}))


def leaf_groups(params) -> list:
    """The optimizer's leaves: ``(key, names, stacked)``, ``key`` the
    reference's "/"-joined path and ``names`` the port parameters it stacks
    (``models.lm.reference_layout``), or each parameter alone for a model
    without an arch config."""
    cfg = getattr(params, "cfg", None)
    if cfg is None:
        return [(n, [n], False) for n, _ in params.named_parameters()]
    return [("/".join(path), names, stacked)
            for path, names, stacked in lm.reference_layout(cfg)]


def _leaf(tensors: list, stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


def adafactor(lr_fn, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              clip_norm: float = 1.0) -> Optimizer:
    """Factored-second-moment Adafactor (Shazeer & Stern, 2018), no
    momentum, on the reference's (stacked) leaves.

    For ndim>=2 leaves: row/col running means of g² over the last two dims
    (leading stack dims kept). For vectors/scalars: full second moment."""
    def init(params):
        named = dict(params.named_parameters())
        inner = {}
        for key, names, stacked in leaf_groups(params):
            p = named[names[0]]
            shape = ((len(names),) if stacked else ()) + tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32,
                                          device=p.device)
            inner[key] = ({"vr": zeros(shape[:-1]),
                           "vc": zeros(shape[:-2] + shape[-1:])}
                          if len(shape) >= 2 else {"v": zeros(shape)})
        return OptState(step=0, inner=inner)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = float(lr_fn(step))
        # bias-corrected decay (Adafactor's \hat{\beta}_t)
        beta = min(f32(decay), f32(1.0) - f32(step) ** f32(-0.8))
        keep = float(f32(1.0) - beta)
        beta = float(beta)
        named = dict(params.named_parameters())
        for key, names, stacked in leaf_groups(params):
            g = _leaf([grads[n] for n in names], stacked).float()
            p = _leaf([named[n] for n in names], stacked)
            s = state.inner[key]
            g2 = g * g + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_(keep * (g2.sum(-1) / g2.shape[-1]))
                s["vc"].mul_(beta).add_(keep * (g2.sum(-2) / g2.shape[-2]))
                vr, vc = s["vr"], s["vc"]
                rms_row = vr / (vr.sum(-1, keepdim=True) / vr.shape[-1])
                denom = torch.sqrt(rms_row[..., None] * vc[..., None, :])
                u = g / torch.clamp_min(denom, 1e-30)
            else:
                s["v"].mul_(beta).add_(keep * g2)
                u = g / torch.sqrt(s["v"])
            # update clipping by RMS
            urms = torch.sqrt((u * u).sum() / u.numel())
            u = u / torch.clamp_min(urms / clip_threshold, 1.0)
            delta = u + weight_decay * p.float()
            new = p - lr * delta
            for r, name in enumerate(names):
                named[name].copy_(new[r] if stacked else new)
        return params, OptState(step=step, inner=state.inner)

    def axes_fn(param_axes):
        def one(names):
            if len(names) >= 2:
                return {"vr": names[:-1], "vc": names[:-2] + names[-1:]}
            return {"v": names}
        return OptState(step=(), inner=map_names(
            lambda names, _: one(names), param_axes))

    return Optimizer(init=init, update=update, name="adafactor",
                     axes_fn=axes_fn)


def pick_optimizer(total_params: int, lr_fn) -> Optimizer:
    """Production default: AdamW below 100B total params, Adafactor above
    (fp32 m+v for 405B/235B would not fit the reference's HBM budget)."""
    if total_params >= 100e9:
        return adafactor(lr_fn)
    return adamw(lr_fn)
