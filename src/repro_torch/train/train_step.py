"""Train step: loss and gradients, then the optimizer update, with
microbatch gradient accumulation and remat (port of
``repro.train.train_step``).

A :class:`TrainState` holds the trainable model (``lm.DecoderLM`` with fp32
``nn.Parameter`` leaves, the reference's ``init_state(..., dtype=
float32)`` masters) and the optimizer state. The step works in place, as
the reference's jitted step donates its state: it returns the same model,
its parameters updated, and leaves the step's (unclipped, summed)
gradients in their ``.grad``. It makes no host sync: the loss and metrics
are device scalars.

On the card the step runs under ``torch.use_deterministic_algorithms``
(with the cuBLAS workspace setting it requires): two runs of a step must
give the same bits, and a resumed run the uninterrupted one's, so an op
with no deterministic kernel raises instead of adding in another order.
The ops of the training path all have one: the backward of the embedding
lookup and of the MoE's row gathers (``index_put_`` with accumulation)
adds repeated rows in a fixed order on the card with or without the mode.

``state_logical_axes`` gives the state's logical axes over the
reference's state layout (``state_to_reference``), for
``launch.partition.param_sharding``. ``make_train_step(...,
grad_shardings=)`` takes the parameters' shardings (a tree of
``ShardSpec`` in that layout) and checks them against the parameter tree;
as in the reference, they change no value, so a step gives the same bits
with and without them (the reference pins its accumulation buffer to them
for GSPMD; the port lays out nothing).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.partition import ShardSpec
from repro_torch.models import lm
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import OptState

# the cuBLAS workspace setting that deterministic mode requires (CUDA >=
# 10.2): 4096 KiB x 8, the size PyTorch already gives cuBLAS on Hopper
CUBLAS_WORKSPACE = ":4096:8"


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def init_state(seed: int, cfg: ArchConfig, optimizer: Optimizer,
               device="cuda") -> TrainState:
    """fp32 masters from ``lm.init_params_numpy(cfg, seed)`` (the
    reference's ``init_state`` takes a PRNG key, which cannot be reproduced
    here) and the optimizer's zero state, on ``device`` (default
    ``"cuda"``; raises without a card)."""
    params = lm.init_params(cfg, seed, device, trainable=True)
    return TrainState(params=params, opt_state=optimizer.init(params))


def abstract_state(cfg: ArchConfig, optimizer: Optimizer) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device: allocates
    nothing (the restore target)."""
    params = lm.init_abstract(cfg)
    return TrainState(params=params, opt_state=optimizer.init(params))


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` for the block on a CUDA
    ``device`` (restored after it); nothing on the CPU, whose kernels add
    in a fixed order."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _on(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on ``device`` (numpy arrays copied;
    tensors already there untouched)."""
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def state_logical_axes(cfg: ArchConfig, optimizer: Optimizer
                       ) -> TrainState:
    """Logical axes of the state in the reference's layout
    (``state_to_reference``): the parameters' and the optimizer's."""
    p_axes = lm.param_logical_axes(cfg)
    return TrainState(params=p_axes,
                      opt_state=optimizer.state_logical_axes(p_axes))


def check_grad_shardings(cfg: ArchConfig, grad_shardings) -> None:
    """Raise ``ValueError`` unless ``grad_shardings`` has a sharding (a
    ``ShardSpec``) for each leaf of the reference's parameter tree and for
    nothing else, each one that splits its leaf evenly."""
    shapes = lm.param_shapes(cfg)
    seen = 0

    def walk(node, ref, path):
        nonlocal seen
        if not isinstance(node, dict) or set(node) != set(ref):
            raise ValueError(f"grad_shardings at {'/'.join(path) or '/'}: "
                             f"not the parameter tree's keys")
        for k, v in node.items():
            if isinstance(ref[k], dict):
                walk(v, ref[k], path + (k,))
                continue
            shape = ref[k][0]
            if not isinstance(v, ShardSpec) or len(v.spec) > len(shape):
                raise ValueError(f"grad_shardings {'/'.join(path + (k,))}: "
                                 f"{v!r} does not fit a {shape} leaf")
            v.shard_shape(shape)
            seen += 1
    walk(grad_shardings, shapes, ())
    if seen != len(lm.reference_layout(cfg)):
        raise ValueError("grad_shardings does not cover every leaf")


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    remat: str = "full", accum_steps: int = 1,
                    grad_shardings=None):
    """-> train_step(state, batch) -> (state, metrics).

    ``accum_steps > 1`` splits the batch's leading dim into microbatches
    and accumulates fp32 gradients (autograd adds each microbatch's into
    ``.grad``: 0 + g1 + g2 ..., the reference's scan); the gradients and
    the loss are divided by ``accum_steps``, and only ``loss`` is
    returned, as in the reference (``metrics = {}`` on that path).
    ``grad_shardings`` (optional, the parameters' ``ShardSpec`` tree in
    the reference's layout) is checked against the parameter tree
    (:func:`check_grad_shardings`) and changes no value."""
    if grad_shardings is not None:
        check_grad_shardings(cfg, grad_shardings)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        named = dict(params.named_parameters())
        device = next(iter(named.values())).device
        batch = _on(batch, device)
        for p in named.values():
            p.grad = None
        with deterministic(device):
            if accum_steps == 1:
                loss, metrics = lm.loss_fn(params, cfg, batch, remat)
                loss.backward()
                grads = {n: p.grad for n, p in named.items()}
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                b = next(iter(batch.values())).shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{accum_steps} microbatches")
                mb = b // accum_steps
                loss = torch.zeros((), device=device)
                for i in range(accum_steps):
                    micro = {k: v[i * mb:(i + 1) * mb]
                             for k, v in batch.items()}
                    mloss, _ = lm.loss_fn(params, cfg, micro, remat)
                    mloss.backward()
                    loss = loss + mloss.detach()
                grads = {n: p.grad / accum_steps for n, p in named.items()}
                loss = loss / accum_steps
                metrics = {}
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 params)
        metrics["loss"] = loss.detach()
        return TrainState(params=params, opt_state=opt_state), metrics

    return train_step


# ---------------------------------------------------------------------------
# the reference's state layout
# ---------------------------------------------------------------------------
def _field(obj, name: str):
    """A NamedTuple's field or a dict's key (a reference state converted to
    numpy keeps its NamedTuples; one read back by keys is a dict)."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def state_to_reference(state: TrainState) -> dict:
    """The port's state in the reference's tree layout, as tensors (on the
    state's device): ``{"params": tree, "opt_state": {"step": int32
    scalar, "inner": ...}}``, ``groups`` leaves stacked over repeats, AdamW's
    ``inner`` ``{"m": tree, "v": tree}``, Adafactor's the parameter tree
    with ``{"vr", "vc"}`` or ``{"v"}`` at each leaf. Flattened with "::"
    these are the reference's checkpoint keys."""
    model = state.params
    cfg = model.cfg
    named = dict(model.named_parameters())
    inner = state.opt_state.inner
    if set(inner) == {"m", "v"}:
        ref_inner = {k: lm.to_reference(cfg, inner[k]) for k in ("m", "v")}
    else:
        ref_inner = {}
        for path, _, _ in lm.reference_layout(cfg):
            node = ref_inner
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = inner["/".join(path)]
    device = next(iter(named.values())).device
    step = torch.tensor(state.opt_state.step, dtype=torch.int32,
                        device=device)
    return {"params": lm.to_reference(cfg, named),
            "opt_state": {"step": step, "inner": ref_inner}}


def state_from_reference(tree, cfg: ArchConfig, device="cuda") -> TrainState:
    """A reference ``TrainState`` (its arrays as numpy, NamedTuples kept or
    read back as dicts: ``params``, ``opt_state.step``,
    ``opt_state.inner``) as the port's, on ``device`` (default ``"cuda"``;
    raises without a card). The optimizer's layout is read from
    ``inner``: ``{"m", "v"}`` is AdamW's, the parameter tree Adafactor's."""
    dev = resolve_device(device)
    fp32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    params = lm.params_from_reference(_field(tree, "params"), cfg, dev,
                                      trainable=True)
    opt = _field(tree, "opt_state")
    inner = _field(opt, "inner")
    if set(inner) == {"m", "v"}:
        port_inner = {k: {n: fp32(a) for n, a in
                          lm.from_reference(cfg, inner[k]).items()}
                      for k in ("m", "v")}
    else:
        port_inner = {}
        for path, _, _ in lm.reference_layout(cfg):
            leaf = inner
            for key in path:
                leaf = leaf[key]
            port_inner["/".join(path)] = {k: fp32(v) for k, v in leaf.items()}
    return TrainState(params=params, opt_state=OptState(
        step=int(np.asarray(_field(opt, "step"))), inner=port_inner))
