"""Shared by the port's training tests (``tests/test_torch_train.py``,
``tests/test_torch_checkpoint.py``): the reference programs compiled at
XLA's backend optimisation level 0, the bars, and the comparison of the
port's loss and gradients with ``jax.value_and_grad(lm.loss_fn)``.

Bars, fixed from the first run at about twice what it read (the readings
beside each): the loss within ``LOSS_TOL`` absolute (3.4e-4), the global
gradient norm within ``GNORM_RTOL`` relative (1.04e-3), every leaf of
the reference's tree (the port's layers stacked over repeats) within
``LEAF_RTOL`` relative L2 (3.8e-2: mamba2's ``D``, whose gradient sums
the whole sequence; bf16 products flip an ulp per layer and the bf16
scatter-add of repeated tokens into the embedding table rounds in another
order); a 10-step or accumulated trajectory's losses within ``TRAJ_TOL``
(9.8e-4) and its final parameters within ``PARAM_RTOL`` relative L2 over
the whole tree (1.5e-3).
"""
import jax
import numpy as np
import torch

from repro.configs import get_smoke as jsmoke
from repro.models import lm as jlm
from repro_torch.configs import get_smoke
from repro_torch.models import lm as tlm

FAST_COMPILE = {"xla_backend_optimization_level": 0}
LOSS_TOL = 7e-4
GNORM_RTOL = 2e-3
LEAF_RTOL = 8e-2
TRAJ_TOL = 2e-3
PARAM_RTOL = 3e-3


def compiled(fn, *args, static=()):
    """``fn`` jitted with the ``static`` argument positions and compiled
    for ``args`` with ``FAST_COMPILE``."""
    return jax.jit(fn, static_argnums=static).lower(*args).compile(
        FAST_COMPILE)


def rel(ref, got) -> float:
    """Relative L2 distance of ``got`` from ``ref``."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def leaves_of(tree, path=()):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_of(tree[k], path + (k,))
    else:
        yield path, tree


def numpy_tree(tree):
    """A nested dict of tensors or arrays as one of numpy arrays."""
    return {k: numpy_tree(v) if isinstance(v, dict) else
            (v.detach().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
            for k, v in tree.items()}


def lm_batch(cfg, b, s, seed, mask=False):
    """Seeded inputs and labels for ``cfg`` (tokens, or embeddings for an
    embeds-input arch), with a 0/1 mask if asked."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                     dtype=np.int32)
    else:
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.1).astype(np.float32)
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def port_grads(model, cfg, batch, remat="none"):
    """(loss, metrics, gradients by parameter name) of the port."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = tlm.loss_fn(
        model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat)
    loss.backward()
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def reference_grads(arch, tree, batches):
    """The reference's ((loss, metrics), grads) on ``tree`` for each of
    ``batches``, in one compiled program."""
    jcfg = jsmoke(arch)
    grad = jax.value_and_grad(jlm.loss_fn, has_aux=True)
    fn = lambda p, bs: [grad(p, jcfg, b, "none") for b in bs]  # noqa: E731
    return compiled(fn, tree, batches)(tree, batches)


def grads_case(arch, model=None, masks=(False, True), s=16, seed=5):
    """Both packages' loss, metrics and gradients on ``arch``'s smoke
    config and weights ``init_params_numpy(cfg, 0)`` (the port's from
    ``model`` if given), for each of ``masks`` (without or with a 0/1
    mask): -> (cfg, {masked: reference's}, {masked: port's})."""
    cfg = get_smoke(arch)
    tree = tlm.init_params_numpy(cfg, 0)
    batch = lm_batch(cfg, 2, s, seed, mask=True)
    nomask = {k: v for k, v in batch.items() if k != "mask"}
    batches = [batch if m else nomask for m in masks]
    ref = reference_grads(arch, tree, batches)
    if model is None:
        model = tlm.params_from_reference(tree, cfg, "cpu", trainable=True)
    return (cfg, dict(zip(masks, ref)),
            {m: port_grads(model, cfg, b) for m, b in zip(masks, batches)})


def hold_grads(cfg, ref, got):
    """The port's (loss, metrics, grads) held to the reference's
    ((loss, metrics), grads) within the bars; -> the readings."""
    (jloss, jmet), jgrads = ref
    loss, met, grads = got
    port = numpy_tree(tlm.to_reference(cfg, grads))
    jg = numpy_tree(jgrads)
    worst = {}
    for path, g in leaves_of(jg):
        node = port
        for k in path:
            node = node[k]
        worst["/".join(path)] = rel(g, node)
    jnorm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                              for _, g in leaves_of(jg))))
    tnorm = float(np.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads.values())))
    out = dict(loss=abs(loss - float(jloss)),
               nll=abs(met["nll"] - float(jmet["nll"])),
               aux=abs(met["aux"] - float(jmet["aux"])),
               gnorm=abs(tnorm - jnorm) / jnorm,
               leaf=max(worst.values()), leaf_at=max(worst, key=worst.get))
    assert out["loss"] <= LOSS_TOL and out["nll"] <= LOSS_TOL, out
    assert out["aux"] <= LOSS_TOL, out
    assert out["gnorm"] <= GNORM_RTOL, out
    assert out["leaf"] <= LEAF_RTOL, out
    return out


def hold_run(ref, got):
    """Two runs' (losses, final parameter tree) within ``TRAJ_TOL`` and
    ``PARAM_RTOL``; -> (worst loss difference, parameters' relative L2)."""
    steps = max(abs(a - b) for a, b in zip(ref[0], got[0]))
    params = rel(np.concatenate([a.ravel() for _, a in leaves_of(ref[1])]),
                 np.concatenate([a.ravel() for _, a in leaves_of(got[1])]))
    assert steps <= TRAJ_TOL and params <= PARAM_RTOL, (steps, params)
    return steps, params
