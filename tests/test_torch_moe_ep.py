"""Slice 12 of the port against the reference, on the CPU: the
expert-parallel MoE (``models/moe_ep.py``) and the dispatch that picks it
(``lm._moe_dispatch``).

The reference's 8-device ``moe_forward_ep`` runs once for the module in a
process of its own (``tests/_torch_ep_ref.py``, forced host devices) on
numpy inputs made here: ``moe_ep_worker.py``'s config (d 32, 8 experts of
16, top-2, one shared) at capacity factor 8.0 (no pair dropped) and 1.0
(each shard drops pairs), x (4, 64, 32) so each of the (2, 4) mesh's
devices routes 2 x 16 tokens. The port runs on a (2, 4) mesh of repeated
CPU devices.

Contracts and tolerances:
  * every shard routes its tokens to the reference's experts and keeps the
    reference's pairs (its capacity counted per shard);
  * the bf16 output within ``OUT_ULPS`` bf16 ulps of its largest
    magnitude (measured 0: the reference's bits at both factors);
  * the load-balance and z losses within ``METRIC_RTOL`` relative (fp32
    means of the shards' means), ``dropped_frac`` 0 as the reference
    reports it;
  * without drops, the gradients through both all-to-alls against those
    of ``moe_forward_dense`` (the exact dense oracle) within ``GRAD_TOL``
    of their largest magnitude (measured <= 0.0085: bf16 expert products
    and combine against the oracle's fp32 combine);
  * a smoke deepseek-moe-16b forward under the EP rules, at a capacity
    that drops no pair, within ``LM_ULPS`` bf16 ulps of the largest logit
    of the same forward without a context (measured 0).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.compat import make_mesh
from repro.launch import partition as jpart
from repro.models import moe as jmoe
from repro.models.moe_ep import moe_forward_ep as jax_moe_forward_ep
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import partition as tpart
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_ep as tmoe_ep

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(d_model=32, n_experts=8, top_k=2, d_expert=16,
            n_shared_experts=1)
FACTORS = (8.0, 1.0)
RULES = {"tokens": ("data",), "expert": ("model",), "fsdp": None,
         "moe_impl": "shard_map_ep"}
BF16_ULP = 2.0 ** -7
OUT_ULPS = 1
METRIC_RTOL = 1e-5
GRAD_TOL = 2e-2
LM_ULPS = 1


def _inputs():
    weights = tmoe.moe_init_numpy(tmoe.MoEConfig(**DIMS), seed=0)
    x = np.random.default_rng(1).standard_normal(
        (4, 64, 32), dtype=np.float32) * np.float32(0.5)
    return weights, x


def _torch_params(w, requires_grad=False):
    def leaf(a):
        return torch.from_numpy(a.copy()).requires_grad_(requires_grad)
    return {"router": {"kernel": leaf(w["router"]["kernel"])},
            **{k: leaf(w[k]) for k in ("wi", "wg", "wo")},
            "shared": {k: {"kernel": leaf(w["shared"][k]["kernel"])}
                       for k in ("wi", "wg", "wo")}}


def _jax_params(w):
    return jax.tree_util.tree_map(jnp.asarray, w)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    weights, x = _inputs()
    d = tmp_path_factory.mktemp("ep_ref")
    flat = {"moe/router/kernel": weights["router"]["kernel"],
            **{f"moe/{k}": weights[k] for k in ("wi", "wg", "wo")},
            **{f"moe/shared/{k}": weights["shared"][k]["kernel"]
               for k in ("wi", "wg", "wo")}}
    np.savez(d / "in.npz", x=x, factors=np.array(FACTORS),
             moe_dims=np.array([8, 2, 32, 16]), **flat)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_ep_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _mesh(shape=(2, 4)):
    return tmesh.make_debug_mesh(shape, ("data", "model")[-len(shape):],
                                 device="cpu")


def _run_ep(w, x, cfg, mesh, rules=RULES, record=None):
    """The port's moe_forward_ep; ``record`` gets each shard's (idx, keep)
    in block order (one dispatch call a device, over its blocks)."""
    orig = tmoe.dispatch

    def dispatch(idx, c, e):
        out = orig(idx, c, e)
        if record is not None:
            record.extend(zip(idx, out[4]))
        return out
    tmoe.dispatch = dispatch
    try:
        with tpart.partitioning(mesh, rules) as merged:
            return tmoe_ep.moe_forward_ep(w, x, cfg, mesh, merged)
    finally:
        tmoe.dispatch = orig


@pytest.mark.parametrize("cf", FACTORS)
def test_ep_matches_reference(ref, cf):
    weights, x = _inputs()
    cfg = tmoe.MoEConfig(**DIMS, capacity_factor=cf)
    shards = []
    out, metrics = _run_ep(_torch_params(weights), torch.from_numpy(x), cfg,
                           _mesh(), record=shards)
    tag = f"cf{cf:g}"
    keep_ref, idx_ref = ref[f"{tag}/keep"], ref[f"{tag}/idx"]
    assert len(shards) == 8
    for n, (idx, keep) in enumerate(shards):
        i, j = divmod(n, 4)
        assert np.array_equal(idx.numpy(), idx_ref[i, j]), (i, j)
        assert np.array_equal(keep.numpy(), keep_ref[i, j]), (i, j)
    dropped = int((~keep_ref).sum())
    assert (dropped > 0) == (cf == 1.0), dropped
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    want = ref[f"{tag}/out"]
    err = float(np.abs(out.float().numpy() - want).max())
    assert err <= OUT_ULPS * BF16_ULP * float(np.abs(want).max()), err
    for k in ("load_balance_loss", "router_z_loss", "moe_aux_total"):
        want = float(ref[f"{tag}/{k}"])
        assert abs(float(metrics[k]) - want) <= METRIC_RTOL * abs(want), k
    assert float(metrics["dropped_frac"]) == 0.0
    assert float(ref[f"{tag}/dropped_frac"]) == 0.0


def test_ep_single_device_matches_reference():
    """n_ep = 1 on a 1 x 1 mesh, both in this process."""
    weights, x = _inputs()
    tcfg = tmoe.MoEConfig(**DIMS, capacity_factor=1.0)
    jcfg = jmoe.MoEConfig(**DIMS, capacity_factor=1.0)
    jmesh = make_mesh((1, 1), ("data", "model"))
    with jpart.partitioning(jmesh, RULES) as merged:
        want, wm = jax.jit(lambda p, xx: jax_moe_forward_ep(
            p, xx, jcfg, jmesh, merged))(_jax_params(weights), x)
    got, gm = _run_ep(_torch_params(weights), torch.from_numpy(x), tcfg,
                      _mesh((1, 1)))
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= OUT_ULPS * BF16_ULP * float(np.abs(want).max()), err
    for k in ("load_balance_loss", "router_z_loss"):
        assert abs(float(gm[k]) - float(wm[k])) <= METRIC_RTOL * abs(
            float(wm[k])), k


def test_ep_gradient_matches_dense():
    """Without drops, autograd through both all-to-alls gives the dense
    oracle's gradients of sum(out²) for x and every weight."""
    weights, x = _inputs()
    cfg = tmoe.MoEConfig(**DIMS, capacity_factor=8.0)

    def grads(fn):
        p = _torch_params(weights, requires_grad=True)
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        out, _ = fn(p, xt)
        (out.float() ** 2).sum().backward()
        leaves = [xt] + [t for t in (p["router"]["kernel"], p["wi"], p["wg"],
                                     p["wo"])]
        return [t.grad for t in leaves]

    ep = grads(lambda p, xt: _run_ep(p, xt, cfg, _mesh()))
    dense = grads(lambda p, xt: tmoe.moe_forward_dense(p, xt, cfg))
    for name, a, b in zip(("x", "router", "wi", "wg", "wo"), ep, dense):
        assert a is not None and torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        assert scale > 0, name
        err = float((a - b).abs().max()) / scale
        assert err <= GRAD_TOL, (name, err)


def test_ep_block_per_device_gives_the_same_bits(monkeypatch):
    """Each block in a group of its own (the layout of a mesh of distinct
    devices: the all-to-alls move slab by slab) gives the bits of one group
    of all 8 blocks (a mesh of one repeated device: the all-to-alls are a
    transpose): the output, the aux losses and the gradients of x and the
    experts; the router's within fp32 rounding."""
    weights, x = _inputs()
    cfg = tmoe.MoEConfig(**DIMS, capacity_factor=1.0)

    def run():
        p = _torch_params(weights, requires_grad=True)
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        out, m = _run_ep(p, xt, cfg, _mesh())
        ((out.float() ** 2).sum() + m["moe_aux_total"]).backward()
        return [out, m["load_balance_loss"], m["router_z_loss"], xt.grad,
                p["wi"].grad, p["router"]["kernel"].grad]

    one = run()
    monkeypatch.setattr(tmoe_ep, "device_groups", lambda devices: [
        (dev, [blk]) for blk, dev in enumerate(devices)])
    split = run()
    for a, b in zip(one[:-1], split[:-1]):
        assert torch.equal(a, b)
    # the router's gradient sums every block's: one batched product against
    # one a group, an fp32 rounding apart (measured 4.6e-7 of its largest)
    router, router_split = one[-1], split[-1]
    assert float((router - router_split).abs().max()) <= 1e-5 * float(
        router.abs().max())


@pytest.mark.parametrize("case", ["no_context", "ep", "two_expert_axes",
                                  "seq_not_divisible", "gspmd_sort"])
def test_moe_dispatch_picks_path(case):
    """``lm._moe_dispatch`` takes the EP forward only under an active
    context with moe_impl "shard_map_ep", one expert axis and S % n_ep ==
    0, as the reference's does."""
    weights, x = _inputs()
    cfg = tmoe.MoEConfig(**DIMS)
    s = 62 if case == "seq_not_divisible" else 64
    h = torch.from_numpy(x[:, :s].copy())
    rules = dict(RULES)
    if case == "two_expert_axes":
        rules["expert"] = ("data", "model")
    if case == "gspmd_sort":
        rules["moe_impl"] = "gspmd_sort"
    called = []
    orig = (tmoe_ep.moe_forward_ep, tmoe.moe_forward)
    tmoe_ep.moe_forward_ep = lambda *a: called.append("ep") or orig[0](*a)
    tmoe.moe_forward = lambda *a: called.append("sort") or orig[1](*a)
    try:
        p = _torch_params(weights)
        if case == "no_context":
            tlm._moe_dispatch(p, h, cfg)
        else:
            with tpart.partitioning(_mesh(), rules):
                tlm._moe_dispatch(p, h, cfg)
    finally:
        tmoe_ep.moe_forward_ep, tmoe.moe_forward = orig
    assert called == (["ep"] if case == "ep" else ["sort"])


@pytest.mark.parametrize("bad", ["batch", "experts", "expert_axes"])
def test_ep_rejects_what_shard_map_rejects(bad):
    weights, x = _inputs()
    cfg = tmoe.MoEConfig(**DIMS)
    xt = torch.from_numpy(x)
    rules = dict(RULES)
    if bad == "batch":
        xt = xt[:3]
    elif bad == "experts":
        cfg = dataclasses.replace(cfg, n_experts=6, top_k=2)
    else:
        rules["expert"] = None
    with pytest.raises(ValueError):
        _run_ep(_torch_params(weights), xt, cfg, _mesh(), rules=rules)


def test_lm_forward_under_ep_rules():
    """A smoke deepseek-moe-16b forward with its MoE layers on the (2, 4)
    mesh's EP path, at a capacity that drops no pair: the logits of the
    same forward without a context, within a bf16 ulp."""
    base = get_smoke("deepseek-moe-16b")
    cfg = dataclasses.replace(base, capacity_factor=base.n_experts
                              / base.top_k)
    model = tlm.init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    calls = []
    orig = tmoe_ep.moe_forward_ep
    tmoe_ep.moe_forward_ep = lambda *a: calls.append(1) or orig(*a)
    try:
        with tpart.partitioning(_mesh(), RULES):
            ep_logits, _ = tlm.forward(model, cfg, tokens=tok)
    finally:
        tmoe_ep.moe_forward_ep = orig
    logits, _ = tlm.forward(model, cfg, tokens=tok)
    n_moe = sum(tlm._ffn_kind(cfg, i, k) == "moe"
                for i, k in enumerate(cfg.layer_kinds))
    assert len(calls) == n_moe > 0
    err = float((ep_logits - logits).abs().max())
    assert err <= LM_ULPS * BF16_ULP * float(logits.abs().max()), err
