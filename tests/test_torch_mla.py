"""Slice 10 of the port against the reference, on the CPU at smoke size:
multi-head latent attention (MLA, ``models/attention.py``), minicpm3-4b's
mixer. Both packages run in this process on the same seeded numpy inputs;
the weights are one layer of the port's ``lm.init_params_numpy`` for the
minicpm3-4b smoke config (the reference's layout), scaled up so the
scores are not all near zero.

The config sets ``d_head`` apart from ``qk_nope + qk_rope`` (the smoke
config's 24 = 16 + 8 would hide a wrong softmax scale). Outputs, bf16,
are held within ``BF16_ULPS`` bf16 ulps of their largest magnitude (a
bf16 ulp of the top of the binade, as ``tests/test_torch_lm.py``'s
``_ulps``): the fp32 score products add in another order than XLA's and a
bf16 rounding may flip by an ulp (measured 0: the same bits here). The reference
programs are compiled once, at XLA's backend optimisation level 0, which
gives the default level's bits on these programs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

BF16_ULP = 2.0 ** -7
BF16_ULPS = 1
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CPU = torch.device("cpu")
S, STEPS, MAX_LEN, QB = 32, 4, 40, 16
WEIGHT_SCALE = 10.0  # normal(0.2) weights: scores of order one


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(ref, got):
    """max |ref - got| in bf16 ulps of max |ref|."""
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (BF16_ULP * np.abs(ref).max()))


def _configs(q_block):
    cfg = tconfigs.get_smoke("minicpm3-4b")
    kw = dataclasses.asdict(tlm.attn_config(cfg, "mla"))
    kw.update(d_head=40, q_block=q_block)
    return jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)


def _weights():
    cfg = tconfigs.get_smoke("minicpm3-4b")
    tree = tlm.init_params_numpy(cfg, seed=0)
    mixer = jax.tree_util.tree_map(
        lambda a: a[0] * (WEIGHT_SCALE if a.ndim == 3 else 1.0),
        tree["groups"]["0"]["mixer"])
    return (jax.tree_util.tree_map(jnp.asarray, mixer),
            tlm._convert(mixer, CPU))


def _reference(p, x, jcfg, jcfg_blocked):
    """Forward with and without ``q_block``, prefill with its cache, and
    decode steps from the prefill and from ``mla_init_cache``."""
    pos = jnp.arange(S, dtype=jnp.int32)
    fwd = jattn.mla_forward(p, x[:, :S], pos, jcfg)
    fwd_blocked = jattn.mla_forward(p, x[:, :S], pos, jcfg_blocked)
    pre, pre_cache = jattn.mla_prefill_cache(p, x[:, :S], pos, jcfg,
                                             MAX_LEN)
    cache, steps = pre_cache, []
    for i in range(STEPS):
        o, cache = jattn.mla_decode_step(p, x[:, S + i:S + i + 1],
                                         jnp.int32(S + i), cache, jcfg)
        steps.append(o)
    fresh = jattn.mla_init_cache(x.shape[0], MAX_LEN, jcfg)
    cold = []
    for i in range(STEPS):
        o, fresh = jattn.mla_decode_step(p, x[:, i:i + 1], jnp.int32(i),
                                         fresh, jcfg)
        cold.append(o)
    return dict(fwd=fwd, fwd_blocked=fwd_blocked, pre=pre,
                pre_cache=pre_cache,
                steps=jnp.concatenate(steps, 1), cache=cache,
                cold=jnp.concatenate(cold, 1), cold_cache=fresh)


@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg = _configs(0)
    jcfg_b, tcfg_b = _configs(QB)
    jp, tp = _weights()
    u = np.random.default_rng(7).standard_normal(
        (2, S + STEPS, tcfg.d_model)).astype(np.float32)
    ref = jax.jit(_reference, static_argnums=(2, 3)).lower(
        jp, jnp.asarray(u).astype(jnp.bfloat16), jcfg, jcfg_b).compile(
        FAST_COMPILE)(jp, jnp.asarray(u).astype(jnp.bfloat16))
    return dict(tcfg=tcfg, tcfg_b=tcfg_b, tp=tp, ref=ref,
                x=torch.from_numpy(u).bfloat16(),
                pos=torch.arange(S, dtype=torch.int32))


@pytest.mark.parametrize("blocked", [False, True])
def test_mla_forward_matches_reference(mla, blocked):
    """``mla_forward`` over 32 tokens, whole and in two ``q_block``s of
    16 (the reference's scanned blocks); the two forms agree with each
    other as closely as with the reference."""
    cfg = mla["tcfg_b"] if blocked else mla["tcfg"]
    got = tattn.mla_forward(mla["tp"], mla["x"][:, :S], mla["pos"], cfg)
    assert got.dtype == torch.bfloat16
    ref = mla["ref"]["fwd_blocked" if blocked else "fwd"]
    assert _ulps(ref, got) <= BF16_ULPS, _ulps(ref, got)
    other = tattn.mla_forward(mla["tp"], mla["x"][:, :S], mla["pos"],
                              mla["tcfg"] if blocked else mla["tcfg_b"])
    assert _ulps(got.float().numpy(), other) <= BF16_ULPS


def _hold_cache(ref, got, s):
    """The latent cache: the reference's keys, dtypes and positions; ``c``
    and ``k_rope`` within ``BF16_ULPS`` of their largest magnitude, zero
    past the written positions."""
    assert set(ref) == set(got) == {"c", "k_rope", "pos"}
    assert np.array_equal(np.asarray(ref["pos"]), got["pos"].numpy())
    assert (got["pos"][s:] == -1).all()
    for name in ("c", "k_rope"):
        assert got[name].dtype == torch.bfloat16
        assert tuple(got[name].shape) == tuple(ref[name].shape)
        assert _ulps(ref[name], got[name]) <= BF16_ULPS, name
        assert not got[name][:, s:].any()


def test_mla_prefill_cache_matches_reference(mla):
    out, cache = tattn.mla_prefill_cache(mla["tp"], mla["x"][:, :S],
                                         mla["pos"], mla["tcfg"], MAX_LEN)
    assert _ulps(mla["ref"]["pre"], out) <= BF16_ULPS
    r = mla["tcfg"]
    assert cache["c"].shape[-1] + cache["k_rope"].shape[-1] == (
        r.kv_lora_rank + r.qk_rope_head_dim)
    _hold_cache(mla["ref"]["pre_cache"], cache, S)


@pytest.mark.parametrize("start", ["prefill", "init_cache"])
def test_mla_decode_matches_reference(mla, start):
    """Four weight-absorbed decode steps after a 32-token prefill, and from
    an empty ``mla_init_cache`` at position 0 (the ``pos >= 0`` mask hides
    the unwritten slots); each step's output and the final cache."""
    tp, cfg, x = mla["tp"], mla["tcfg"], mla["x"]
    if start == "prefill":
        _, cache = tattn.mla_prefill_cache(tp, x[:, :S], mla["pos"], cfg,
                                           MAX_LEN)
        first, ref, ref_cache = S, mla["ref"]["steps"], mla["ref"]["cache"]
    else:
        cache = tattn.mla_init_cache(2, MAX_LEN, cfg)
        assert (cache["pos"] == -1).all() and not cache["c"].any()
        first, ref, ref_cache = 0, mla["ref"]["cold"], mla["ref"][
            "cold_cache"]
    outs = []
    for i in range(first, first + STEPS):
        o, cache = tattn.mla_decode_step(tp, x[:, i:i + 1], i, cache, cfg)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    assert _ulps(ref, got) <= BF16_ULPS, _ulps(ref, got)
    _hold_cache(ref_cache, cache, first + STEPS)
    # decode continues the forward: the absorbed form is the same function
    if start == "init_cache":
        fwd = tattn.mla_forward(tp, x[:, :STEPS], mla["pos"][:STEPS], cfg)
        assert _ulps(fwd.float().numpy(), got) <= 2 * BF16_ULPS
