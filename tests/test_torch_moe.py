"""Slice 10 of the port against the reference, on the CPU: the MoE FFN
(``models/moe.py``) of deepseek-moe-16b and qwen3-moe-235b-a22b. Both
packages run in this process on the same seeded numpy inputs; the weights
are one MoE layer of the port's ``lm.init_params_numpy`` (the reference's
layout: fp32 router, raw (E, d, f) expert arrays, optional shared SwiGLU)
for the smoke configs.

Contracts and tolerances:
  * routing: the same expert indices, the lower index first on tied
    probabilities (``jax.lax.top_k``'s order); weights and the two losses
    within ``FP32_ULPS`` fp32 ulps of their largest magnitude (softmax and
    the means add in another order than XLA's);
  * ``capacity`` and the dispatch: equal (integers), the kept pairs and
    ``dropped_frac`` exactly the reference's;
  * the combine: the bits of the reference's bf16 scatter-add, on rows
    where another order of the same adds gives other bits;
  * ``moe_forward``'s bf16 output within ``BF16_ULPS`` bf16 ulps of its
    largest magnitude (measured <= 0.21); without drops against
    ``moe_forward_dense``, the exact dense oracle, within ``DENSE_ULPS``:
    the oracle combines in fp32 and rounds once, the sparse path rounds
    each weighted row and each of its k bf16 adds (measured <= 0.97).
The reference programs are compiled at XLA's backend optimisation level 0,
which gives the default level's bits on these programs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

FP32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
FP32_ULPS = 8
BF16_ULPS = 1
DENSE_ULPS = 2
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CPU = torch.device("cpu")
ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")


def _run_ref(fn, *args, static=()):
    compiled = jax.jit(fn, static_argnums=static).lower(*args).compile(
        FAST_COMPILE)
    return compiled(*(a for i, a in enumerate(args) if i not in static))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(ref, got, ulp):
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (ulp * np.abs(ref).max()))


def _configs(arch, **kw):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    m = dataclasses.asdict(tlm.moe_config(cfg))
    return cfg, jmoe.MoEConfig(**m), tmoe.MoEConfig(**m)


def _moe_layer(cfg):
    """One MoE layer's FFN weights as numpy (the last layer: the first is
    deepseek's dense prefix)."""
    tree = tlm.init_params_numpy(cfg, seed=0)
    ffn = (tree["suffix"]["0"]["ffn"] if "suffix" in tree else
           jax.tree_util.tree_map(lambda a: a[-1],
                                  tree["groups"]["0"]["ffn"]))
    return (jax.tree_util.tree_map(jnp.asarray, ffn),
            tlm._convert({"ffn": ffn}, CPU)["ffn"])


def _tokens(cfg, t, seed):
    """bf16 FFN inputs (1, T, D), as the RMS norm before the FFN gives."""
    u = np.random.default_rng(seed).standard_normal(
        (1, t, cfg.d_model)).astype(np.float32)
    return jnp.asarray(u).astype(jnp.bfloat16), torch.from_numpy(u).bfloat16()


# -- routing -----------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_route_matches_reference(normalize):
    """Softmax -> top-k over 16 experts, top-4, with and without
    renormalised weights: indices equal, weights and losses within
    ``FP32_ULPS``."""
    kw = dict(d_model=8, n_experts=16, top_k=4, d_expert=8,
              normalize_topk=normalize)
    logits = np.random.default_rng(3).standard_normal((64, 16)).astype(
        np.float32) * 3
    ref = _run_ref(lambda x: jmoe.route(x, jmoe.MoEConfig(**kw)),
                   jnp.asarray(logits))
    got = tmoe.route(torch.from_numpy(logits), tmoe.MoEConfig(**kw))
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    assert _ulps(ref[0], got[0], FP32_ULP) <= FP32_ULPS
    if normalize:
        np.testing.assert_allclose(got[0].sum(-1).numpy(), 1.0, atol=1e-6)
    for name in ("load_balance_loss", "router_z_loss"):
        assert abs(float(ref[2][name]) - float(got[2][name])) <= (
            FP32_ULPS * FP32_ULP * abs(float(ref[2][name]))), name


def test_route_ties_take_the_lower_index():
    """Equal logits (so equal probabilities) across many experts: each
    token's top-k are the lowest indices among the tied maxima, in the
    reference's order; an unstable sort would pick others."""
    kw = dict(d_model=8, n_experts=64, top_k=6, d_expert=8)
    rng = np.random.default_rng(5)
    logits = rng.integers(0, 3, (128, 64)).astype(np.float32)
    logits[0] = 1.0          # all 64 tied
    logits[1] = 0.0
    logits[1, ::2] = 2.0     # the even experts tied at the top
    ref = _run_ref(lambda x: jmoe.route(x, jmoe.MoEConfig(**kw)),
                   jnp.asarray(logits))
    got = tmoe.route(torch.from_numpy(logits), tmoe.MoEConfig(**kw))
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    assert got[1][0].tolist() == list(range(6))
    assert got[1][1].tolist() == [0, 2, 4, 6, 8, 10]
    top = logits.max(-1, keepdims=True)
    want = [np.flatnonzero(row == m)[:6] for row, m in zip(logits, top)]
    for row, w in zip(got[1].numpy(), want):
        assert row[:len(w)].tolist() == w.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    """``capacity`` over a sweep of token counts (decode batches, the
    smoke and full-width prompts), at the published factor and at 8.0."""
    for get in (tconfigs.get_smoke, tconfigs.get_config):
        for cf in (1.25, 8.0, 0.5):
            cfg = dataclasses.replace(get(arch), capacity_factor=cf)
            m = dataclasses.asdict(tlm.moe_config(cfg))
            for t in (1, 2, 4, 7, 64, 128, 255, 2048, 2064, 8192):
                assert tmoe.capacity(t, tmoe.MoEConfig(**m)) == \
                    jmoe.capacity(t, jmoe.MoEConfig(**m)), (cf, t)
    full = tlm.moe_config(tconfigs.get_config(arch))
    assert tmoe.capacity(128, full) == 16
    assert tmoe.capacity(2048, full) == (240 if arch == ARCHS[0] else 160)


# -- dispatch, combine and the whole FFN -------------------------------------

def _reference_dispatch(idx, c, e):
    """The reference's ``moe_forward`` lines that pick the kept pairs."""
    t, k = idx.shape
    pair_e = idx.reshape(t * k)
    order = jnp.argsort(pair_e)
    se = pair_e[order]
    counts = jnp.bincount(pair_e, length=e)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(t * k, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    return order, se, pos < c


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_with_drops_matches_reference(arch):
    """At capacity factor 0.75 over 96 tokens a share of the pairs is
    dropped (random smoke weights route near-uniformly, so the published
    1.25 rarely overflows at 8 experts): the same pairs as the reference's
    (``keep``), the same ``dropped_frac``, and the output and metrics of
    the reference."""
    cfg, jcfg, tcfg = _configs(arch, capacity_factor=0.75)
    jp, tp = _moe_layer(cfg)
    xj, xt = _tokens(cfg, 96, seed=1)
    c = tmoe.capacity(96, tcfg)
    ref_out, ref_m = _run_ref(lambda p, x: jmoe.moe_forward(p, x, jcfg),
                              jp, xj)
    got_out, got_m = tmoe.moe_forward(tp, xt, tcfg)
    _, idx, _ = tmoe.route(tmoe._router_logits(tp, xt[0]), tcfg)
    order, st_tok, se, slot, keep = tmoe.dispatch(idx, c, tcfg.n_experts)
    r_order, r_se, r_keep = _reference_dispatch(jnp.asarray(idx.numpy()), c,
                                                tcfg.n_experts)
    assert np.array_equal(np.asarray(r_order), order.numpy())
    assert np.array_equal(np.asarray(r_se), se.numpy())
    assert np.array_equal(np.asarray(r_keep), keep.numpy())
    assert np.array_equal(st_tok.numpy(), order.numpy() // tcfg.top_k)
    assert 0.05 < float(got_m["dropped_frac"]) < 0.5
    assert float(got_m["dropped_frac"]) == float(ref_m["dropped_frac"])
    assert _ulps(ref_out, got_out, BF16_ULP) <= BF16_ULPS
    for name in ("load_balance_loss", "router_z_loss", "moe_aux_total"):
        assert abs(float(ref_m[name]) - float(got_m[name])) <= (
            FP32_ULPS * FP32_ULP * abs(float(ref_m[name]))), name


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_without_drops_matches_dense_oracle(arch):
    """The smoke configs' factor 8.0 drops nothing: ``moe_forward`` equals
    ``moe_forward_dense`` (every expert on every token) and the
    reference's, with deepseek's two shared experts and without (qwen3)."""
    cfg, jcfg, tcfg = _configs(arch)
    jp, tp = _moe_layer(cfg)
    assert ("shared" in tp) == (arch == ARCHS[0])
    xj, xt = _tokens(cfg, 40, seed=2)
    ref_out, ref_m = _run_ref(lambda p, x: jmoe.moe_forward(p, x, jcfg),
                              jp, xj)
    got_out, got_m = tmoe.moe_forward(tp, xt, tcfg)
    dense, _ = tmoe.moe_forward_dense(tp, xt, tcfg)
    assert float(got_m["dropped_frac"]) == float(ref_m["dropped_frac"]) == 0
    assert _ulps(ref_out, got_out, BF16_ULP) <= BF16_ULPS
    assert _ulps(dense.float().numpy(), got_out, BF16_ULP) <= DENSE_ULPS
    ref_dense, _ = _run_ref(lambda p, x: jmoe.moe_forward_dense(p, x, jcfg),
                            jp, xj)
    assert _ulps(ref_dense, dense, BF16_ULP) <= BF16_ULPS


def test_combine_adds_in_the_reference_order():
    """Rows of mixed magnitudes whose bf16 sum depends on the order: the
    combine gives the bits of the reference's scatter-add over the sorted
    pairs, where adding each token's rows in their top-k order or in
    reverse expert order gives other bits."""
    t, k, e, d = 64, 6, 16, 32
    rng = np.random.default_rng(9)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    scale = 10.0 ** rng.integers(-3, 3, (t * k, 1))
    rows = (rng.standard_normal((t * k, d)) * scale).astype(np.float32)
    order = np.argsort(idx.reshape(-1), kind="stable")
    st_tok = order // k
    rows_b = torch.from_numpy(rows).bfloat16()
    ref = _run_ref(lambda r, s: jnp.zeros((t, d), jnp.bfloat16).at[s].add(r),
                   jnp.asarray(rows).astype(jnp.bfloat16),
                   jnp.asarray(st_tok))
    got = tmoe.combine(rows_b, torch.from_numpy(st_tok),
                       torch.from_numpy(idx.reshape(-1)[order]), t, e)
    assert np.array_equal(_f32(ref), _f32(got))
    # the same rows in the tokens' top-k order, and in reverse expert order
    pair_rows = torch.empty_like(rows_b)
    pair_rows[torch.from_numpy(order)] = rows_b
    for perm in (np.arange(k), None):
        by = pair_rows.reshape(t, k, d)
        if perm is None:  # descending expert
            by = by[torch.arange(t)[:, None],
                    torch.from_numpy(np.argsort(-idx, axis=1))]
        other = torch.zeros((t, d), dtype=torch.bfloat16)
        for j in range(k):
            other = other + by[:, j]
        assert not np.array_equal(_f32(ref), _f32(other))


def test_router_and_absorbed_masters_stay_fp32_experts_bf16():
    """``params_from_reference`` keeps the MoE router and MLA's ``wuk`` /
    ``wuv`` fp32 (the reference reads them in fp32) and stores the experts'
    ``wi`` / ``wg`` / ``wo`` in bf16 (the reference casts them at use)."""
    seen = set()
    for arch in ARCHS + ("minicpm3-4b",):
        cfg = tconfigs.get_smoke(arch)
        model = tlm.params_from_reference(tlm.init_params_numpy(cfg, 0), cfg,
                                          device="cpu")
        for key, buf in model.named_buffers():
            parts = key.split(".")
            if "router" in parts or {"wuk", "wuv"} & set(parts):
                assert buf.dtype == torch.float32, key
                seen.add(parts[-2])
            elif parts[-2] == "ffn" and parts[-1] in ("wi", "wg", "wo"):
                assert buf.dtype == torch.bfloat16 and buf.dim() == 3, key
                seen.add("experts")
    assert seen == {"router", "wuk", "wuv", "experts"}
