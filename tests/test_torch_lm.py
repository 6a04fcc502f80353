"""Slices 8-10 of the port against the reference, on the CPU at smoke
sizes: the arch configs, the primitive layers, grouped-query attention
with its KV caches, and the decoder LM's forward, prefill and decode, for
the dense archs, the recurrent ones (mamba2-780m's SSD layers,
recurrentgemma-9b's RG-LRU / local-attention pattern) and the MLA and MoE
ones (minicpm3-4b's latent attention; deepseek-moe-16b's dense first
layer, routed and shared experts; qwen3-moe-235b-a22b's renormalised
top-8 with QK-norm). Both packages run
in this process on the same numpy inputs and weights (the reference's
parameter tree as numpy arrays, through ``params_from_reference``).

Tolerances: fp32 layers within 1e-6; bf16 layers bit-equal where both
round each op the same way (dense, norms, embeddings, silu: the
activations follow ``jax.nn``'s formulas op by op), the GELU family and
bf16 RoPE within one bf16 ulp (the libraries' fp32 tanh, sin and cos
differ in the last bits);
attention outputs within one bf16 ulp of their largest magnitude and KV
caches within two (two roundings of a bf16 product can differ by an
ulp); logits within 1e-2, the
reference's own decode tolerance (``tests/test_arch_smoke.py``), with the
argmax equal wherever the reference's top-2 gap exceeds it, and the MoE
archs' ``aux`` (the summed router losses) within ``AUX_RTOL`` of the
reference's (measured <= 8.6e-5: the routers read activations that carry
the layers' bf16 rounding splits). The recurrent
archs' logits and SSM decode states (in the reference's dtypes) are held
to ``SSM_ULPS`` bf16 ulps of the reference's largest magnitude instead
(measured <= 1.9 for the logits, <= 2.1 for mamba2's deepest SSD state):
their scans and the SSD's einsums add in another order than XLA's, a
layer's bf16 matmuls flip roundings by an ulp, and the layers and the
gated RMS norm spread it.

Cost: each reference program (forward, prefill and the decode steps of
one config) is compiled once, at XLA's backend optimisation level 0, which
gives the default level's bits on these programs and compiles 2-3x
faster, and shared through module-scoped fixtures. Weights come from the
port's ``init_params_numpy`` (the reference's layout, checked against
``lm.init_abstract``); one test converts a real ``lm.init_params`` tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jconfigs
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

LOGIT_TOL = 1e-2   # tests/test_arch_smoke.py decode tolerance
FP32_TOL = 1e-6
ULP = 2.0 ** -7    # a bf16 ulp, relative
# qwen2: swiglu, QKV bias, tied head; granite: gelu MLP, MQA; llama3:
# q_block (32 at smoke size, so S=64); chameleon: embeds in, QK-norm.
DENSE_ARCHS = ("qwen2-0.5b", "granite-34b", "llama3-405b", "chameleon-34b")
# mamba2: SSD layers, no FFN (S=40 pads to the 16-token chunk);
# recurrentgemma: rglru, rglru, local_attn (S=40 wraps the 16-slot ring)
SSM_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
SSM_ULPS = 3
# minicpm3: mla; deepseek: first_k_dense + shared experts; qwen3: top-8
# renormalised, GQA with QK-norm
MLA_MOE_ARCHS = ("minicpm3-4b", "deepseek-moe-16b", "qwen3-moe-235b-a22b")
AUX_RTOL = 2e-4


FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _run_ref(fn, *args, static=()):
    """``fn(*args)`` of the reference, jitted with the ``static`` argument
    positions and compiled with ``FAST_COMPILE``."""
    compiled = jax.jit(fn, static_argnums=static).lower(*args).compile(
        FAST_COMPILE)
    return compiled(*(a for i, a in enumerate(args) if i not in static))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _f32(x):
    """A JAX or torch array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(ref, got, floor=1.0):
    """The largest difference of two bf16 arrays in bf16 ulps of their
    largest magnitude (at least ``floor``)."""
    ref, got = _f32(ref), _f32(got)
    scale = max(floor, np.abs(ref).max(), np.abs(got).max())
    return float(np.abs(ref - got).max() / (ULP * scale))


def _hold_logits(ref, got, tol=LOGIT_TOL):
    """Logits within ``tol`` (None: ``SSM_ULPS`` bf16 ulps of the
    reference's largest), the argmax equal where the reference's top-2 gap
    exceeds it."""
    ref, got = _f32(ref), _f32(got)
    if tol is None:
        tol = SSM_ULPS * ULP * np.abs(ref).max()
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol, np.abs(ref - got).max()
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > tol
    assert np.array_equal(ref.argmax(-1)[decided], got.argmax(-1)[decided])


# -- configs -----------------------------------------------------------------

def test_registry_lists_the_same_archs_and_shapes():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tregistry.cells() == jregistry.cells()


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke, jconfigs.get_smoke)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.active_params() == j.active_params()
        assert t.total_params() == j.total_params()
        assert t.layer_kinds == j.layer_kinds
        assert t.sub_quadratic == j.sub_quadratic
        assert t.sharding_override_rules == j.sharding_override_rules
    for shape in jconfigs.SHAPES:
        assert (tregistry.runnable_cell(arch, shape)
                == jregistry.runnable_cell(arch, shape))


# -- layers ------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_inputs():
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    ffn = {"wi": {"kernel": w(64, 128)}, "wg": {"kernel": w(64, 128)},
           "wo": {"kernel": w(128, 64)}}
    return dict(
        x=rng.standard_normal((2, 16, 64)).astype(np.float32),
        xh=rng.standard_normal((2, 16, 4, 32)).astype(np.float32),
        pos=(np.arange(16) * 37).astype(np.int32),
        dense={"kernel": w(64, 96),
               "bias": (rng.standard_normal(96) * 0.1).astype(np.float32)},
        scale=(1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
        head_scale=(1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
        ffn=ffn, table=w(100, 64),
        tokens=rng.integers(0, 100, (2, 16)).astype(np.int32))


def _layer_calls(L, d, tensor):
    """The bf16 layer functions of module ``L`` (the reference's or the
    port's) on the inputs ``d``, each array made by ``tensor``: dicts of
    outputs that must be the same bits and that must agree within one
    ulp."""
    x, xh, pos = tensor(d["x"]), tensor(d["xh"]), tensor(d["pos"])
    bf16 = (lambda a: a.astype("bfloat16")) if L is JL else (
        lambda a: a.bfloat16())
    xb, xhb = bf16(x), bf16(xh)
    x10 = x * 10  # reach the activations' curved range
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else tensor(v)
                      for k, v in t.items()}
    ffn, table = tree(d["ffn"]), {"table": tensor(d["table"])}
    act = jax.nn if L is JL else L
    bit = {"dense": L.dense(tree(d["dense"]), x),
           "rmsnorm bf16": L.rmsnorm({"scale": tensor(d["scale"])}, xb),
           "swiglu": L.swiglu(ffn, x10), "silu": act.silu(xb * 4),
           "embed": L.embed(table, tensor(d["tokens"])),
           "unembed": L.unembed(table, x)}
    ulp = {"geglu": L.geglu(ffn, x10), "gelu_mlp": L.gelu_mlp(ffn, x10),
           "gelu": act.gelu(xb * 4),
           "rope bf16": L.apply_rope(xhb, pos, 1e4)}
    return bit, ulp


def _fp32_calls(L, d, tensor):
    """The fp32 functions of ``L``: norms and RoPE at positions up to 555
    (eager on both sides: XLA's fused sin and cos lose ~1e-5 there)."""
    x, xh, pos = tensor(d["x"]), tensor(d["xh"]), tensor(d["pos"])
    return {"rmsnorm fp32": L.rmsnorm({"scale": tensor(d["scale"])}, x),
            "rms_head_norm": L.rms_head_norm(tensor(d["head_scale"]), xh),
            "rope_freqs": L.rope_freqs(32, 1e6),
            "rope fp32": L.apply_rope(xh, pos, 1e6),
            "rope shared": L.apply_rope(x[..., :32], pos, 1e4,
                                        has_head_dim=False)}


def test_layers_match_reference(layer_inputs):
    """Each layer function of the port against the reference's on the same
    inputs (the bf16 ones compiled as one program)."""
    d = layer_inputs
    torch_in = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ref = _run_ref(lambda dj: _layer_calls(JL, dj, lambda a: a),
                   jax.tree_util.tree_map(jnp.asarray, d))
    got = _layer_calls(TL, d, torch_in)
    for name, r in ref[0].items():
        g = got[0][name]
        assert r.dtype == jnp.dtype(str(g.dtype).split(".")[1]), name
        assert np.array_equal(_f32(r), _f32(g)), name
    for name, r in ref[1].items():
        assert r.dtype == jnp.bfloat16 and got[1][name].dtype == torch.bfloat16
        assert _ulps(r, got[1][name]) <= 1, name
    ref = _fp32_calls(JL, d, jnp.asarray)
    got = _fp32_calls(TL, d, torch_in)
    for name, r in ref.items():
        assert np.abs(_f32(r) - _f32(got[name])).max() <= FP32_TOL, name


# -- attention ---------------------------------------------------------------

ATTN = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, qkv_bias=True)
# forward / prefill length S, decode steps; "window": prefill past the
# 8-slot ring and decode around it; "kv_quant": the int8 cache.
ATTN_CASES = {
    "full": (dict(), 12),
    "q_block": (dict(q_block=16), 32),
    "window": (dict(window=8), 12),
    "kv_quant": (dict(kv_quant=True), 12),
}
ATTN_STEPS, ATTN_MAX_LEN = 6, 40


def _attn_params(cfg, seed):
    """The reference's GQA layout as numpy (normal(0.02) kernels, non-zero
    biases so the add is exercised)."""
    rng = np.random.default_rng(seed)
    a = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    p = {"wq": {"kernel": a(64, cfg.n_heads * 16)},
         "wk": {"kernel": a(64, cfg.n_kv_heads * 16)},
         "wv": {"kernel": a(64, cfg.n_kv_heads * 16)},
         "wo": {"kernel": a(cfg.n_heads * 16, 64)}}
    for name in ("wq", "wk", "wv"):
        p[name]["bias"] = a(p[name]["kernel"].shape[1]) * 5
    return jax.tree_util.tree_map(jnp.asarray, p), tlm._convert(
        p, torch.device("cpu"))


def _hold_cache(jc, tc, ulps=2):
    """Positions equal; K/V (MLA: the latent ``c`` and ``k_rope``) within
    ``ulps`` bf16 ulps of their largest magnitude (int8 ones: the
    dequantised values decode reads)."""
    assert set(jc) == set(tc)
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    if "k_scale" in jc:  # int8: compare what decode reads back
        for n in ("k", "v"):
            ref = jattn._kv_dequantize(jc[n], jc[f"{n}_scale"])
            got = tattn._kv_dequantize(tc[n], tc[f"{n}_scale"])
            assert _ulps(ref, got, floor=0.0) <= ulps, n
        return
    for n in set(jc) - {"pos"}:
        assert tc[n].dtype == torch.bfloat16
        assert _ulps(jc[n], tc[n], floor=0.0) <= ulps, (
            n, _ulps(jc[n], tc[n], floor=0.0))


def _reference_attention(jp, x, s, cfg):
    """forward, prefill and every decode step of the reference, in one
    compiled program."""
    pos = jnp.arange(s, dtype=jnp.int32)
    fwd = jattn.gqa_forward(jp, x[:, :s], pos, cfg)
    pre, cache = jattn.gqa_prefill_cache(jp, x[:, :s], pos, cfg, ATTN_MAX_LEN)

    def step(cache, i):
        xi = jax.lax.dynamic_slice_in_dim(x, s + i, 1, axis=1)
        o, cache = jattn.gqa_decode_step(jp, xi, s + i, cache, cfg)
        return cache, o

    cache, outs = jax.lax.scan(step, cache, jnp.arange(ATTN_STEPS))
    return fwd, pre, outs, cache


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_forward_prefill_decode_match_reference(case):
    kw, s = ATTN_CASES[case]
    kw = {**ATTN, **kw}
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    jp, tp = _attn_params(tcfg, seed=len(case))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s + ATTN_STEPS, 64)).astype(np.float32)
    xb = _t(x).bfloat16()
    ref = _run_ref(_reference_attention, jp,
                   jnp.asarray(x).astype(jnp.bfloat16), s, jcfg,
                   static=(2, 3))
    pos = torch.arange(s, dtype=torch.int32)
    got_fwd = tattn.gqa_forward(tp, xb[:, :s], pos, tcfg)
    got_pre, tc = tattn.gqa_prefill_cache(tp, xb[:, :s], pos, tcfg,
                                          ATTN_MAX_LEN)
    assert tc["k"].shape[1] == (8 if tcfg.window else ATTN_MAX_LEN)
    got = []
    for i in range(ATTN_STEPS):
        o, tc = tattn.gqa_decode_step(tp, xb[:, s + i:s + i + 1], s + i, tc,
                                      tcfg)
        got.append(o)
    for name, r, g in (("forward", ref[0], got_fwd),
                       ("prefill", ref[1], got_pre),
                       ("decode", ref[2], torch.stack(got))):
        # outputs after ``wo`` are ~0.1 at these widths: held in ulps of
        # their own largest magnitude, with no floor
        assert _ulps(r, g, floor=0.0) <= 1, (case, name, _ulps(r, g, 0.0))
    if tcfg.window:
        assert (tc["pos"] >= 0).all() and tc["pos"].max() == s + 5
    _hold_cache(ref[3], tc)


# -- the decoder LM ----------------------------------------------------------

LM_STEPS, LM_MAX_LEN = 4, 72


def _arch_inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return dict(tokens=rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32))
    return dict(embeds=(rng.standard_normal((b, s, cfg.d_model))
                        * 0.1).astype(np.float32))


def _reference_lm(params, x, s, cfg, key):
    """The reference's forward over all S + steps positions, prefill of the
    first S and each decode step, in one compiled program."""
    one = "token" if key == "tokens" else "embed"
    fwd, aux = jlm.forward(params, cfg, **{key: x})
    pre, cache = jlm.prefill(params, cfg, max_len=LM_MAX_LEN,
                             **{key: x[:, :s]})

    def step(cache, i):
        xi = jax.lax.dynamic_index_in_dim(x, s + i, axis=1, keepdims=False)
        logits, cache = jlm.decode_step(params, cfg, s + i, cache,
                                        **{one: xi})
        return cache, logits

    cache, steps = jax.lax.scan(step, cache, jnp.arange(LM_STEPS))
    return fwd, pre, steps.swapaxes(0, 1), cache, aux


@pytest.fixture(scope="module", params=DENSE_ARCHS + SSM_ARCHS
                + MLA_MOE_ARCHS)
def arch(request):
    """The port's model and outputs beside the reference's, for one smoke
    config on the same numpy weights and inputs."""
    name = request.param
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    tree = tlm.init_params_numpy(tcfg, seed=0)
    model = tlm.params_from_reference(tree, tcfg, device="cpu")
    s = {"llama3-405b": 64, **dict.fromkeys(SSM_ARCHS, 40)}.get(name, 12)
    inputs = _arch_inputs(tcfg, 2, s + LM_STEPS)
    key = next(iter(inputs))
    ref = _run_ref(_reference_lm, jax.tree_util.tree_map(jnp.asarray, tree),
                   jnp.asarray(inputs[key]), s, jcfg, key, static=(2, 3, 4))
    x = torch.from_numpy(inputs[key])
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, tree=tree, model=model,
                s=s, key=key, x=x, ref=ref,
                tol=None if name in SSM_ARCHS else LOGIT_TOL)


def _bf16_leaf(key):
    """Whether ``params_from_reference`` casts the buffer at ``key`` to
    bf16: matmul kernels, biases, tables and the MoE experts' raw arrays,
    but for the RG-LRU gates', the MoE router's and MLA's ``wuk`` /
    ``wuv`` (fp32 in the reference's products)."""
    parts = key.split(".")
    experts = parts[-2] == "ffn" and parts[-1] in ("wi", "wg", "wo")
    return (parts[-1] in ("kernel", "bias", "table") or experts) and not (
        {"w_a", "w_i", "router", "wuk", "wuv"} & set(parts))


def test_model_layout_and_dtypes(arch):
    tcfg, model, tree = arch["tcfg"], arch["model"], arch["tree"]
    assert isinstance(model, torch.nn.Module)
    abstract = jlm.init_abstract(arch["jcfg"])
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(abstract))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(abstract)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert tlm.param_count(model) == sum(
        x.size for x in jax.tree_util.tree_leaves(tree))
    assert len(model["layers"]._modules) == tcfg.n_layers
    for key, buf in model.named_buffers():
        want = torch.bfloat16 if _bf16_leaf(key) else torch.float32
        assert buf.dtype == want, key


def test_forward_matches_reference(arch):
    got, aux = arch["model"](**{arch["key"]: arch["x"]})
    ref_aux = float(arch["ref"][4])
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (ref_aux > 0) == (arch["tcfg"].ffn == "moe")
    assert abs(float(aux) - ref_aux) <= AUX_RTOL * ref_aux
    _hold_logits(arch["ref"][0], got, arch["tol"])
    if arch["name"] == "llama3-405b":  # S + steps = 68: no q_block split
        s, qb = arch["s"], arch["tcfg"].q_block
        assert s > qb and s % qb == 0
        got_s, _ = arch["model"](**{arch["key"]: arch["x"][:, :s]})
        _hold_logits(arch["ref"][1], got_s[:, -1])


def test_prefill_and_decode_match_reference(arch):
    tcfg, model, s, key, x = (arch[k] for k in ("tcfg", "model", "s", "key",
                                                "x"))
    _, ref_pre, ref_steps, jc, _ = arch["ref"]
    got, tc = tlm.prefill(model, tcfg, max_len=LM_MAX_LEN,
                          **{key: x[:, :s]})
    _hold_logits(ref_pre, got, arch["tol"])
    empty = tlm.init_cache(tcfg, 2, LM_MAX_LEN, device="cpu")
    ref_empty = jlm.init_cache(arch["jcfg"], 2, LM_MAX_LEN)
    assert len(tc) == len(empty) == tcfg.n_layers
    for li, (c, e) in enumerate(zip(tc, empty)):
        # init_cache's layout is the reference's; prefill fills it (an SSM
        # conv state comes back in the activations' bf16, as there)
        _hold_layout(_reference_layer(ref_empty, tcfg, li), e)
        _hold_layout(_reference_layer(jc, tcfg, li), c)
        if isinstance(e, dict):
            assert (e["pos"] == -1).all()
            assert not any(t.any() for n, t in e.items() if n != "pos")
        else:
            assert not any(t.any() for t in e)
    one = "token" if key == "tokens" else "embed"
    for i in range(LM_STEPS):
        got, tc = tlm.decode_step(model, tcfg, s + i, tc,
                                  **{one: x[:, s + i]})
        _hold_logits(ref_steps[:, i], got, arch["tol"])
    for li in range(tcfg.n_layers):
        ref_c = _reference_layer(jc, tcfg, li)
        if isinstance(ref_c, dict):
            _hold_cache(ref_c, tc[li])
        else:
            for r, g in zip(ref_c, tc[li]):
                assert _ulps(r, g, floor=0.0) <= SSM_ULPS, (
                    li, _ulps(r, g, floor=0.0))
    # decode continues prefill: its last logits are the forward's
    full, _ = model(**{key: x})
    assert np.abs(_f32(full[:, -1]) - _f32(got)).max() <= LOGIT_TOL


def _reference_layer(cache, cfg, li):
    """Layer ``li``'s decode state in a cache of the reference, which keeps
    its prefix / stacked groups / suffix split."""
    prefix, _, suffix, _ = tlm._layer_plan(cfg)
    first = cfg.n_layers - len(suffix)
    if li < len(prefix):
        return cache["prefix"][str(li)]
    if li >= first:
        return cache["suffix"][str(li - first)]
    r, j = divmod(li - len(prefix), len(cfg.block_pattern))
    return jax.tree_util.tree_map(lambda a: a[r], cache["groups"][str(j)])


def _hold_layout(ref, got):
    """The same structure (a KV dict or a state tuple), shapes and
    dtypes."""
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert ref_def == got_def, (ref_def, got_def)
    for r, g in zip(ref_leaves, got_leaves):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(g.dtype) == f"torch.{r.dtype}", (g.dtype, r.dtype)


def test_params_from_reference_init_params():
    """A tree from the reference's own ``lm.init_params`` (as numpy), with
    its stacked groups, becomes the port's layers in the reference's order,
    each leaf the reference's cast at use (bf16 kernels, biases and table;
    fp32 norm scales)."""
    jcfg, tcfg = jconfigs.get_smoke("granite-34b"), \
        tconfigs.get_smoke("granite-34b")
    jp = _np(_run_ref(jlm.init_params, jax.random.PRNGKey(3), jcfg,
                      static=(1,)))
    model = tlm.params_from_reference(jp, tcfg, device="cpu")
    want = {"embed.table": jp["embed"]["table"],
            "final_norm.scale": jp["final_norm"]["scale"],
            "lm_head.kernel": jp["lm_head"]["kernel"]}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jp["groups"]["0"])[0]:
        name = ".".join(k.key for k in path)
        for li in range(tcfg.n_layers):
            want[f"layers.{li}.{name}"] = leaf[li]
    got = dict(model.named_buffers())
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        cast = (jnp.bfloat16 if key.split(".")[-1] in ("kernel", "bias",
                                                       "table")
                else jnp.float32)
        np.testing.assert_array_equal(
            _f32(got[key]), _f32(jnp.asarray(leaf).astype(cast)), key)


def test_soft_cap_and_untied_head_match_reference():
    """``logit_soft_cap`` and an untied ``lm_head`` on a local-window,
    geglu config (recurrentgemma's attention layer and head, without its
    recurrent blocks)."""
    kw = dict(name="soft-cap", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=1, d_head=16, d_ff=128, vocab_size=256,
              block_pattern=("local_attn",), ffn="geglu", window=8,
              logit_soft_cap=0.05)
    jcfg, tcfg = jconfigs.ArchConfig(**kw), tconfigs.ArchConfig(**kw)
    tree = tlm.init_params_numpy(tcfg, seed=5)
    assert "lm_head" in tree and "embed" in tree
    model = tlm.params_from_reference(tree, tcfg, device="cpu")
    toks = _arch_inputs(tcfg, 2, 20, seed=2)["tokens"]
    ref, _ = _run_ref(jlm.forward, jax.tree_util.tree_map(jnp.asarray, tree),
                      jcfg, jnp.asarray(toks), static=(1,))
    got, _ = model(tokens=torch.from_numpy(toks))
    assert np.abs(_f32(got)).max() <= 0.05
    _hold_logits(ref, got)


def test_full_width_qwen2_layout():
    """qwen2-0.5b at full width, counted from the layout alone (no
    weights): 494.03 M parameters in the reference's tree."""
    cfg = tconfigs.get_config("qwen2-0.5b")
    prefix, reps, suffix, _ = tlm._layer_plan(cfg)
    assert (prefix, reps, suffix) == ([], 24, [])
    layer = tlm._layer_shapes(cfg, "attn", "swiglu")
    n = sum(int(np.prod(s)) for s, _ in jax.tree_util.tree_leaves(
        layer, is_leaf=lambda v: isinstance(v, tuple) and len(v) == 2
        and isinstance(v[1], str)))
    total = 24 * n + cfg.vocab_size * cfg.d_model + cfg.d_model
    assert round(total / 1e6, 2) == 494.03
    abstract = jlm.init_abstract(jconfigs.get_config("qwen2-0.5b"))
    assert total == sum(x.size for x in jax.tree_util.tree_leaves(abstract))


def _hold_full_width_layout(name, n_layers, millions):
    """``param_shapes`` of the arch at full width and ``n_layers`` against
    the reference's ``init_abstract`` leaf for leaf (no weights), and its
    count in millions."""
    tcfg = dataclasses.replace(tconfigs.get_config(name), n_layers=n_layers)
    jcfg = dataclasses.replace(jconfigs.get_config(name), n_layers=n_layers)
    is_leaf = lambda v: isinstance(v, tuple) and len(v) == 2 and isinstance(
        v[1], str)
    shapes, tree = jax.tree_util.tree_flatten(tlm.param_shapes(tcfg),
                                              is_leaf=is_leaf)
    abstract, jtree = jax.tree_util.tree_flatten(jlm.init_abstract(jcfg))
    assert tree.num_leaves == jtree.num_leaves
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_unflatten(tree, [0] * len(shapes))) == jtree
    assert [s for s, _ in shapes] == [a.shape for a in abstract]
    total = sum(int(np.prod(s)) for s, _ in shapes)
    assert round(total / 1e6, 2) == millions


@pytest.mark.parametrize("name,n_layers,millions", [
    ("mamba2-780m", 48, 780.15), ("recurrentgemma-9b", 38, 9396.41),
    ("recurrentgemma-9b", 5, 2174.92)])
def test_full_width_recurrent_layouts(name, n_layers, millions):
    """The recurrent archs at full width, counted from ``param_shapes``
    alone (no weights): the layout is the reference's leaf for leaf, at
    full depth and at the five-layer cut (one rglru, rglru, local_attn
    period and the two-layer rglru suffix) that ``chip_smoke.py`` loads."""
    _hold_full_width_layout(name, n_layers, millions)


@pytest.mark.parametrize("name,n_layers,millions", [
    ("minicpm3-4b", 62, 4261.90), ("deepseek-moe-16b", 4, 2267.04),
    ("deepseek-moe-16b", 28, 16375.73), ("qwen3-moe-235b-a22b", 2, 6220.17),
    ("qwen3-moe-235b-a22b", 94, 235093.63)])
def test_full_width_mla_moe_layouts(name, n_layers, millions):
    """minicpm3-4b (MLA) at full width and depth, and the MoE archs at full
    width at the depths ``chip_smoke.py`` loads (deepseek-moe-16b's dense
    first layer and three MoE layers; two qwen3 layers) and at full depth,
    counted from ``param_shapes`` alone: the reference's layout leaf for
    leaf."""
    _hold_full_width_layout(name, n_layers, millions)
