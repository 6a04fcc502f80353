"""Config-driven decoder LM: forward / prefill / decode (the dense path of
``repro.models.lm``).

The reference tiles ``block_pattern`` over ``n_layers`` and splits the
layers into a prefix (MoE-exception layers, unrolled), groups (a scan over
stacked repeats of one pattern period) and a suffix (the remainder). Its
parameter tree keeps that split, with stacked ``groups`` leaves. The port
runs eagerly, so it keeps one flat list of layers: ``params_from_reference``
unstacks the groups in the reference's layer order, and ``_layer_plan``
(kept as the reference has it) says where each layer sits.

Weights: ``init_params_numpy(cfg, seed)`` builds the reference's tree
with numpy (normal(0.02) kernels and tables, zero biases, unit norm
scales), since JAX's PRNG cannot be reproduced here; the JAX package takes
the same arrays as its ``params``. ``params_from_reference`` turns such a
tree into the port's model, a :class:`DecoderLM`, casting matmul kernels,
biases and tables to bf16 once (the reference casts them at every use, to
the same bits) and keeping norm scales fp32.

Block kinds: ``attn`` and ``local_attn`` with the swiglu / geglu / gelu
FFN. ``mla``, ``ssd``, ``rglru`` and the MoE FFN raise
``NotImplementedError`` naming ROADMAP queue 1 item 8.2. There are no
sharding constraints (the reference's ``aconstraint`` is a no-op on one
device; the partition rules are item 8.4); ``loss_fn`` and remat wait for
the training item 8.3.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

PORTED_KINDS = ("attn", "local_attn")
PORTED_FFNS = ("swiglu", "geglu", "gelu")
_ITEM = "ROADMAP queue 1 item 8.2"
# Leaves cast to bf16 at load (the reference casts them at every use).
_BF16_LEAVES = ("kernel", "bias", "table")
INIT_STDDEV = 0.02  # the reference's default_kernel_init


# ---------------------------------------------------------------------------
# config adapters
# ---------------------------------------------------------------------------
def attn_config(cfg: ArchConfig, kind: str) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        window=cfg.window if kind == "local_attn" else 0,
        q_block=cfg.q_block,
        rms_eps=cfg.rms_eps, kv_quant=cfg.kv_quant)


def _ffn_kind(cfg: ArchConfig, layer_idx: int, mixer_kind: str) -> str:
    if mixer_kind == "ssd":
        return "none"
    if cfg.ffn == "moe":
        return "dense" if layer_idx < cfg.first_k_dense else "moe"
    return cfg.ffn  # swiglu | geglu | gelu


def _layer_plan(cfg: ArchConfig):
    """-> (prefix_idx, group_reps, suffix_idx, kinds). Groups start after
    the prefix."""
    kinds = cfg.layer_kinds
    period = len(cfg.block_pattern)
    prefix_n = cfg.first_k_dense if cfg.ffn == "moe" else 0
    # align prefix up to a period boundary so groups are uniform
    prefix_n = -(-prefix_n // period) * period if prefix_n else 0
    rem = cfg.n_layers - prefix_n
    reps = rem // period
    suffix_n = rem - reps * period
    prefix = list(range(prefix_n))
    suffix = list(range(cfg.n_layers - suffix_n, cfg.n_layers))
    return prefix, reps, suffix, kinds


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a block kind or FFN this slice
    does not build."""
    for kind in dict.fromkeys(cfg.layer_kinds):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet ({_ITEM}"
                f"; ported: {', '.join(PORTED_KINDS)})")
    if cfg.ffn not in PORTED_FFNS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.ffn!r} FFN is not ported yet ({_ITEM}; "
            f"ported: {', '.join(PORTED_FFNS)})")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ArchConfig, kind: str, ffn_kind: str) -> dict:
    """The reference's parameter layout of one layer: nested dict of
    (shape, init) leaves, init one of "normal", "zeros", "ones"."""
    a = attn_config(cfg, kind)
    d = cfg.d_model

    def dense(d_in, d_out, bias=False):
        p = {"kernel": ((d_in, d_out), "normal")}
        if bias:
            p["bias"] = ((d_out,), "zeros")
        return p

    mixer = {"wq": dense(d, a.n_heads * a.d_head, a.qkv_bias),
             "wk": dense(d, a.n_kv_heads * a.d_head, a.qkv_bias),
             "wv": dense(d, a.n_kv_heads * a.d_head, a.qkv_bias),
             "wo": dense(a.n_heads * a.d_head, d)}
    if a.qk_norm:
        mixer["q_norm"] = ((a.d_head,), "ones")
        mixer["k_norm"] = ((a.d_head,), "ones")
    if ffn_kind == "gelu":
        ffn = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d)}
    else:  # swiglu | geglu share the layout
        ffn = {"wi": dense(d, cfg.d_ff), "wg": dense(d, cfg.d_ff),
               "wo": dense(cfg.d_ff, d)}
    return {"mixer_norm": {"scale": ((d,), "ones")}, "mixer": mixer,
            "ffn_norm": {"scale": ((d,), "ones")}, "ffn": ffn}


def _fill(shapes: dict, seed: int, path: str, lead: tuple = ()) -> dict:
    """numpy arrays for a shape tree; each normal leaf is drawn from its own
    generator, seeded by (seed, crc32 of its path)."""
    out = {}
    for name, spec in shapes.items():
        here = f"{path}/{name}" if path else name
        if isinstance(spec, dict):
            out[name] = _fill(spec, seed, here, lead)
            continue
        shape, init = spec
        shape = lead + shape
        if init == "normal":
            rng = np.random.default_rng([seed, zlib.crc32(here.encode())])
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= np.float32(INIT_STDDEV)
        else:
            arr = (np.zeros if init == "zeros" else np.ones)(shape,
                                                             np.float32)
        out[name] = arr
    return out


def init_params_numpy(cfg: ArchConfig, seed: int = 0) -> dict:
    """The reference's parameter tree for ``cfg`` as fp32 numpy arrays
    (``groups`` leaves stacked over repeats), made from ``seed``: what the
    JAX package's ``lm.init_params`` returns, with numpy's draws in place of
    JAX's PRNG."""
    check_supported(cfg)
    prefix, reps, suffix, kinds = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    d, v = cfg.d_model, cfg.vocab_size
    top: dict = {}
    if cfg.embed_inputs:
        top["embed"] = {"table": ((v, d), "normal")}
    top["final_norm"] = {"scale": ((d,), "ones")}
    if not cfg.tie_embeddings:
        top["lm_head"] = {"kernel": ((d, v), "normal")}
    tree = _fill(top, seed, "")

    def layer(li):
        return _layer_shapes(cfg, kinds[li], _ffn_kind(cfg, li, kinds[li]))

    if prefix:
        tree["prefix"] = {str(i): _fill(layer(li), seed, f"prefix/{i}")
                          for i, li in enumerate(prefix)}
    if reps:
        base = len(prefix)
        tree["groups"] = {str(j): _fill(layer(base + j), seed, f"groups/{j}",
                                        (reps,))
                          for j in range(period)}
    if suffix:
        tree["suffix"] = {str(i): _fill(layer(li), seed, f"suffix/{i}")
                          for i, li in enumerate(suffix)}
    return tree


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: subtrees are child modules,
    leaves are buffers (inference weights, no gradients). ``p["name"]`` and
    ``"name" in p`` read it as the reference's functions read a dict, and
    ``.to(device)`` moves it all."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_buffer(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._buffers


class DecoderLM(ParamTree):
    """The port's model: ``embed`` (if the arch embeds tokens),
    ``final_norm``, ``lm_head`` (untied heads) and ``layers`` ("0".."L-1",
    the reference's layer order). ``forward`` is :func:`forward`."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        check_supported(cfg)
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens=None, embeds=None, positions=None):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds,
                       positions=positions)


def _leaf_tensor(name: str, arr, device) -> torch.Tensor:
    t = torch.tensor(np.asarray(arr), dtype=torch.float32)
    if name in _BF16_LEAVES:
        t = t.to(torch.bfloat16)
    return t.to(device)


def _convert(tree: dict, device, index=None) -> dict:
    """numpy subtree -> tensors on ``device``; ``index`` takes one repeat
    of stacked group leaves."""
    return {name: (_convert(v, device, index) if isinstance(v, dict) else
                   _leaf_tensor(name, v if index is None else v[index],
                                device))
            for name, v in tree.items()}


def params_from_reference(tree: dict, cfg: ArchConfig,
                          device="cuda") -> DecoderLM:
    """The reference's parameter tree (numpy arrays, stacked ``groups``
    leaves, as ``lm.init_params`` gives it after ``np.asarray``) as the
    port's :class:`DecoderLM` on ``device`` (default ``"cuda"``; raises
    without a card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    prefix, reps, suffix, _ = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    out = {name: _convert(tree[name], dev)
           for name in ("embed", "final_norm", "lm_head") if name in tree}
    layers = {}
    for i, li in enumerate(prefix):
        layers[li] = _convert(tree["prefix"][str(i)], dev)
    base = len(prefix)
    for r in range(reps):
        for j in range(period):
            layers[base + r * period + j] = _convert(tree["groups"][str(j)],
                                                     dev, r)
    for i, li in enumerate(suffix):
        layers[li] = _convert(tree["suffix"][str(i)], dev)
    out["layers"] = {str(li): layers[li] for li in range(cfg.n_layers)}
    return DecoderLM(cfg, out)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> DecoderLM:
    """:func:`init_params_numpy` as a :class:`DecoderLM` on ``device``."""
    return params_from_reference(init_params_numpy(cfg, seed), cfg, device)


def param_count(model: DecoderLM) -> int:
    return sum(b.numel() for b in model.buffers())


def param_bytes(model: DecoderLM) -> int:
    return sum(b.numel() * b.element_size() for b in model.buffers())


# ---------------------------------------------------------------------------
# per-layer forward / prefill / decode
# ---------------------------------------------------------------------------
def _layer_kinds(cfg: ArchConfig, li: int):
    kind = cfg.layer_kinds[li]
    return kind, _ffn_kind(cfg, li, kind)


def _ffn_apply(p, x, cfg: ArchConfig, ffn_kind: str):
    h = L.rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
    if ffn_kind == "gelu":
        h = L.gelu_mlp(p["ffn"], h)
    elif ffn_kind == "geglu":
        h = L.geglu(p["ffn"], h)
    else:
        h = L.swiglu(p["ffn"], h)
    return x + h


def _layer_forward(p, x, positions, cfg: ArchConfig, kind: str,
                   ffn_kind: str):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    h = attn.gqa_forward(p["mixer"], h, positions, attn_config(cfg, kind))
    return _ffn_apply(p, x + h, cfg, ffn_kind)


def _layer_prefill(p, x, positions, cfg: ArchConfig, kind: str,
                   ffn_kind: str, max_len: int):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    h, cache = attn.gqa_prefill_cache(p["mixer"], h, positions,
                                      attn_config(cfg, kind), max_len)
    return _ffn_apply(p, x + h, cfg, ffn_kind), cache


def _layer_decode(p, x, pos: int, positions, cache, cfg: ArchConfig,
                  kind: str, ffn_kind: str):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    h, cache = attn.gqa_decode_step(p["mixer"], h, pos, cache,
                                    attn_config(cfg, kind), positions)
    return _ffn_apply(p, x + h, cfg, ffn_kind), cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _embed_in(params, cfg: ArchConfig, tokens=None, embeds=None):
    if cfg.embed_inputs:
        if tokens is None:
            raise ValueError(f"{cfg.name} embeds tokens: pass tokens=")
        return L.embed(params["embed"], tokens)
    if embeds is None:
        raise ValueError(f"{cfg.name} takes precomputed embeddings: pass "
                         "embeds=")
    return embeds.to(torch.bfloat16)


def _head(params, cfg: ArchConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = L.dense(params["lm_head"], x).float()
    if cfg.logit_soft_cap:
        logits = cfg.logit_soft_cap * torch.tanh(logits / cfg.logit_soft_cap)
    return logits


@torch.inference_mode()
def forward(params, cfg: ArchConfig, tokens=None, embeds=None,
            positions=None):
    """-> (logits (B,S,V) fp32, aux scalar). aux is the MoE auxiliary loss
    in the reference; 0 for the dense kinds ported here."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    for li in range(cfg.n_layers):
        x = _layer_forward(params["layers"][str(li)], x, positions, cfg,
                           *_layer_kinds(cfg, li))
    return _head(params, cfg, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> list:
    """One empty KV cache a layer, in layer order."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [attn.gqa_init_cache(batch, max_len,
                                attn_config(cfg, cfg.layer_kinds[li]), dtype,
                                dev)
            for li in range(cfg.n_layers)]


@torch.inference_mode()
def prefill(params, cfg: ArchConfig, tokens=None, embeds=None,
            max_len: int | None = None):
    """Run the prompt; -> (last-position logits (B,V), caches at len S, one
    a layer)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens, embeds)
    s = x.shape[1]
    max_len = max_len or s
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = []
    for li in range(cfg.n_layers):
        x, c = _layer_prefill(params["layers"][str(li)], x, positions, cfg,
                              *_layer_kinds(cfg, li), max_len)
        caches.append(c)
    return _head(params, cfg, x[:, -1:])[:, 0], caches


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, pos: int, cache: list, token=None,
                embed=None):
    """One token for the whole batch at absolute position ``pos``.

    token: (B,) int or embed: (B, D). Writes each layer's cache in place;
    -> (logits (B,V), cache)."""
    if cfg.embed_inputs:
        x = L.embed(params["embed"], token[:, None])
    else:
        x = embed[:, None].to(torch.bfloat16)
    pos = int(pos)
    # made once a step on the device, so no layer copies it from the host
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for li in range(cfg.n_layers):
        x, cache[li] = _layer_decode(params["layers"][str(li)], x, pos,
                                     positions, cache[li], cfg,
                                     *_layer_kinds(cfg, li))
    return _head(params, cfg, x)[:, 0], cache
