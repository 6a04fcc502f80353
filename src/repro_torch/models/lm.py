"""Config-driven decoder LM: forward and loss / prefill / decode, and the
logical sharding rules of its leaves (port of ``repro.models.lm``).

The reference tiles ``block_pattern`` over ``n_layers`` and splits the
layers into a prefix (MoE-exception layers, unrolled), groups (a scan over
stacked repeats of one pattern period) and a suffix (the remainder). Its
parameter tree keeps that split, with stacked ``groups`` leaves. The port
runs eagerly, so it keeps one flat list of layers: ``params_from_reference``
unstacks the groups in the reference's layer order, and ``_layer_plan``
(kept as the reference has it) says where each layer sits.

Weights: ``init_params_numpy(cfg, seed)`` builds the reference's tree
with numpy (normal(0.02) kernels and tables, zero biases, unit norm
scales, and the SSM blocks' own initialisers: normal(0.1) conv weights,
``A_log = log(1..n_heads)``, unit ``D``, Griffin's ``lambda``), since
JAX's PRNG cannot be reproduced here; the JAX package takes the same
arrays as its ``params``. ``params_from_reference`` turns such a tree into
the port's model, a :class:`DecoderLM`, casting matmul kernels, biases,
tables and the MoE experts' ``wi`` / ``wg`` / ``wo`` to bf16 once (the
reference casts them at every use, to the same bits) and keeping fp32 the
norm scales, the SSM vectors and the leaves the reference also reads in
fp32: the RG-LRU gates ``w_a`` / ``w_i``, the MoE router and MLA's
``wuk`` / ``wuv`` (the absorbed decode's masters; its forward casts them
to bf16 at use, as the reference does).

Block kinds: ``attn`` and ``local_attn``, ``mla`` (latent attention,
``models.attention``), ``ssd`` (Mamba-2, no FFN) and ``rglru`` (Griffin's
recurrent block), from ``models.ssm``; FFNs swiglu / geglu / gelu and the
MoE FFN (``models.moe``) after an optional ``first_k_dense`` prefix of
SwiGLU layers. A layer's decode state is the cache dict of an attention
layer (K/V, or MLA's latent ``c`` and ``k_rope``) or the (conv state,
recurrent state) tuple of an SSM layer. The reference's activation
constraints (``aconstraint``) lay out nothing without a compiler and are
left out; a MoE layer takes ``models.moe_ep``'s expert-parallel forward
when an active ``launch.partition.partitioning`` context selects it
(``_moe_dispatch``), else ``models.moe``'s.

Sharding: ``PARAM_RULES`` maps the reference's leaf paths to logical axis
names. ``param_logical_axes`` and ``cache_logical_axes`` give the
reference's trees of names, over the reference's layout
(``abstract_reference``, and ``reference_cache`` of ``init_cache(...,
device="meta")``: ``groups`` leaves stacked, with a leading None), for
``launch.partition.param_sharding``.

Training: ``params_from_reference(..., trainable=True)`` (and
``init_params`` / ``init_abstract``) give a model whose leaves are all
fp32 ``nn.Parameter``s, the reference's masters; the layers cast them at
use, so its forward gives the serving model's bits. ``forward`` builds an
autograd graph when the leaves require grad (a serving model's buffers do
not); ``prefill`` and ``decode_step`` stay under ``torch.inference_mode``.
``loss_fn`` is the reference's cross-entropy plus the MoE aux, and
``forward(..., remat=)`` checkpoints one pattern period of the grouped
layers at a time, as the reference remats its scanned group function.
``reference_layout`` maps each leaf of the reference's tree (``groups``
leaves stacked over repeats) to the port's parameters, for the optimizer
(Adafactor factors the stacked leaves) and the checkpoints.
"""
from __future__ import annotations

import functools
import os
import re
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.partition import active_context
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_ep
from repro_torch.models import ssm as ssm_lib

# Leaves cast to bf16 at load (the reference casts them at every use): the
# dense layers' leaves and the MoE experts' raw (E, ...) arrays
_BF16_LEAVES = ("kernel", "bias", "table", "wi", "wg", "wo")
# ... except under these, read in fp32 by the reference: the RG-LRU gates,
# the MoE router, MLA's absorbed-decode masters
_FP32_DENSE = ("w_a", "w_i", "router", "wuk", "wuv")
INIT_STDDEV = 0.02  # the reference's default_kernel_init
CONV_STDDEV = 0.1   # the SSM blocks' conv_w init (models/ssm.py)


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
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        rms_eps=cfg.rms_eps, kv_quant=cfg.kv_quant)


def ssm_config(cfg: ArchConfig) -> ssm_lib.SSMConfig:
    return ssm_lib.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                             expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                             chunk=cfg.ssm_chunk, conv_width=cfg.conv_width)


def rglru_config(cfg: ArchConfig) -> ssm_lib.RGLRUConfig:
    return ssm_lib.RGLRUConfig(d_model=cfg.d_model,
                               lru_width=cfg.lru_width or cfg.d_model,
                               conv_width=cfg.conv_width)


def moe_config(cfg: ArchConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_expert=cfg.d_expert, n_shared_experts=cfg.n_shared_experts,
        normalize_topk=cfg.normalize_topk,
        capacity_factor=cfg.capacity_factor)


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


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ArchConfig, kind: str, ffn_kind: str) -> dict:
    """The reference's parameter layout of one layer (its ``_layer_init``,
    with ``mla_init``, ``mamba2_init``, ``rglru_block_init`` and
    ``moe_init`` for those kinds): a nested dict of (shape, init) leaves,
    init one of "normal" (``INIT_STDDEV``), "conv" (``CONV_STDDEV``),
    "zeros", "ones", "a_log" (log(1..n_heads)) or "lambda" (Griffin's Λ).
    Raises ``ValueError`` for an unknown block kind or FFN, as the
    reference does."""
    d = cfg.d_model

    def dense(d_in, d_out, bias=False):
        p = {"kernel": ((d_in, d_out), "normal")}
        if bias:
            p["bias"] = ((d_out,), "zeros")
        return p

    if kind == "ssd":
        s = ssm_config(cfg)
        conv_dim = s.d_inner + 2 * s.d_state
        # fused input projection: [z | x | B | C | dt]
        mixer = {"in_proj": dense(d, 2 * s.d_inner + 2 * s.d_state
                                  + s.n_heads),
                 "conv_w": ((s.conv_width, conv_dim), "conv"),
                 "conv_b": ((conv_dim,), "zeros"),
                 "A_log": ((s.n_heads,), "a_log"),
                 "D": ((s.n_heads,), "ones"),
                 "dt_bias": ((s.n_heads,), "zeros"),
                 "norm": {"scale": ((s.d_inner,), "ones")},
                 "out_proj": dense(s.d_inner, d)}
    elif kind == "rglru":
        r = rglru_config(cfg)
        w = r.lru_width
        mixer = {"w_gate": dense(d, w), "w_rec_in": dense(d, w),
                 "conv_w": ((r.conv_width, w), "conv"),
                 "conv_b": ((w,), "zeros"),
                 "w_a": dense(w, w, bias=True), "w_i": dense(w, w, bias=True),
                 "lambda": ((w,), "lambda"),
                 "w_out": dense(w, d)}
    elif kind == "mla":
        a = attn_config(cfg, kind)
        dqk = a.qk_nope_head_dim + a.qk_rope_head_dim
        # wdkv fuses the kv-down and rope-k projections (DeepSeek layout)
        mixer = {"wdq": dense(d, a.q_lora_rank),
                 "q_norm": {"scale": ((a.q_lora_rank,), "ones")},
                 "wuq": dense(a.q_lora_rank, a.n_heads * dqk),
                 "wdkv": dense(d, a.kv_lora_rank + a.qk_rope_head_dim),
                 "kv_norm": {"scale": ((a.kv_lora_rank,), "ones")},
                 "wuk": dense(a.kv_lora_rank, a.n_heads * a.qk_nope_head_dim),
                 "wuv": dense(a.kv_lora_rank, a.n_heads * a.v_head_dim),
                 "wo": dense(a.n_heads * a.v_head_dim, d)}
    elif kind in ("attn", "local_attn"):
        a = attn_config(cfg, kind)
        mixer = {"wq": dense(d, a.n_heads * a.d_head, a.qkv_bias),
                 "wk": dense(d, a.n_kv_heads * a.d_head, a.qkv_bias),
                 "wv": dense(d, a.n_kv_heads * a.d_head, a.qkv_bias),
                 "wo": dense(a.n_heads * a.d_head, d)}
        if a.qk_norm:
            mixer["q_norm"] = ((a.d_head,), "ones")
            mixer["k_norm"] = ((a.d_head,), "ones")
    else:
        raise ValueError(kind)
    layer = {"mixer_norm": {"scale": ((d,), "ones")}, "mixer": mixer}

    def swiglu(width):
        return {"wi": dense(d, width), "wg": dense(d, width),
                "wo": dense(width, d)}

    if ffn_kind == "none":
        return layer
    if ffn_kind == "moe":
        m = moe_config(cfg)
        e, f = m.n_experts, m.d_expert
        ffn = {"router": dense(d, e),      # fp32 in the reference
               "wi": ((e, d, f), "normal"), "wg": ((e, d, f), "normal"),
               "wo": ((e, f, d), "normal")}
        if m.n_shared_experts:
            ffn["shared"] = swiglu(m.n_shared_experts * f)
    elif ffn_kind == "dense":  # the first_k_dense prefix of a MoE arch
        ffn = swiglu(cfg.dense_d_ff or cfg.d_ff)
    elif ffn_kind == "gelu":
        ffn = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d)}
    elif ffn_kind in ("swiglu", "geglu"):  # they share the layout
        ffn = swiglu(cfg.d_ff)
    else:
        raise ValueError(ffn_kind)
    return {**layer, "ffn_norm": {"scale": ((d,), "ones")}, "ffn": ffn}


def _draw(path: str, shape: tuple, init: str, seed: int) -> np.ndarray:
    """One leaf; a random one from its own generator, seeded by (seed,
    crc32 of its path)."""
    if init in ("normal", "conv", "lambda"):
        rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
        if init == "lambda":  # a = exp(-c softplus(Λ)) in (0.9, 0.999)
            u = rng.uniform(0.9 ** 2, 0.999 ** 2, shape).astype(np.float32)
            return np.log(np.expm1(-np.log(u)
                                   / np.float32(2 * ssm_lib.RGLRU_C)))
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= np.float32(INIT_STDDEV if init == "normal" else CONV_STDDEV)
        return arr
    if init == "a_log":
        return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1,
                                                dtype=np.float32)),
                               shape).copy()
    return (np.zeros if init == "zeros" else np.ones)(shape, np.float32)


def _fill(shapes: dict, seed: int, path: str, pool) -> dict:
    """A shape tree as a tree of futures of its numpy leaves, drawn on
    ``pool`` (each leaf has its own generator, so the threads give the
    same arrays in any order)."""
    out = {}
    for name, spec in shapes.items():
        here = f"{path}/{name}" if path else name
        if isinstance(spec, dict):
            out[name] = _fill(spec, seed, here, pool)
        else:
            out[name] = pool.submit(_draw, here, *spec, seed)
    return out


def _results(tree: dict) -> dict:
    return {name: _results(v) if isinstance(v, dict) else v.result()
            for name, v in tree.items()}


def _stacked(shapes: dict, reps: int) -> dict:
    return {name: (_stacked(v, reps) if isinstance(v, dict) else
                   ((reps,) + v[0], v[1]))
            for name, v in shapes.items()}


def param_shapes(cfg: ArchConfig) -> dict:
    """The reference's parameter tree for ``cfg`` as (shape, init) leaves
    (see ``_layer_shapes``), ``groups`` leaves stacked over repeats: the
    layout of ``init_params_numpy``, without drawing a weight."""
    prefix, reps, suffix, kinds = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    d, v = cfg.d_model, cfg.vocab_size
    tree: dict = {}
    if cfg.embed_inputs:
        tree["embed"] = {"table": ((v, d), "normal")}
    tree["final_norm"] = {"scale": ((d,), "ones")}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": ((d, v), "normal")}

    def layer(li):
        return _layer_shapes(cfg, kinds[li], _ffn_kind(cfg, li, kinds[li]))

    if prefix:
        tree["prefix"] = {str(i): layer(li) for i, li in enumerate(prefix)}
    if reps:
        base = len(prefix)
        tree["groups"] = {str(j): _stacked(layer(base + j), reps)
                          for j in range(period)}
    if suffix:
        tree["suffix"] = {str(i): layer(li) for i, li in enumerate(suffix)}
    return tree


def init_params_numpy(cfg: ArchConfig, seed: int = 0) -> dict:
    """The reference's parameter tree for ``cfg`` as fp32 numpy arrays
    (``groups`` leaves stacked over repeats), made from ``seed``: what the
    JAX package's ``lm.init_params`` returns, with numpy's draws in place of
    JAX's PRNG. The leaves are drawn on up to 8 threads."""
    shapes = param_shapes(cfg)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return _results(_fill(shapes, seed, "", pool))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: subtrees are child modules,
    leaves are buffers (inference weights, no gradients) or, with
    ``trainable``, ``nn.Parameter``s. ``p["name"]`` and ``"name" in p`` read
    it as the reference's functions read a dict, and ``.to(device)`` moves
    it all."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value, trainable))
            elif trainable:
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return (name in self._modules or name in self._buffers
                or name in self._parameters)


class DecoderLM(ParamTree):
    """The port's model: ``embed`` (if the arch embeds tokens),
    ``final_norm``, ``lm_head`` (untied heads) and ``layers`` ("0".."L-1",
    the reference's layer order). ``forward`` is :func:`forward`."""

    def __init__(self, cfg: ArchConfig, tree: dict, trainable: bool = False):
        super().__init__(tree, trainable)
        self.cfg = cfg

    def forward(self, tokens=None, embeds=None, positions=None,
                remat: str = "none"):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds,
                       positions=positions, remat=remat)


def bf16_leaf(path) -> bool:
    """Whether the leaf at ``path`` (its names from the root) is cast to
    bf16 at load: ``_BF16_LEAVES`` but for those under ``_FP32_DENSE``."""
    return path[-1] in _BF16_LEAVES and not set(path[:-1]) & set(_FP32_DENSE)


def _leaf_tensor(arr, device, bf16: bool) -> torch.Tensor:
    """A numpy leaf as a new tensor on ``device``, in bf16 or fp32 (one
    copy: the conversion and the move together)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if not arr.flags.writeable:  # a read-only view (e.g. of a JAX array)
        arr = arr.copy()
    dtype = torch.bfloat16 if bf16 else torch.float32
    return torch.from_numpy(arr).to(device=device, dtype=dtype, copy=True)


def _convert(tree: dict, device, index=None, path=(), fp32=False) -> dict:
    """numpy subtree at ``path`` -> tensors on ``device``, bf16 where
    :func:`bf16_leaf` says unless ``fp32``; ``index`` takes one repeat of
    stacked group leaves."""
    return {name: (_convert(v, device, index, path + (name,), fp32)
                   if isinstance(v, dict) else
                   _leaf_tensor(v if index is None else v[index], device,
                                not fp32 and bf16_leaf(path + (name,))))
            for name, v in tree.items()}


def _port_tree(tree: dict, cfg: ArchConfig, convert) -> dict:
    """The reference's tree in the port's layout (``layers`` "0".."L-1"),
    each subtree made by ``convert(subtree, index)`` (``index`` the repeat
    of a stacked group leaf, else None)."""
    prefix, reps, suffix, _ = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    out = {name: convert(tree[name], None)
           for name in ("embed", "final_norm", "lm_head") if name in tree}
    layers = {}
    for i, li in enumerate(prefix):
        layers[li] = convert(tree["prefix"][str(i)], None)
    base = len(prefix)
    for r in range(reps):
        for j in range(period):
            layers[base + r * period + j] = convert(tree["groups"][str(j)], r)
    for i, li in enumerate(suffix):
        layers[li] = convert(tree["suffix"][str(i)], None)
    out["layers"] = {str(li): layers[li] for li in range(cfg.n_layers)}
    return out


def params_from_reference(tree: dict, cfg: ArchConfig, device="cuda",
                          trainable: bool = False) -> DecoderLM:
    """The reference's parameter tree (numpy arrays, stacked ``groups``
    leaves, as ``lm.init_params`` gives it after ``np.asarray``) as the
    port's :class:`DecoderLM` on ``device`` (default ``"cuda"``; raises
    without a card). ``trainable``: every leaf an fp32 ``nn.Parameter``
    (the reference's training masters) instead of the serving buffers."""
    dev = resolve_device(device)
    return DecoderLM(cfg, _port_tree(
        _ordered(tree, param_shapes(cfg)), cfg,
        lambda sub, r: _convert(sub, dev, r, fp32=trainable)), trainable)


def _ordered(tree: dict, like: dict) -> dict:
    """``tree``'s keys in ``like``'s order (a tree read back from a
    checkpoint or through JAX comes with sorted keys), so the model's
    parameters, and the global-norm sum over them, take one order
    whatever the source."""
    return {k: _ordered(tree[k], v) if isinstance(v, dict) else tree[k]
            for k, v in like.items()}


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> DecoderLM:
    """:func:`init_params_numpy` as a :class:`DecoderLM` on ``device``."""
    return params_from_reference(init_params_numpy(cfg, seed), cfg, device,
                                 trainable)


def init_abstract(cfg: ArchConfig) -> DecoderLM:
    """The trainable model's parameters as fp32 tensors on the ``meta``
    device: shapes and dtypes, nothing allocated (the restore target)."""
    def meta(sub, r):
        return {name: meta(v, r) if isinstance(v, dict) else torch.empty(
            v[0] if r is None else v[0][1:], device="meta")
            for name, v in sub.items()}
    return DecoderLM(cfg, _port_tree(param_shapes(cfg), cfg, meta), True)


def reference_layout(cfg: ArchConfig) -> list:
    """Each leaf of the reference's parameter tree, in ``param_shapes``
    order, as ``(path, names, stacked)``: ``path`` its keys (a tuple),
    ``names`` the port's parameter names ("."-joined) that it holds, and
    ``stacked`` True for a ``groups`` leaf, whose repeats (``names``, in
    repeat order) stack along a leading dim, even a single repeat."""
    prefix, reps, suffix, _ = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    base = len(prefix)
    out = []

    def walk(tree, path):
        for name, v in tree.items():
            p = path + (name,)
            if isinstance(v, dict):
                walk(v, p)
            elif p[0] == "groups":
                rest = ".".join(p[2:])
                out.append((p, [f"layers.{base + r * period + int(p[1])}."
                                f"{rest}" for r in range(reps)], True))
            elif p[0] in ("prefix", "suffix"):
                li = (prefix if p[0] == "prefix" else suffix)[int(p[1])]
                out.append((p, [f"layers.{li}." + ".".join(p[2:])], False))
            else:
                out.append((p, [".".join(p)], False))

    walk(param_shapes(cfg), ())
    return out


def to_reference(cfg: ArchConfig, flat: dict) -> dict:
    """Tensors keyed by the port's parameter names (parameters, gradients,
    AdamW moments) as the reference's nested tree, ``groups`` leaves
    stacked over repeats (``torch.stack``: new tensors)."""
    tree: dict = {}
    for path, names, stacked in reference_layout(cfg):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (torch.stack([flat[n] for n in names]) if stacked
                          else flat[names[0]])
    return tree


def from_reference(cfg: ArchConfig, tree: dict) -> dict:
    """The inverse of :func:`to_reference`: the port's parameter names ->
    the leaves of a reference tree (a repeat of a stacked leaf is an index
    into it)."""
    out = {}
    for path, names, stacked in reference_layout(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        for r, name in enumerate(names):
            out[name] = leaf[r] if stacked else leaf
    return out


# ---------------------------------------------------------------------------
# logical sharding rules (path regex -> logical axis names per dim)
# ---------------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("vocab", "fsdp")),
    (r"lm_head/kernel$", ("fsdp", "vocab")),
    (r"mixer/wq/kernel$", ("fsdp", "heads")),
    (r"mixer/w[kv]/kernel$", ("fsdp", "kv_heads")),
    (r"mixer/wo/kernel$", ("heads", "fsdp")),
    (r"mixer/wq/bias$", ("heads",)),
    (r"mixer/w[kv]/bias$", ("kv_heads",)),
    (r"mixer/wdq/kernel$", ("fsdp", None)),
    (r"mixer/wuq/kernel$", (None, "heads")),
    (r"mixer/wdkv/kernel$", ("fsdp", None)),
    (r"mixer/wu[kv]/kernel$", (None, "heads")),
    (r"ffn/w[ig]/kernel$", ("fsdp", "mlp")),
    (r"ffn/wo/kernel$", ("mlp", "fsdp")),
    (r"ffn/shared/w[ig]/kernel$", ("fsdp", "mlp")),
    (r"ffn/shared/wo/kernel$", ("mlp", "fsdp")),
    (r"ffn/router/kernel$", ("fsdp", None)),
    (r"ffn/wi$", ("expert", "fsdp", "expert_mlp")),
    (r"ffn/wg$", ("expert", "fsdp", "expert_mlp")),
    (r"ffn/wo$", ("expert", "expert_mlp", "fsdp")),
    (r"mixer/in_proj/kernel$", ("fsdp", "mlp")),
    (r"mixer/out_proj/kernel$", ("mlp", "fsdp")),
    (r"mixer/w_gate/kernel$", ("fsdp", "mlp")),
    (r"mixer/w_rec_in/kernel$", ("fsdp", "mlp")),
    (r"mixer/w_[ai]/kernel$", (None, "mlp")),
    (r"mixer/w_[ai]/bias$", ("mlp",)),
    (r"mixer/w_out/kernel$", ("mlp", "fsdp")),
    (r"mixer/conv_w$", (None, "mlp")),
    (r"mixer/conv_b$", ("mlp",)),
    (r"mixer/lambda$", ("mlp",)),
    (r"mixer/(A_log|D|dt_bias)$", (None,)),
    (r".*(norm.*/scale|q_norm|k_norm)$", (None,)),
]


def _map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` at every leaf of nested dicts and tuples
    (``path`` "/"-joined keys and tuple indices, as the reference's
    ``_path_str``); keeps the structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{path}/{i}" if path else
                                     str(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def abstract_reference(cfg: ArchConfig) -> dict:
    """The reference's parameter tree (``groups`` leaves stacked) as fp32
    ``meta`` tensors: the reference's ``init_abstract``."""
    def leaf(v):
        return (leaf_tree(v) if isinstance(v, dict) else
                torch.empty(v[0], device="meta"))

    def leaf_tree(t):
        return {k: leaf(v) for k, v in t.items()}
    return leaf_tree(param_shapes(cfg))


def param_logical_axes(params_or_cfg):
    """Tree of logical-name tuples over the reference's parameter layout
    (an ``ArchConfig`` or a model: its ``abstract_reference``; or a
    reference-layout tree of leaves with ``.shape``). Stacked ``groups``
    leaves get a leading None for the repeat dim."""
    cfg = getattr(params_or_cfg, "cfg", params_or_cfg)
    tree = (abstract_reference(cfg) if isinstance(cfg, ArchConfig)
            else params_or_cfg)

    def one(ps, leaf):
        names = None
        for pat, nm in PARAM_RULES:
            if re.search(pat, ps):
                names = nm
                break
        ndim = len(leaf.shape)
        if names is None:
            names = (None,) * ndim
        if ps.startswith("groups/"):
            names = (None,) + tuple(names)
        return tuple(names)[:ndim] + (None,) * max(0, ndim - len(names))
    return _map_paths(one, tree)


def reference_cache(cfg: ArchConfig, cache: list) -> dict:
    """The port's per-layer decode states (``init_cache``, a list in
    layer order) in the reference's cache layout: ``prefix`` / ``groups``
    / ``suffix``, each ``groups`` leaf stacked over the repeats
    (``torch.stack``: new tensors)."""
    prefix, reps, suffix, _ = _layer_plan(cfg)
    period = len(cfg.block_pattern)

    def stack(states):
        first = states[0]
        if isinstance(first, dict):
            return {k: stack([s[k] for s in states]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(stack([s[i] for s in states])
                               for i in range(len(first)))
        return torch.stack(states)

    out: dict = {}
    if prefix:
        out["prefix"] = {str(i): cache[li] for i, li in enumerate(prefix)}
    if reps:
        base = len(prefix)
        out["groups"] = {str(j): stack([cache[base + r * period + j]
                                        for r in range(reps)])
                         for j in range(period)}
    if suffix:
        out["suffix"] = {str(i): cache[li] for i, li in enumerate(suffix)}
    return out


def cache_logical_axes(cache):
    """Batch dim -> ("batch",); kv-head dim of attention caches -> model,
    over a cache in the reference's layout (:func:`reference_cache`)."""
    def one(ps, leaf):
        ndim = len(leaf.shape)
        stacked = ps.startswith("groups/")
        core = ndim - (1 if stacked else 0)
        if ps.endswith("/pos"):
            names: tuple = (None,) * core
        elif ps.endswith("/k") or ps.endswith("/v"):
            # kv_heads first; when it cannot shard (kv < TP), the sequence
            # dim picks up the model axis instead (param_sharding's axis
            # dedupe keeps them mutually exclusive)
            names = ("batch", "kv_seq", "kv_heads", None)[:core]
        elif ps.endswith("_scale"):
            names = ("batch", "kv_seq", "kv_heads")[:core]
        elif ps.endswith("/c") or ps.endswith("/k_rope"):
            names = ("batch", "kv_seq", None)[:core]
        else:  # ssm/conv states
            names = ("batch",) + (None,) * (core - 1)
        return (None,) + names if stacked else names
    return _map_paths(one, cache)


def _leaves(model: DecoderLM) -> list:
    return list(model.parameters()) + list(model.buffers())


def param_count(model: DecoderLM) -> int:
    return sum(t.numel() for t in _leaves(model))


def param_bytes(model: DecoderLM) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(model))


# ---------------------------------------------------------------------------
# per-layer forward / prefill / decode
# ---------------------------------------------------------------------------
def _layer_kinds(cfg: ArchConfig, li: int):
    kind = cfg.layer_kinds[li]
    return kind, _ffn_kind(cfg, li, kind)


def _moe_dispatch(pf, h, moe_cfg):
    """Pick the MoE implementation from the active partitioning rules:
    ``moe_ep.moe_forward_ep`` (explicit all-to-all expert parallelism)
    when ``moe_impl`` is "shard_map_ep", there is exactly one expert axis
    and the sequence divides it; else the single-program
    ``moe.moe_forward``."""
    ctx = active_context()
    if ctx is not None:
        mesh, rules = ctx
        expert_axes = rules.get("expert") or ()
        expert_axes = ((expert_axes,) if isinstance(expert_axes, str)
                       else tuple(expert_axes))
        if (rules.get("moe_impl") == "shard_map_ep"
                and len(expert_axes) == 1
                and h.shape[1] % mesh.shape[expert_axes[0]] == 0):
            return moe_ep.moe_forward_ep(pf, h, moe_cfg, mesh, rules)
    return moe_lib.moe_forward(pf, h, moe_cfg)


def _ffn_apply(p, x, cfg: ArchConfig, ffn_kind: str):
    """-> (x + the FFN's output, the layer's MoE aux loss or None)."""
    if ffn_kind == "none":
        return x, None
    h = L.rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
    aux = None
    if ffn_kind == "moe":
        h, metrics = _moe_dispatch(p["ffn"], h, moe_config(cfg))
        aux = metrics["moe_aux_total"]
    elif ffn_kind == "gelu":
        h = L.gelu_mlp(p["ffn"], h)
    elif ffn_kind == "geglu":
        h = L.geglu(p["ffn"], h)
    else:  # swiglu, and the dense prefix of a MoE arch
        h = L.swiglu(p["ffn"], h)
    return x + h, aux


def _layer_forward(p, x, positions, cfg: ArchConfig, kind: str,
                   ffn_kind: str):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    if kind == "ssd":
        h = ssm_lib.mamba2_forward(p["mixer"], h, ssm_config(cfg))
    elif kind == "rglru":
        h = ssm_lib.rglru_block_forward(p["mixer"], h, rglru_config(cfg))
    elif kind == "mla":
        h = attn.mla_forward(p["mixer"], h, positions, attn_config(cfg, kind))
    else:
        h = attn.gqa_forward(p["mixer"], h, positions, attn_config(cfg, kind))
    return _ffn_apply(p, x + h, cfg, ffn_kind)


def _layer_cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      dtype, device):
    if kind == "ssd":
        return ssm_lib.mamba2_init_state(batch, ssm_config(cfg),
                                         device=device)
    if kind == "rglru":
        return ssm_lib.rglru_init_state(batch, rglru_config(cfg),
                                        device=device)
    if kind == "mla":
        return attn.mla_init_cache(batch, max_len, attn_config(cfg, kind),
                                   dtype, device)
    if kind in ("attn", "local_attn"):
        return attn.gqa_init_cache(batch, max_len, attn_config(cfg, kind),
                                   dtype, device)
    raise ValueError(kind)


def _layer_prefill(p, x, positions, cfg: ArchConfig, kind: str,
                   ffn_kind: str, max_len: int):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    if kind == "ssd":
        h, cache = ssm_lib.mamba2_forward(p["mixer"], h, ssm_config(cfg),
                                          return_state=True)
    elif kind == "rglru":
        h, cache = ssm_lib.rglru_block_forward(p["mixer"], h,
                                               rglru_config(cfg),
                                               return_state=True)
    elif kind == "mla":
        h, cache = attn.mla_prefill_cache(p["mixer"], h, positions,
                                          attn_config(cfg, kind), max_len)
    else:
        h, cache = attn.gqa_prefill_cache(p["mixer"], h, positions,
                                          attn_config(cfg, kind), max_len)
    return _ffn_apply(p, x + h, cfg, ffn_kind)[0], cache


def _layer_decode(p, x, pos: int, positions, cache, cfg: ArchConfig,
                  kind: str, ffn_kind: str):
    h = L.rmsnorm(p["mixer_norm"], x, cfg.rms_eps)
    if kind == "ssd":
        h, cache = ssm_lib.mamba2_decode_step(p["mixer"], h, cache,
                                              ssm_config(cfg))
    elif kind == "rglru":  # the reference's block over one token
        h, cache = ssm_lib.rglru_block_forward(p["mixer"], h,
                                               rglru_config(cfg), state=cache,
                                               return_state=True)
    elif kind == "mla":
        h, cache = attn.mla_decode_step(p["mixer"], h, pos, cache,
                                        attn_config(cfg, kind), positions)
    else:
        h, cache = attn.gqa_decode_step(p["mixer"], h, pos, cache,
                                        attn_config(cfg, kind), positions)
    return _ffn_apply(p, x + h, cfg, ffn_kind)[0], cache


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


def _group_forward(params, x, positions, cfg: ArchConfig, layers):
    """The layers ``layers`` in turn; -> (x, the sum of their MoE aux
    losses in layer order, or None without a MoE layer)."""
    aux = None
    for li in layers:
        x, a = _layer_forward(params["layers"][str(li)], x, positions, cfg,
                              *_layer_kinds(cfg, li))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the 2-D
    products (``aten.mm``: every dense layer, whose 3-D activations
    ``matmul`` folds to 2-D), recompute the rest (the batched products of
    attention, the SSD and the experts among them), as the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn`` recomputed in the backward: not at all ("none"), wholly
    ("full") or but for its 2-D products ("dots"); any other ``remat``
    raises ``ValueError``, as the reference's ``_maybe_remat``."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(remat)


def forward(params, cfg: ArchConfig, tokens=None, embeds=None,
            positions=None, remat: str = "none"):
    """-> (logits (B,S,V) fp32, aux scalar fp32): aux sums the MoE layers'
    ``moe_aux_total`` in layer order (0 for an arch without MoE layers).

    Builds an autograd graph when the leaves require grad (a trainable
    model). ``remat`` applies to the grouped layers, one pattern period a
    checkpoint, as the reference remats its scanned group function; the
    prefix and suffix layers are never recomputed."""
    group_fn = _maybe_remat(_group_forward, remat)
    prefix, reps, suffix, _ = _layer_plan(cfg)
    period = len(cfg.block_pattern)
    x = _embed_in(params, cfg, tokens, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    runs = ([(_group_forward, [li]) for li in prefix]
            + [(group_fn, range(first, first + period))
               for first in range(len(prefix), len(prefix) + reps * period,
                                  period)]
            + [(_group_forward, [li]) for li in suffix])
    aux = torch.zeros((), device=x.device)
    for fn, layers in runs:
        x, a = fn(params, x, positions, cfg, layers)
        if a is not None:
            aux = aux + a
    return _head(params, cfg, x), aux


def loss_fn(params, cfg: ArchConfig, batch: dict, remat: str = "none"):
    """batch: {"tokens" | "embeds", "labels", optional "mask"} -> (loss +
    aux, {"nll": loss, "aux": aux}).

    The reference's cross-entropy: logsumexp minus the label logit, taken
    by a masked sum over the vocabulary (no gather, whose backward adds
    through atomics on the card); the mean, or with ``mask`` the masked
    sum over ``max(sum(mask), 1)``."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), remat=remat)
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)                      # (B,S)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.where(vocab == labels[..., None], logits,
                              0.0).sum(-1)
    nll = lse - label_logit
    mask = batch.get("mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> list:
    """One empty decode state a layer, in layer order: a KV cache (in
    ``dtype``) for an attention layer, MLA's latent cache (``c``,
    ``k_rope``), fp32 zero states for an SSM layer (``mamba2_init_state`` /
    ``rglru_init_state``)."""
    dev = resolve_device(device)
    return [_layer_cache_init(cfg, cfg.layer_kinds[li], batch, max_len,
                              dtype, dev)
            for li in range(cfg.n_layers)]


@torch.inference_mode()
def prefill(params, cfg: ArchConfig, tokens=None, embeds=None,
            max_len: int | None = None):
    """Run the prompt; -> (last-position logits (B,V), decode states at len
    S, one a layer)."""
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

    token: (B,) int or embed: (B, D). Writes each attention layer's cache
    in place and replaces each SSM layer's state tuple in ``cache``;
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
