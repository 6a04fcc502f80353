"""Architecture config schema + input-shape registry (a copy of the JAX
package's ``configs/base.py``: plain Python, no JAX, kept here so the port
imports nothing of the reference).

Every assigned architecture is an ``ArchConfig`` instance in its own module
(``repro_torch.configs.<id>``), with the exact published dimensions, plus a
``smoke()`` reduced config of the same family for CPU tests. The four
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k) are
global and combined with archs by the registry/dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|vlm|hybrid|ssm|moe|audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    # block layout: tiled over layers; entries: attn|local_attn|mla|rglru|ssd
    block_pattern: Tuple[str, ...] = ("attn",)
    # ffn per block kind: swiglu|gelu|moe|none
    ffn: str = "swiglu"
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0                  # local_attn window
    q_block: int = 0                 # query-blocked attention (0 = full)
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # ssm (mamba2 / rg-lru)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    lru_width: int = 0
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_k_dense: int = 0           # leading layers use a dense FFN
    dense_d_ff: int = 0              # width of those dense FFN layers
    normalize_topk: bool = False
    capacity_factor: float = 1.25
    # embeddings / head
    tie_embeddings: bool = False
    embed_inputs: bool = True        # False: frontend stub feeds embeddings
    kv_quant: bool = False           # int8 KV cache (serving memory, §Beyond)
    logit_soft_cap: float = 0.0
    rms_eps: float = 1e-5
    # per-arch logical-rule overrides, e.g. small models go DP-only:
    # (("heads", None), ("batch", ("pod","data","model")), ...).
    # Stored as a tuple-of-pairs to keep the config hashable.
    sharding_overrides: tuple = ()
    # notes for DESIGN/EXPERIMENTS (provenance, deviations)
    source: str = ""

    @property
    def sharding_override_rules(self) -> dict:
        return dict(self.sharding_overrides)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is O(1)/O(window): long_500k is runnable."""
        return all(k in ("rglru", "ssd", "local_attn")
                   for k in self.block_pattern)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    def active_params(self) -> int:
        """Approximate active (per-token) parameter count (MoE-aware)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)


def _param_count(c: ArchConfig, active_only: bool) -> int:
    total = 0
    if c.embed_inputs:
        total += c.vocab_size * c.d_model
    if not c.tie_embeddings:
        total += c.vocab_size * c.d_model
    for kind in c.layer_kinds:
        total += 2 * c.d_model  # norms
        if kind in ("attn", "local_attn"):
            total += c.d_model * c.d_head * (c.n_heads + 2 * c.n_kv_heads)
            total += c.n_heads * c.d_head * c.d_model
        elif kind == "mla":
            dqk = c.qk_nope_head_dim + c.qk_rope_head_dim
            total += c.d_model * c.q_lora_rank
            total += c.q_lora_rank * c.n_heads * dqk
            total += c.d_model * (c.kv_lora_rank + c.qk_rope_head_dim)
            total += c.kv_lora_rank * c.n_heads * (c.qk_nope_head_dim
                                                   + c.v_head_dim)
            total += c.n_heads * c.v_head_dim * c.d_model
        elif kind == "ssd":
            d_in = c.ssm_expand * c.d_model
            nh = d_in // c.ssm_headdim
            total += c.d_model * (2 * d_in + 2 * c.ssm_state + nh)
            total += d_in * c.d_model
        elif kind == "rglru":
            w = c.lru_width or c.d_model
            total += 2 * c.d_model * w + 2 * w * w + w * c.d_model
    # FFN
    for li, kind in enumerate(c.layer_kinds):
        if kind == "ssd":
            continue  # mamba2 blocks have no separate FFN
        if c.ffn == "moe" and li >= c.first_k_dense:
            e_active = c.top_k if active_only else c.n_experts
            total += 3 * c.d_model * c.d_expert * e_active
            total += 3 * c.d_model * c.d_expert * c.n_shared_experts
            total += c.d_model * c.n_experts  # router
        else:
            width = (c.dense_d_ff if (c.ffn == "moe" and li < c.first_k_dense)
                     else c.d_ff)
            mult = 3 if c.ffn in ("swiglu", "moe") else 2
            total += mult * c.d_model * width
    return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
