"""qwen3-moe-235b-a22b — Qwen3 MoE [hf:Qwen/Qwen3-30B-A3B scaled family].

128 routed experts, top-8, d_expert 1536, no shared experts, renormalised
top-k. 94L, d_model 4096, 64 heads (GQA kv=4, d_head 128), QK-norm,
vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936,
    block_pattern=("attn",), ffn="moe",
    n_experts=128, top_k=8, n_shared_experts=0, d_expert=1536,
    normalize_topk=True, qk_norm=True, rope_theta=1000000.0, q_block=1024,
    sharding_overrides=(("kv_heads", None),),  # 4 kv heads < TP=16
    source="hf:Qwen/Qwen3-235B-A22B",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=2, d_head=24,
        d_ff=64, vocab_size=512, block_pattern=("attn",), ffn="moe",
        n_experts=8, top_k=2, n_shared_experts=0, d_expert=48,
        normalize_topk=True, qk_norm=True, capacity_factor=8.0)
