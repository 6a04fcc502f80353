"""qwen2-0.5b — Qwen2 0.5B [arXiv:2407.10671; hf].

24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936; QKV bias;
tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151936,
    block_pattern=("attn",), ffn="swiglu",
    qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0, q_block=512,
    # 0.5B: DP-only over the whole mesh (14 heads indivisible by TP=16)
    sharding_overrides=(("heads", None), ("kv_heads", None), ("mlp", None),
                        ("vocab", "model"),
                        ("batch", ("pod", "data", "model"))),
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=256, vocab_size=512, block_pattern=("attn",), ffn="swiglu",
        qkv_bias=True, tie_embeddings=True)
