"""llama3-405b — Llama 3.1 405B [arXiv:2407.21783; unverified].

126L, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab_size=128256,
    block_pattern=("attn",), ffn="swiglu",
    rope_theta=500000.0, q_block=1024,
    sharding_overrides=(("kv_heads", None),),  # 8 kv heads < TP=16: replicate
    source="arXiv:2407.21783",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=320, vocab_size=512, block_pattern=("attn",), ffn="swiglu",
        rope_theta=500000.0, q_block=32)
