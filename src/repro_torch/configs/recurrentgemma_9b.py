"""recurrentgemma-9b — Griffin architecture [arXiv:2402.19427; unverified].

Hybrid: repeating (RG-LRU, RG-LRU, local attention) — the paper's 1 attn :
2 recurrent ratio. 38L, d_model 4096, 16 heads MQA (kv=1, d_head 256),
GeGLU d_ff 12288, vocab 256000, window 2048, logit soft cap 30.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"), ffn="geglu",
    window=2048, lru_width=4096, conv_width=4, q_block=1024,
    tie_embeddings=True, logit_soft_cap=30.0,
    sharding_overrides=(("kv_heads", None),),  # MQA
    source="arXiv:2402.19427",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        n_layers=5, d_model=96, n_heads=4, n_kv_heads=1, d_head=24,
        d_ff=192, vocab_size=512,
        block_pattern=("rglru", "rglru", "local_attn"), ffn="geglu",
        window=16, lru_width=96, conv_width=4,
        tie_embeddings=True, logit_soft_cap=30.0)
