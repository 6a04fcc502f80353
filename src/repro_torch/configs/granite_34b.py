"""granite-34b — IBM Granite Code 34B [arXiv:2405.04324; hf].

GPTBigCode-family code model; MQA (kv=1), non-gated (2-matrix) GELU MLP.
88L, d_model 6144, 48 heads, d_ff 24576, vocab 49152. Deviation noted in
DESIGN.md: learned positions -> RoPE (uniform backbone; dims unchanged).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab_size=49152,
    block_pattern=("attn",), ffn="gelu",
    rope_theta=10000.0, q_block=1024,
    sharding_overrides=(("kv_heads", None),),  # MQA: replicate the single KV head
    source="arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-34b-smoke", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=1, d_head=32,
        d_ff=256, vocab_size=512, block_pattern=("attn",), ffn="gelu")
