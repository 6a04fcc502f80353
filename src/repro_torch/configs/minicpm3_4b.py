"""minicpm3-4b — MiniCPM3 4B [hf:openbmb/MiniCPM3-4B].

MLA (multi-head latent attention), DeepSeek-V2 style: q_lora 768, kv_lora
256, qk_nope 64, qk_rope 32, v_head 64. 62L, d_model 2560, 40 heads,
d_ff 6400, vocab 73448.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_head=96,
    d_ff=6400, vocab_size=73448,
    block_pattern=("mla",), ffn="swiglu",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64, q_block=512,
    # 4B + 40 heads (indivisible by 16) + vocab 73448 (indivisible): DP/FSDP
    sharding_overrides=(("heads", None), ("vocab", None),
                        ("batch", ("pod", "data", "model"))),
    source="hf:openbmb/MiniCPM3-4B",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
        d_ff=192, vocab_size=512, block_pattern=("mla",), ffn="swiglu",
        q_lora_rank=48, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
