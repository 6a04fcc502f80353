"""mamba2-780m — Mamba-2 SSD [arXiv:2405.21060; unverified].

Attention-free SSM: 48 SSD layers, d_model 1536 (d_inner 3072, headdim 64
-> 48 ssm heads), d_state 128, chunk 256, conv 4, vocab 50280, tied
embeddings. No FFN (the Mamba block is the whole layer).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssd",), ffn="swiglu",  # ffn unused: ssd layers have none
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, conv_width=4,
    tie_embeddings=True,
    # 780M: DP-only; the fused in_proj concat dim must stay unsharded
    sharding_overrides=(("mlp", None), ("vocab", "model"),
                        ("batch", ("pod", "data", "model"))),
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=4, d_model=96, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=512, block_pattern=("ssd",), ffn="swiglu",
        ssm_state=16, ssm_expand=2, ssm_headdim=24, ssm_chunk=16,
        conv_width=4, tie_embeddings=True)
