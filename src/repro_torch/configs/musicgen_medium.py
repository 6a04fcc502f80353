"""musicgen-medium — MusicGen 1.5B [arXiv:2306.05284; hf].

Decoder-only transformer over EnCodec residual-VQ tokens (4 codebooks,
2048 entries each -> vocab 2048 per head; assignment specifies the single
2048-vocab backbone head). 48L, d_model 1536, 24 MHA heads (kv=24),
GELU d_ff 6144.

Frontend stub per assignment: ``input_specs()`` provides precomputed frame
embeddings (the EnCodec + codebook-sum stage). The EnCodec RVQ
nearest-codebook search is an FPPS NN search — see repro/serve/modality.py.
Deviation noted: original uses learned sinusoidal positions; we use RoPE
(uniform backbone); dims/FLOPs unchanged.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_head=64,
    d_ff=6144, vocab_size=2048,
    block_pattern=("attn",), ffn="gelu",
    embed_inputs=False, q_block=512,
    # 1.5B, 24 heads indivisible by 16: DP-dominant
    sharding_overrides=(("heads", None), ("kv_heads", None),
                        ("batch", ("pod", "data", "model"))),
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium-smoke", family="audio",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=6, d_head=16,
        d_ff=192, vocab_size=256, block_pattern=("attn",), ffn="gelu",
        embed_inputs=False)
