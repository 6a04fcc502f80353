"""chameleon-34b — Meta Chameleon 34B [arXiv:2405.09818; unverified].

Early-fusion VLM over a unified token space (text + VQ-VAE image tokens,
vocab 65536); llama-like backbone with QK-norm. 48L, d_model 8192, 64 heads
(GQA kv=8), d_ff 22016.

Frontend stub per assignment: ``input_specs()`` provides precomputed
patch/token embeddings (B, S, d_model); the backbone is what we build. The
VQ-VAE nearest-codebook stage itself is exactly an FPPS NN search — the
kernel integration is demonstrated in repro/serve/modality.py and tests.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=65536,
    block_pattern=("attn",), ffn="swiglu",
    qk_norm=True, embed_inputs=False, q_block=1024,
    sharding_overrides=(("kv_heads", None),),
    source="arXiv:2405.09818",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b-smoke", family="vlm",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=256, vocab_size=512, block_pattern=("attn",), ffn="swiglu",
        qk_norm=True, embed_inputs=False)
