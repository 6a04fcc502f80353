"""deepseek-moe-16b — DeepSeekMoE 16B [arXiv:2401.06066; hf].

Fine-grained MoE: 64 routed experts (top-6, d_expert 1408) + 2 shared
experts; first layer dense (d_ff 10944). 28L, d_model 2048, 16 MHA heads
(kv=16, d_head 128), vocab 102400. Router: softmax -> top-k, no weight
renormalisation (norm_topk_prob=False).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=102400,
    block_pattern=("attn",), ffn="moe",
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    first_k_dense=1, dense_d_ff=10944, normalize_topk=False, q_block=1024,
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
        d_ff=64, vocab_size=512, block_pattern=("attn",), ffn="moe",
        n_experts=8, top_k=2, n_shared_experts=2, d_expert=64,
        first_k_dense=1, dense_d_ff=192, normalize_topk=False,
        capacity_factor=8.0)
