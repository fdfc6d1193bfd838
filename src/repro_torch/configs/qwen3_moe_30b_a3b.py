"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk-norm GQA.

[hf:Qwen/Qwen3-30B-A3B]  48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, head_dim=128, no shared experts, all layers MoE.
The shapes of ``repro.configs.qwen3_moe_30b_a3b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
)
