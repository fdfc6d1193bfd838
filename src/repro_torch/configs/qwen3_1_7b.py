"""qwen3-1.7b [dense] — GQA with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B family]  28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, head_dim=128, qk_norm.  The shapes of
``repro.configs.qwen3_1_7b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
)
