"""recurrentgemma-2b [hybrid] — RG-LRU blocks + local attention, 2:1.

[arXiv:2402.19427 Griffin]  26L d_model=2560 10H (GQA kv=1, head_dim 256)
d_ff=7680 vocab=256000, pattern (R, R, L) with 2048-token local window.
Natively sub-quadratic: runs long_500k with its own mechanism.
The shapes of ``repro.configs.recurrentgemma_2b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern="RRL",
    sliding_window=2048,
    mlp_kind="gelu",
)
