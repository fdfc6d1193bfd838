"""gemma2-2b [dense] — alternating local(4096)/global attention, softcaps.

[arXiv:2408.00118]  26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
head_dim=256, attention-logit softcap 50, final-logit softcap 30.
The shapes of ``repro.configs.gemma2_2b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern="LG",  # local first, alternating
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_kind="gelu",
)
