"""deepseek-v2-lite-16b [moe] — MLA + 2 shared / 64 routed top-6 experts.

[arXiv:2405.04434]  27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
MLA kv_lora_rank=512, decoupled rope dim 64.  64 routed + 2 shared
experts, top-6, as the V2-Lite model card (160 routed is full V2); see
DESIGN.md §Config discrepancy.
Layer 0 keeps a dense FFN (first_dense_layers=1), per the model card.
The shapes of ``repro.configs.deepseek_v2_lite_16b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # the expert hidden size; also the dense layer-0 FFN
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
)
