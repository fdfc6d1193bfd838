"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B decoder.

[arXiv:2404.16821]  Language backbone: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553 (padded to 92560 = 16*5785 so the vocab dim shards
evenly on the 16-way model axis; the 7 pad rows are dead).  The vision
tower + MLP projector are stubs: the caller supplies 256
precomputed patch embeddings per image.
The shapes of ``repro.configs.internvl2_26b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92560,  # 92553 padded to a shardable multiple of 16
    frontend="vision",
    n_frontend_tokens=256,
)
