"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284]  48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 (one EnCodec codebook; the 4-codebook delay-pattern interleave
is handled by the data pipeline).  The EnCodec conv encoder and the T5
text-conditioning tower are stubs: the caller supplies
64 precomputed conditioning embeddings.
The shapes of ``repro.configs.musicgen_large``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_kind="gelu",
    frontend="audio",
    n_frontend_tokens=64,
)
