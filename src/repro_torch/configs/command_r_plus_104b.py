"""command-r-plus-104b [dense] — large GQA decoder, no biases.

[hf:CohereForAI/c4ai-command-r-v01 family]  64L d_model=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000, head_dim=128, tied embeddings.
The shapes of ``repro.configs.command_r_plus_104b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
)
