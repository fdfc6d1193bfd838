"""command-r-35b [dense] — GQA decoder, no biases.

[hf:CohereForAI/c4ai-command-r-v01]  40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000, head_dim=128.
The shapes of ``repro.configs.command_r_35b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
)
