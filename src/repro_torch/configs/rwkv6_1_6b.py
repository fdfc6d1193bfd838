"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay.

[arXiv:2404.05892]  24L d_model=2048 d_ff=7168 vocab=65536.  32 wkv heads
(head size 64).  Natively O(S): runs the long_500k shape without any
attention-window carve-out.
The shapes of ``repro.configs.rwkv6_1_6b``; no weights.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="none",
    layer_pattern="W",
    rnn_heads=32,
)
