"""Architecture registry: --arch <id> resolution, the counterpart of
``repro.configs`` and ``repro.configs.registry`` (one module here).

The reference's ten configs, in its order: shapes only, no weights.
"""

from repro_torch.configs import (
    command_r_35b,
    command_r_plus_104b,
    deepseek_v2_lite_16b,
    gemma2_2b,
    internvl2_26b,
    musicgen_large,
    qwen3_1_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_2b,
    rwkv6_1_6b,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        deepseek_v2_lite_16b,
        gemma2_2b,
        qwen3_1_7b,
        rwkv6_1_6b,
        command_r_plus_104b,
        internvl2_26b,
        qwen3_moe_30b_a3b,
        command_r_35b,
        recurrentgemma_2b,
        musicgen_large,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
