"""Architecture registry: --arch <id> resolution, the counterpart of
``repro.configs`` and ``repro.configs.registry`` (one module here).

Only the configs the port can build are listed: the uniform dense GQA
stack.  The reference's other eight (MLA, MoE, RWKV6, RG-LRU, the
softcapped local/global and the frontend stacks) come with ROADMAP A13's
second part; ``get_config`` raises the reference's ``KeyError`` for them.
"""

from repro_torch.configs import qwen3_1_7b
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (qwen3_1_7b,)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
