"""Model substrate, the counterpart of ``repro.models``: the decoder over
every model family (``transformer``), its blocks (``layers``, ``mla``,
``moe``, ``rwkv6``, ``rglru``), in the cache-less (prefill) form."""

from repro_torch.models.config import ModelConfig, active_param_count, param_count
from repro_torch.models.transformer import forward, init_params

__all__ = ["ModelConfig", "active_param_count", "forward", "init_params", "param_count"]
