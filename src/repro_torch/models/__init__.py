"""Model substrate, the counterpart of ``repro.models``: the decoder over
every model family (``transformer``), its blocks (``layers``, ``mla``,
``moe``, ``rwkv6``, ``rglru``) with their decode caches, and the train,
prefill and decode steps (``steps``)."""

from repro_torch.models.config import ModelConfig, active_param_count, param_count
from repro_torch.models.steps import (
    init_train_state,
    loss_fn,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.transformer import forward, init_cache, init_params

__all__ = [
    "ModelConfig",
    "active_param_count",
    "forward",
    "init_cache",
    "init_params",
    "init_train_state",
    "loss_fn",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "param_count",
]
