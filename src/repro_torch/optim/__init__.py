from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
]
