"""AdamW as plain functions on tensors, the counterpart of
``repro.optim.adamw`` (``adamw_init``, ``adamw_update``).

The update is the reference's formula, not ``torch.optim.AdamW``'s: bias
corrections from the step count as float32, ``mhat / (sqrt(vhat) + eps)``,
and the weight decay inside the step, ``p - lr * (update + wd * p)``.  The
schedules and clipping of the reference module are not ported yet: the
lattice trainer, the one caller so far, uses neither.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: torch.Tensor
    nu: torch.Tensor


def adamw_init(params: torch.Tensor) -> AdamWState:
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=params.device),
        mu=torch.zeros_like(params),
        nu=torch.zeros_like(params),
    )


@torch.no_grad()
def adamw_update(
    params: torch.Tensor,
    grads: torch.Tensor,
    state: AdamWState,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[torch.Tensor, AdamWState]:
    """One step -> (new params, new state); nothing is updated in place."""
    step = state.step + 1
    t = step.to(params.dtype)
    bc1 = 1.0 - torch.full_like(t, b1) ** t
    bc2 = 1.0 - torch.full_like(t, b2) ** t
    m = b1 * state.mu + (1 - b1) * grads
    v = b2 * state.nu + (1 - b2) * torch.square(grads)
    mhat = m / bc1
    vhat = v / bc2
    new_p = params - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * params)
    return new_p, AdamWState(step=step, mu=m, nu=v)
