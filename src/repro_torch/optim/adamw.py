"""AdamW, clipping and schedules as plain functions on param trees, the
counterpart of ``repro.optim.adamw``.

A param tree is nested dicts, lists and tuples of tensors, or one bare
tensor (``repro_torch.tree``); the moments mirror it.  The update is the
reference's formula, not ``torch.optim.AdamW``'s: bias corrections from
the step count in float32, ``mhat / (sqrt(vhat) + eps)``, the weight
decay inside the step, ``p - lr * (update + wd * p)``, the math in the
moments' dtype promoted with float32 and the result cast back to the
weight dtype.  JAX casts a Python scalar to the dtype of the array it
meets (a weak type); PyTorch keeps it in f32 against a bf16 tensor, so
such scalars are cast first (``_weak``), and a 0-d f32 tensor, which
PyTorch would not let promote a bf16 tensor, is met with an explicit
promotion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def _weak(x: float, like: torch.Tensor):
    """A Python scalar as JAX applies it to ``like``: in ``like``'s dtype."""
    if like.dtype in (torch.float32, torch.float64):
        return x
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def adamw_init(params: Any, moment_dtype=None) -> AdamWState:
    """Zero moments shaped like ``params``; ``moment_dtype`` (e.g. f32 for
    bf16 weights) applies to the floating leaves."""

    def zeros(p):
        dt = moment_dtype if moment_dtype is not None and p.is_floating_point() else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """-> (grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm).
    Each leaf's sum of squares is the reference's ``jnp.sum``: in f32,
    returned in the leaf's dtype; the leaves' sums add in flatten order,
    starting from the first, as Python's ``sum``."""
    total = None
    for g in leaves(grads):
        sq = torch.square(g)
        part = sq.sum(dtype=torch.float32).to(sq.dtype)
        total = part if total is None else total + part
    gn = torch.sqrt(total)
    scale = torch.clamp(_weak(max_norm, gn) / (gn + _weak(1e-9, gn)), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: AdamWState,
    lr: float | torch.Tensor = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[Any, AdamWState]:
    """One step -> (new params, new state); nothing is updated in place."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.full_like(t, b1) ** t
    bc2 = 1.0 - torch.full_like(t, b2) ** t

    def upd(p, g, m, v):
        m = _weak(b1, m) * m + _weak(1 - b1, g) * g
        v = _weak(b2, v) * v + _weak(1 - b2, g) * torch.square(g)
        mhat = m.to(torch.promote_types(m.dtype, torch.float32)) / bc1
        vhat = v.to(torch.promote_types(v.dtype, torch.float32)) / bc2
        new_p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + _weak(weight_decay, p) * p)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_p, new_m, new_v = (tree_map(lambda _, o: o[k], params, out) for k in range(3))
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """``lr_at(step)``: linear warm-up to ``base_lr`` over ``warmup`` steps,
    then a cosine decay to 0 at ``total``; an f32 0-d tensor."""

    def lr_at(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr_at
