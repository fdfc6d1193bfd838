"""Runtime cascade evaluation as a masked walk over the ordered base models,
the counterpart of ``repro.core.cascade``.

The paper's serving loop is a per-example data-dependent ``while``: evaluate
base models in QWYC order, stop as soon as the partial score crosses a
threshold.  Here every example walks all T ordered models with an ``active``
mask, one ``threshold_step`` (``kernels/cascade_kernel.py``, the single
source of the step semantics) per model.  Exit step and decision equal the
sequential loop's; the cost model (#models evaluated = the exit step)
matches the paper's accounting.  The hand-written kernels skip the work
itself: B1 for a precomputed matrix, the stage loop of
``kernels/device_executor.py`` for lazily scored stages.

Two entry points:
  * ``cascade_from_scores`` — scores precomputed (N, T): pure threshold logic.
  * ``cascade_apply``       — base models evaluated inside the walk through a
    stacked-parameter ``apply_fn`` (every row scores every model; the mask
    gates the accounting).

Both run on ``device`` (the card by default, an error without one); the
walk is a Python loop over T that enqueues a few tensor ops a model.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cascade_kernel import threshold_step

__all__ = ["CascadeOut", "cascade_from_scores", "cascade_apply", "pack_model"]


class CascadeOut(NamedTuple):
    decisions: torch.Tensor  # (N,) bool
    exit_step: torch.Tensor  # (N,) int32, 1-based; T if never exited early
    models_evaluated: torch.Tensor  # (N,) int32 == exit_step (cost accounting)
    g_final: torch.Tensor  # (N,) partial score at exit (full score if no exit)


def _walk(n, T, dtype, dev, column, eps_pos, eps_neg, beta) -> CascadeOut:
    """The masked walk: ``column(t)`` gives the (N,) scores of ordered
    model t.  The thresholds and ``beta`` compare in ``dtype``, as the
    reference casts them."""
    ep = torch.as_tensor(eps_pos, device=dev).to(dtype)
    en = torch.as_tensor(eps_neg, device=dev).to(dtype)
    g = torch.zeros(n, dtype=dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    dec = torch.zeros(n, dtype=torch.bool, device=dev)
    ex = torch.full((n,), T, dtype=torch.int32, device=dev)
    for t in range(T):
        g, active, dec, ex = threshold_step(
            g, active, dec, ex, column(t), ep[t], en[t], t + 1
        )
    beta_t = torch.as_tensor(beta, device=dev).to(dtype)
    decisions = torch.where(active, g >= beta_t, dec)
    return CascadeOut(decisions, ex, ex, g)


def cascade_from_scores(
    scores_ordered,
    eps_pos,
    eps_neg,
    beta,
    device="cuda",
) -> CascadeOut:
    """Threshold cascade over a precomputed, already-ordered score matrix.

    Args:
      scores_ordered: (N, T), column r = f_{pi(r)}(x_i); a tensor or an
        array, moved to ``device``.  The walk runs in float32 (an integer
        or float64 input is cast, as the reference runs without x64), or
        in a narrower float dtype given.
      eps_pos / eps_neg: (T,), cast to the scores' dtype.
      beta: full-ensemble decision threshold.
    """
    dev = resolve_device(device)
    F = torch.as_tensor(scores_ordered, device=dev)
    if not F.is_floating_point() or F.dtype == torch.float64:
        F = F.to(torch.float32)
    n, T = F.shape
    return _walk(n, T, F.dtype, dev, lambda t: F[:, t], eps_pos, eps_neg, beta)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cascade_apply(
    stacked_params: Any,
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    x,
    eps_pos,
    eps_neg,
    beta,
    device="cuda",
) -> CascadeOut:
    """Cascade where base models are evaluated inside the walk.

    Args:
      stacked_params: a dict / list / tuple tree of tensors with a leading
        T axis, already in QWYC order (see ``pack_model``), on ``device``.
      apply_fn: (params_t, x) -> (N,) scores of one base model; each
        model's scores are taken as float32 (the reference's dtype).
      x: (N, D) examples, moved to ``device``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    n = x.shape[0]
    T = int(np.shape(eps_pos)[0])

    def column(t):
        params_t = _tree_map(lambda p: p[t], stacked_params)
        return apply_fn(params_t, x).to(torch.float32)

    return _walk(n, T, torch.float32, dev, column, eps_pos, eps_neg, beta)


def pack_model(stacked_params: Any, order) -> Any:
    """Reorder a stacked-parameter tree's leading axis by the QWYC order
    (each leaf a tensor, or an array made one, indexed on its device)."""

    def take(p):
        p = torch.as_tensor(p)
        return p[torch.as_tensor(np.asarray(order), dtype=torch.int64, device=p.device)]

    return _tree_map(take, stacked_params)
