"""Plain-tensor oracles, the counterparts of ``repro.kernels.ref``.

Each function states the semantics of a kernel in plain PyTorch on any
device; the tests hold the kernels' plain versions against these and
against the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.ensembles.lattice import apply_lattice_scores

__all__ = ["cascade_ref", "lattice_scores_ref", "gbt_scores_ref"]


def cascade_ref(
    scores_ordered: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Early-exit cascade over an ordered score matrix.

    Returns (decisions int32 {0,1}, exit_step int32 1-based; T if no early
    exit).  Negative exit has priority at a step.
    """
    n, T = scores_ordered.shape
    g = torch.cumsum(scores_ordered, dim=1)
    hit_pos = g > eps_pos[None, :]
    hit_neg = g < eps_neg[None, :]
    hit = hit_pos | hit_neg
    any_hit = hit.any(dim=1)
    first = torch.where(any_hit, torch.argmax(hit.to(torch.int8), dim=1), T - 1)
    exit_step = torch.where(any_hit, first + 1, T).to(torch.int32)
    rows = torch.arange(n, device=scores_ordered.device)
    early_pos = hit_pos[rows, first] & ~hit_neg[rows, first]
    full_pos = g[:, -1] >= beta
    decisions = torch.where(any_hit, early_pos, full_pos)
    return decisions.to(torch.int32), exit_step


def lattice_scores_ref(
    theta: torch.Tensor, feats: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Multilinear lattice interpolation, (N, T) scores.

    theta: (T, 2**S); feats: (T, S) int32; x: (N, D) in [0, 1].  Contracted
    dimension by dimension, feature 0 (the MSB of the vertex index) first.
    """
    return apply_lattice_scores({"feats": feats, "theta": theta}, x)


def gbt_scores_ref(
    feats: torch.Tensor, thrs: torch.Tensor, leaves: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Oblivious-forest evaluation, (N, T) per-tree scores.

    feats/thrs: (T, depth); leaves: (T, 2**depth); x: (N, D).
    MSB-first bit order: idx = ((idx * 2) + bit_level) over levels.
    """
    return apply_gbt_scores({"feats": feats, "thrs": thrs, "leaves": leaves}, x)
