"""The public ``StageScorer`` protocol, the counterpart of
``repro.api.scorers`` for the ported slice.

A ``StageScorer`` is a plan-independent template: it holds ensemble params
in ORIGINAL order, and ``bind(dplan, device)`` applies the plan's cascade
order and lowers it onto the device as the executors' ``BoundScorer``.
The neural and function scorers of the reference are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    BoundScorer,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)

__all__ = ["StageScorer", "MatrixScorer", "TreeScorer", "LatticeScorer"]


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class StageScorer(abc.ABC):
    """A plan-independent stage-scorer template."""

    #: registry name of the scorer family ("matrix"/"tree"/"lattice")
    name: str = "?"

    @abc.abstractmethod
    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        """Lower onto ``dplan`` and ``device`` -> the executors' ``BoundScorer``."""


@dataclasses.dataclass(frozen=True)
class MatrixScorer(StageScorer):
    """Scorer over a precomputed (N, T) score matrix in ORIGINAL ensemble
    order — ``prepare`` applies the plan's cascade order itself."""

    quant: str | None = None
    name: str = dataclasses.field(default="matrix", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        base = matrix_stage_scorer(dplan, quant=self.quant, device=device)
        order = np.asarray(dplan.plan.order)

        def prepare(original):
            F = _numpy(original)
            if F.ndim != 2 or F.shape[1] != order.shape[0]:
                raise ValueError(
                    f"MatrixScorer expects an (N, {order.shape[0]}) "
                    f"original-order score matrix, got {F.shape}"
                )
            return base.prepare(F[:, order])

        return dataclasses.replace(base, prepare=prepare)


@dataclasses.dataclass(frozen=True)
class TreeScorer(StageScorer):
    """Oblivious-forest scorer over stacked per-tree params in ORIGINAL
    ensemble order ((T, depth) feats/thrs, (T, 2**depth) leaves; numpy
    arrays or tensors)."""

    feats: object
    thrs: object
    leaves: object
    block_n: int = DEFAULT_BLOCK_N
    quant: str | None = None
    name: str = dataclasses.field(default="tree", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        order = np.asarray(dplan.plan.order)
        return tree_stage_scorer(
            dplan,
            _numpy(self.feats)[order],
            _numpy(self.thrs)[order],
            _numpy(self.leaves)[order],
            block_n=self.block_n,
            quant=self.quant,
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class LatticeScorer(StageScorer):
    """Lattice scorer over (T, 2**S) theta / (T, S) feats stacks in
    ORIGINAL ensemble order (numpy arrays or tensors)."""

    theta: object
    feats: object
    block_n: int = DEFAULT_BLOCK_N
    quant: str | None = None
    name: str = dataclasses.field(default="lattice", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        order = np.asarray(dplan.plan.order)
        return lattice_stage_scorer(
            dplan,
            _numpy(self.theta)[order],
            _numpy(self.feats)[order],
            block_n=self.block_n,
            quant=self.quant,
            device=device,
        )
