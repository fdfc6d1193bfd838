"""The public ``StageScorer`` protocol, the counterpart of
``repro.api.scorers`` for the ported slice.

A ``StageScorer`` is a plan-independent template: it holds ensemble params
in ORIGINAL order, and ``bind(dplan, device)`` applies the plan's cascade
order and lowers it onto the device as the executors' ``BoundScorer``.
The port's ``bind`` takes the torch device explicitly (the reference's
binds onto JAX's default device).  Scorer families live in a registry
(``register_scorer`` / ``get_scorer`` / ``scorer_names``), and
``host_producer`` drives a bound scorer as the host ``ChunkedExecutor``'s
producer.  The port's scorers are stateless; the reference's neural
scorer and its state carry come with ROADMAP A13.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    BoundScorer,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.kernels.ops import _bucket_rows

__all__ = [
    "StageScorer",
    "MatrixScorer",
    "TreeScorer",
    "LatticeScorer",
    "FunctionScorer",
    "register_scorer",
    "get_scorer",
    "scorer_names",
    "host_producer",
]


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class StageScorer(abc.ABC):
    """A plan-independent stage-scorer template."""

    #: registry name of the scorer family ("matrix"/"tree"/"lattice"/...)
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


@dataclasses.dataclass(frozen=True)
class FunctionScorer(StageScorer):
    """Escape hatch: wrap a ``factory(dplan, device) -> BoundScorer``
    closure.

    For custom scorers that build their own kernel-layer ``BoundScorer``
    (tests, benchmarks, one-off experiments) without defining a full
    ``StageScorer`` subclass.  ``bind(dplan, device)`` calls
    ``factory(dplan, device)``: the port passes the torch device the
    executor runs on, where the reference's ``factory(dplan)`` takes
    JAX's default device.  Lanes and slabs are whatever the closure put
    on the scorer.
    """

    factory: object
    name: str = dataclasses.field(default="function", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        return self.factory(dplan, device)


# -- registry ----------------------------------------------------------------

_SCORERS: dict[str, type] = {
    "matrix": MatrixScorer,
    "tree": TreeScorer,
    "lattice": LatticeScorer,
    "function": FunctionScorer,
}


def register_scorer(name: str, cls: type) -> None:
    """Register a ``StageScorer`` subclass under ``name``."""
    if not (isinstance(cls, type) and issubclass(cls, StageScorer)):
        raise TypeError(f"{cls!r} is not a StageScorer subclass")
    _SCORERS[str(name)] = cls


def get_scorer(name: str) -> type:
    try:
        return _SCORERS[name]
    except KeyError:
        raise KeyError(f"unknown scorer {name!r}; registered: {sorted(_SCORERS)}") from None


def scorer_names() -> tuple[str, ...]:
    return tuple(sorted(_SCORERS))


# -- host adapter: StageScorer -> ChunkedExecutor producer --------------------


def _as_device_plan(plan) -> DevicePlan:
    if isinstance(plan, DevicePlan):
        return plan
    if isinstance(plan, CascadePlan):
        return DevicePlan.from_plan(plan)
    raise TypeError(f"expected CascadePlan or DevicePlan, got {type(plan).__name__}")


def host_producer(scorer, plan, batch, device="cuda"):
    """Adapt a ``StageScorer`` (bound onto ``device``) or an already-bound
    ``BoundScorer`` to the host ``ChunkedExecutor`` producer contract ->
    ``(producer, n)``.

    The producer drives the bound scorer's ``fn`` over the requested rows
    on the scorer's device (where its ``prepare`` put the operand): each
    call is W wide (the scorer's uniform stage width), its rows padded to
    the scorer's ``block_n`` as ``ops._bucket_rows`` pads them, and the
    result is sliced back to the rows and to ``t1 - t0`` columns, as f64
    numpy.
    """
    dplan = _as_device_plan(plan)
    bound = scorer.bind(dplan, device=device) if isinstance(scorer, StageScorer) else scorer
    if not isinstance(bound, BoundScorer):
        raise TypeError(f"expected a StageScorer or BoundScorer, got {type(scorer).__name__}")
    x = bound.prepare(batch)
    n = int(x.shape[0])

    def producer(rows, t0, t1):
        m = len(rows)
        if m == 0:
            return np.zeros((0, t1 - t0), dtype=np.float64)
        # the kernel-backed scorers compute at their own block_n granularity
        rows_t, _ = _bucket_rows(
            torch.as_tensor(np.asarray(rows, dtype=np.int64), device=x.device),
            bound.block_n or 1,
        )
        scores = bound.fn(x, rows_t, int(t0), m)
        return _numpy(scores)[:m, : t1 - t0].astype(np.float64)

    return producer, n
