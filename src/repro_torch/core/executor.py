"""Chunked lazy-evaluation cascade executor — the single execution
abstraction behind ``core``, ``kernels`` and ``serving``.

The paper's win is that early-exited examples *skip evaluating the remaining
base models*.  The historical serving path materialized the full (N, T)
score matrix up front, so the cascade only saved threshold arithmetic on
scores already paid for.  This module makes the skip real: the QWYC order +
thresholds are split into ``chunk_t``-sized **stages** (a ``CascadePlan``),
and between stages the ``ChunkedExecutor``

  1. asks a *score producer* for scores of **only the surviving rows** and
     **only the next stage's models**,
  2. runs the threshold tests for the stage (reference numpy decide, or the
     CUDA chunk-decide kernel supplied via ``decide_fn`` — see
     ``repro_torch.kernels.ops.kernel_decide_fn``),
  3. compacts the active set with a stable gather (``nonzero`` + ``take``).

The host stage loop is numpy in both packages; this module is a copy of
``repro.core.executor`` so that the port's host backend and oracles need
nothing from the JAX package.

This is the query-level interleaved scoring/exit-testing execution model of
sentinel-chunked additive-ensemble traversal (Lucchese et al. 2020; Busolin
et al. 2021 — PAPERS.md), applied to QWYC cascades.

Semantics are bit-identical to ``core.qwyc.evaluate_cascade`` (same
sequential partial-sum accumulation, same negative-exit priority); the
parity tests in ``tests/test_executor.py`` assert this for every serving
backend and both modes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.qwyc import QWYCModel

__all__ = [
    "CascadePlan",
    "ChunkStat",
    "ExecutorResult",
    "ChunkedExecutor",
    "decide_chunk_reference",
    "matrix_producer",
]

# producer(rows, t0, t1) -> (len(rows), t1 - t0) scores of cascade-ORDERED
# models [t0, t1) evaluated on the given (absolute) batch row indices.
ScoreProducer = Callable[[np.ndarray, int, int], np.ndarray]

# decide_fn(g0, chunk, eps_pos, eps_neg, t0) ->
#   (g, active, decided_pos, exit_step_abs); see decide_chunk_reference.
DecideFn = Callable[..., tuple]

DEFAULT_CHUNK_T = 8


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """A fitted QWYC cascade split into chunk-sized execution stages.

    All arrays are in cascade (QWYC-ordered) position space: entry r
    describes the r-th model evaluated, and ``order[r]`` maps it back to
    the original ensemble index for the score producer.
    """

    order: np.ndarray  # (T,) original index of the r-th cascade position
    eps_pos: np.ndarray  # (T,) early-positive thresholds
    eps_neg: np.ndarray  # (T,) early-negative thresholds
    beta: float
    costs: np.ndarray  # (T,) cost of the r-th cascade position
    chunk_t: int = DEFAULT_CHUNK_T
    mode: str = "both"
    # width of an optional leading stage before the chunk_t grid starts.
    # The sorted-kernel backend sets lead_t=1: the first model's scores are
    # needed for the sort key anyway, so they form their own stage and are
    # computed exactly once (and step-1 exits retire after 1 model, not
    # chunk_t).
    lead_t: int = 0

    @property
    def T(self) -> int:
        return int(self.order.shape[0])

    @property
    def stages(self) -> tuple[tuple[int, int], ...]:
        ct = max(1, int(self.chunk_t))
        lead = min(max(0, int(self.lead_t)), self.T)
        out = [(0, lead)] if lead else []
        out += [(t0, min(t0 + ct, self.T)) for t0 in range(lead, self.T, ct)]
        return tuple(out)

    def cum_costs(self) -> np.ndarray:
        return np.cumsum(self.costs)

    @classmethod
    def from_qwyc(cls, model: QWYCModel, chunk_t: int = DEFAULT_CHUNK_T) -> "CascadePlan":
        return cls(
            order=np.asarray(model.order),
            eps_pos=np.asarray(model.eps_pos, dtype=np.float64),
            eps_neg=np.asarray(model.eps_neg, dtype=np.float64),
            beta=float(model.beta),
            costs=np.asarray(model.ordered_costs(), dtype=np.float64),
            chunk_t=int(chunk_t),
            mode=model.mode,
        )


@dataclasses.dataclass
class ChunkStat:
    """Per-stage accounting: what the lazy path actually paid."""

    t0: int
    t1: int
    n_in: int  # survivors entering the stage
    n_exited: int  # rows retired during the stage
    scores_computed: int  # billed rows (n_in rounded up to bill_block) * width


@dataclasses.dataclass
class ExecutorResult:
    decisions: np.ndarray  # (N,) bool
    exit_step: np.ndarray  # (N,) int64, 1-based; T if never exited early
    g_final: np.ndarray  # (N,) partial score at exit (full score if none)
    chunk_stats: list[ChunkStat]
    scores_computed: int  # producer scores actually requested
    scores_possible: int  # N * T — what the eager full-matrix path pays

    @property
    def mean_models(self) -> float:
        return float(self.exit_step.mean())

    @property
    def survivors_per_chunk(self) -> list[int]:
        return [s.n_in for s in self.chunk_stats]

    def mean_cost(self, plan: CascadePlan) -> float:
        return float(plan.cum_costs()[self.exit_step - 1].mean())


def decide_chunk_reference(
    g0: np.ndarray,
    chunk: np.ndarray,
    eps_pos: np.ndarray,
    eps_neg: np.ndarray,
    t0: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One stage of threshold tests, numpy, sequential accumulation.

    Accumulation order matches ``np.cumsum`` over the full row (and the
    CUDA kernels' ``g += f_t``), so partial sums — and therefore exits —
    are bit-identical to ``evaluate_cascade`` at the same dtype.

    Args:
      g0: (m,) carried partial scores of the surviving rows.
      chunk: (m, ct) scores for cascade positions [t0, t0 + ct).
      eps_pos / eps_neg: (ct,) thresholds for those positions.
      t0: absolute cascade position of the chunk's first column.

    Returns (g, active, decided_pos, exit_step_abs), each (m,):
      g: partial score after the stage (frozen at exit for exited rows).
      active: rows still alive after the stage.
      decided_pos: True where the row exited positively.
      exit_step_abs: 1-based absolute exit step (0 where still active).
    """
    m, ct = chunk.shape
    # step semantics mirrored by kernels/cascade_kernel.threshold_step and
    # csrc/threshold_step.cuh — keep the three in sync
    g = np.array(g0, copy=True)
    active = np.ones(m, dtype=bool)
    decided_pos = np.zeros(m, dtype=bool)
    exit_step = np.zeros(m, dtype=np.int64)
    for j in range(ct):
        g = np.where(active, g + chunk[:, j], g)
        out_neg = active & (g < eps_neg[j])  # negative exit priority
        out_pos = active & (g > eps_pos[j]) & ~out_neg
        newly = out_neg | out_pos
        decided_pos = decided_pos | out_pos
        exit_step = np.where(newly, t0 + j + 1, exit_step)
        active = active & ~newly
    return g, active, decided_pos, exit_step


class ChunkedExecutor:
    """Runs a ``CascadePlan`` against a lazy score producer.

    The executor owns the control flow (stage loop, exit bookkeeping,
    active-set compaction); *what* produces scores and *how* a stage's
    thresholds are tested are injected, so the serving backends differ only
    in batching/sorting policy and decide implementation:

      * ``decide_fn=None`` -> ``decide_chunk_reference`` (numpy oracle).
      * ``decide_fn=repro_torch.kernels.ops.kernel_decide_fn(...)`` -> the
        CUDA chunk-decide kernel (or its plain version on a CPU device).
    """

    def __init__(
        self,
        plan: CascadePlan,
        producer: ScoreProducer,
        decide_fn: DecideFn | None = None,
        bill_block: int = 1,
    ):
        """``bill_block``: the producer's row-quantization granularity.  A
        blocked kernel producer pads survivors up to a block multiple, so
        the work it really performs is ceil(m / block) * block rows per
        stage; billing at that granularity keeps ``scores_computed`` an
        honest measure of actual compute, not of rows requested.  Leave at
        1 for exact producers (precomputed matrices, plain vectorized
        math)."""
        self.plan = plan
        self.producer = producer
        self.decide_fn = decide_fn or decide_chunk_reference
        self.bill_block = max(1, int(bill_block))

    def _billed_rows(self, m: int) -> int:
        b = self.bill_block
        return -(-m // b) * b

    def run(self, n: int, row_order: Sequence[int] | None = None) -> ExecutorResult:
        """Execute the cascade for ``n`` batch rows.

        Args:
          n: number of rows in the batch.
          row_order: optional initial ordering of the active set (the
            sorted-kernel backend passes a sort permutation here).  Results
            are always scattered back to absolute row indices, so callers
            never apply an inverse permutation themselves.
        """
        plan = self.plan
        T = plan.T
        decisions = np.zeros(n, dtype=bool)
        exit_step = np.full(n, T, dtype=np.int64)
        # carried partial sums live at the decide implementation's dtype
        # (float32 for the chunk-decide kernel, float64 for
        # the numpy reference) so per-stage state is handed over without a
        # down/up conversion round-trip of the whole vector.  The decide's
        # true dtype can depend on the chunk dtype, so the carry also
        # adopts the first stage's output dtype below.  Accumulation
        # happens inside the decide either way — no bits change, only the
        # copies.
        carry_dtype = getattr(self.decide_fn, "carry_dtype", np.float64)
        g = np.zeros(n, dtype=carry_dtype)
        if row_order is None:
            rows = np.arange(n, dtype=np.int64)
        else:
            rows = np.asarray(row_order, dtype=np.int64)
            assert rows.shape == (n,)
        chunk_stats: list[ChunkStat] = []
        scores_computed = 0

        for t0, t1 in plan.stages:
            if rows.size == 0:
                break  # quit when you can: every row has exited
            chunk = np.asarray(self.producer(rows, t0, t1))
            assert chunk.shape == (rows.size, t1 - t0), (
                f"producer returned {chunk.shape}, expected {(rows.size, t1 - t0)}"
            )
            billed = self._billed_rows(rows.size) * (t1 - t0)
            scores_computed += billed
            g_new, active, decided_pos, ex = self.decide_fn(
                g[rows], chunk, plan.eps_pos[t0:t1], plan.eps_neg[t0:t1], t0
            )
            g_new = np.asarray(g_new)
            if g_new.dtype != g.dtype:
                # adopt the decide's dtype once (stage-1 zeros widen/narrow
                # exactly); later stages hand state over conversion-free
                g = g.astype(g_new.dtype)
            g[rows] = g_new
            newly = ~np.asarray(active, dtype=bool)
            exited = rows[newly]
            exit_step[exited] = np.asarray(ex)[newly]
            decisions[exited] = np.asarray(decided_pos, dtype=bool)[newly]
            chunk_stats.append(
                ChunkStat(
                    t0=t0,
                    t1=t1,
                    n_in=int(rows.size),
                    n_exited=int(newly.sum()),
                    scores_computed=int(billed),
                )
            )
            # stable gather: surviving rows keep their relative order
            rows = rows.take(np.nonzero(~newly)[0])

        # rows that never exited: classified by the full ensemble score
        decisions[rows] = g[rows] >= plan.beta
        return ExecutorResult(
            decisions=decisions,
            exit_step=exit_step,
            g_final=g,
            chunk_stats=chunk_stats,
            scores_computed=scores_computed,
            scores_possible=n * T,
        )


def matrix_producer(scores_ordered: np.ndarray) -> ScoreProducer:
    """Producer over a precomputed ORDERED score matrix (tests/oracles).

    Real serving producers call the tree/lattice kernels with a model range
    and row gather instead — this one exists so the executor's control flow
    can be validated independently of the kernels.
    """
    F = np.asarray(scores_ordered)

    def producer(rows: np.ndarray, t0: int, t1: int) -> np.ndarray:
        return F[np.asarray(rows)[:, None], np.arange(t0, t1)[None, :]]

    return producer
