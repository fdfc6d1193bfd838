"""Host oracle for grouped cascades (the counterpart of
``repro.ranking.host``).

A plain numpy replay of the grouped stage loop — the reference the device
path (``DeviceExecutor.run_grouped``) is parity-tested against.  Accumulation is per-column
f32 adds in cascade order, the exact add sequence the device programs
use, so at ``eps_g = MARGIN_INF`` (no stage may exit) the device
verdicts must match ``full_cascade_topk`` **bit-identically**, not
approximately.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.executor import ChunkStat
from repro_torch.ranking.bucketing import bucket_layout, group_offsets
from repro_torch.ranking.plan import GroupedPlan, topk_margin

__all__ = ["GroupedHostResult", "full_cascade_topk", "run_grouped_host"]


@dataclasses.dataclass(frozen=True)
class GroupedHostResult:
    """One ranked verdict per query group.

    ``verdicts`` (G, k) are GLOBAL flat document row ids in rank order,
    -1 past the group's size; ``exit_stage`` (G,) is 1-based (``S`` for
    groups that ran the full cascade); ``margin`` (G,) is the top-k
    stability margin at decision time.  ``scores_computed`` counts real
    documents scored (docs in still-active groups x stage width) —
    device paths layer their own block/group quantization on top.
    """

    verdicts: np.ndarray
    exit_stage: np.ndarray
    margin: np.ndarray
    chunk_stats: list[ChunkStat]
    scores_computed: int
    scores_possible: int


def run_grouped_host(
    gplan: GroupedPlan, scores, sizes, *, eps_g=None
) -> GroupedHostResult:
    """Replay the grouped cascade on the host.

    ``scores`` is the flat (N, T) per-document score matrix in ORIGINAL
    model order (reordered here by the plan's greedy order), documents
    of each group contiguous; ``sizes`` (G,) the ragged group sizes.
    ``eps_g`` overrides the plan's per-stage margin thresholds — pass
    ``np.full(S, MARGIN_INF)`` (or ``gplan.with_margin_inf()``) to force
    the full cascade.
    """
    F = np.asarray(scores, dtype=np.float32)[:, gplan.plan.order]
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.sum() != F.shape[0]:
        raise ValueError(
            f"group sizes sum to {sizes.sum()} but scores have "
            f"{F.shape[0]} rows"
        )
    stages = gplan.plan.stages
    S = len(stages)
    k = gplan.k
    eps = gplan.eps_g if eps_g is None else np.asarray(eps_g, dtype=np.float32)
    if len(eps) != S:
        raise ValueError(f"eps_g has {len(eps)} entries for {S} stages")

    offsets = group_offsets(sizes)
    G = sizes.size
    Bmax = int(sizes.max()) if G else 1
    rows, valid = bucket_layout(sizes, Bmax, offsets=offsets)
    Fg = F[rows]  # (G, Bmax, T); padding lanes alias row 0, masked below

    g = np.zeros((G, Bmax), dtype=np.float32)
    active = np.ones(G, dtype=bool)
    verdicts = np.full((G, k), -1, dtype=np.int32)
    exit_stage = np.full(G, S, dtype=np.int64)
    margin_out = np.full(G, np.inf, dtype=np.float32)
    stats: list[ChunkStat] = []
    scores_computed = 0

    def _record(mask: np.ndarray, idx: np.ndarray, margin: np.ndarray, s1b: int):
        sel = np.flatnonzero(mask)
        if sel.size == 0:
            return
        lanes = idx[sel]  # (m, k) lane offsets, -1 padded
        glob = offsets[sel, None] + lanes
        verdicts[sel] = np.where(lanes >= 0, glob, -1).astype(np.int32)
        exit_stage[sel] = s1b
        margin_out[sel] = margin[sel]

    for s, (t0, t1) in enumerate(stages):
        n_in = int(active.sum())
        if n_in == 0:
            stats.append(ChunkStat(t0, t1, 0, 0, 0))
            continue
        paid = int(sizes[active].sum()) * (t1 - t0)
        scores_computed += paid
        upd = active[:, None] & valid
        for t in range(t0, t1):
            g = g + np.where(upd, Fg[:, :, t], np.float32(0.0))
        idx, margin = topk_margin(g, valid, k)
        exited = active & (margin > eps[s])
        _record(exited, idx, margin, s + 1)
        active &= ~exited
        stats.append(ChunkStat(t0, t1, n_in, int(exited.sum()), paid))
    # ran-out groups carry the exact full-cascade ranking
    if active.any():
        idx, margin = topk_margin(g, valid, k)
        _record(active, idx, margin, S)
    return GroupedHostResult(
        verdicts=verdicts,
        exit_stage=exit_stage,
        margin=margin_out,
        chunk_stats=stats,
        scores_computed=scores_computed,
        scores_possible=int(sizes.sum()) * gplan.plan.T,
    )


def full_cascade_topk(scores, sizes, k, *, order=None) -> np.ndarray:
    """The margin-infinity reference: top-k GLOBAL document ids per
    group under the FULL ensemble, accumulated per-column in ``order``
    (pass the plan's greedy order for bit-parity with device paths;
    defaults to the natural column order)."""
    F = np.asarray(scores, dtype=np.float32)
    if order is not None:
        F = F[:, np.asarray(order)]
    sizes = np.asarray(sizes, dtype=np.int64)
    offsets = group_offsets(sizes)
    G = sizes.size
    Bmax = int(sizes.max()) if G else 1
    rows, valid = bucket_layout(sizes, Bmax, offsets=offsets)
    Fg = F[rows]
    g = np.zeros((G, Bmax), dtype=np.float32)
    for t in range(F.shape[1]):
        g = g + np.where(valid, Fg[:, :, t], np.float32(0.0))
    idx, _ = topk_margin(g, valid, int(k))
    glob = offsets[:G, None] + idx
    return np.where(idx >= 0, glob, -1).astype(np.int32)
