"""Grouped cascade plans: per-query top-k stability thresholds (the
counterpart of ``repro.ranking.plan``, host numpy in both packages).

A ranking cascade decides per QUERY: the ragged group of candidate
documents stops paying for more base models once its top-k ORDER is
stable.  The stability statistic is the **top-k margin** — the gap
between the k-th and (k+1)-th best partial document scores within the
group (the score-gap/sentinel criterion of Lucchese et al. 2020 and
Busolin et al. 2021, PAPERS.md).  A wide margin means the remaining
models are unlikely to reorder the head of the ranking, so the group
exits as a unit; ``margin > eps_g[s]`` is deliberately STRICT so that
``eps_g = +inf`` (``MARGIN_INF``) never exits — that configuration IS
the full cascade, which is what every device path is parity-tested
against.

``fit_grouped`` reuses ``fit_qwyc``'s greedy joint ordering over the
flat per-document score matrix (the ordering objective — front-load the
informative models — is the same), then calibrates one margin threshold
per STAGE by replaying the cascade over the calibration groups: at each
stage the exit threshold is pushed as low as the ``alpha`` budget on
top-k disagreement (vs the full ensemble's ranking) allows.

Everything here is host/numpy: the group decide kernel (B8,
``kernels.cascade_kernel.cascade_group_kernel``) and the grouped stage
loop (``DeviceExecutor.run_grouped``) consume the resulting
``GroupedPlan`` arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.executor import DEFAULT_CHUNK_T, CascadePlan
from repro_torch.core.qwyc import QWYCModel, fit_qwyc

__all__ = ["MARGIN_INF", "GroupedPlan", "fit_grouped", "topk_margin"]

#: the never-exit threshold: ``margin > MARGIN_INF`` is False even for a
#: trivially stable group (margin == +inf), so the cascade runs to the
#: end — the parity oracle configuration.
MARGIN_INF = np.float32(np.inf)


def topk_margin(
    g: np.ndarray, valid: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k lane offsets and stability margin per group — the numpy
    reference every device path mirrors bit-identically.

    ``g`` is (G, B) partial document scores, ``valid`` (G, B) marks real
    (non-padding) lanes.  Selection is by score descending with ties
    broken to the LOWEST lane offset (numpy's first-argmax — the group
    decide kernel, its plain version and ``group_topk_rows`` reproduce
    exactly this, so verdicts can be compared with ``array_equal``).  Returns ``(idx, margin)``: ``idx``
    (G, k) int32 lane offsets, -1 past the group's size; ``margin`` (G,)
    float32 — the k-th minus (k+1)-th best score, or +inf when the group
    has at most k documents (a head that cannot reorder is trivially
    stable).
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    g = np.asarray(g, dtype=np.float32)
    valid = np.asarray(valid, dtype=bool)
    G, B = g.shape
    work = np.where(valid, g, -np.inf)
    avail = valid.copy()
    idx = np.full((G, k), -1, dtype=np.int32)
    vals = np.empty((k + 1, G), dtype=np.float32)
    for i in range(k + 1):
        masked = np.where(avail, work, -np.inf)
        cur = masked.max(axis=1) if B else np.full(G, -np.inf, np.float32)
        vals[i] = cur
        if i < k:
            hit = avail & (masked == cur[:, None]) & np.isfinite(cur)[:, None]
            first = hit & (np.cumsum(hit, axis=1) == 1)
            has = first.any(axis=1)
            idx[has, i] = first[has].argmax(axis=1)
            avail &= ~first
    size = valid.sum(axis=1)
    margin = np.full(G, np.inf, dtype=np.float32)
    deep = size > k  # ≥ k+1 real docs: both vals are finite
    margin[deep] = vals[k - 1][deep] - vals[k][deep]
    return idx, margin


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """A ``CascadePlan`` plus the group-level exit surface.

    ``eps_g[s]`` is the top-k margin a group must STRICTLY exceed after
    stage ``s`` to exit; the row thresholds inside ``plan`` are unused by
    grouped decides (groups exit on order stability, not score sign) —
    the plan carries the stage windows, the greedy order and the costs.
    ``buckets`` are the admission pad widths ragged groups are packed to
    (``ranking.bucketing``); every device run handles ONE bucket width,
    so its buffers are one (groups, width) rectangle.
    """

    plan: CascadePlan
    model: QWYCModel = dataclasses.field(repr=False)
    eps_g: np.ndarray  # (S,) float32 per-stage margin thresholds
    k: int
    buckets: tuple[int, ...]
    train_exit_stage: np.ndarray | None = dataclasses.field(
        default=None, repr=False
    )
    train_disagreement: float = 0.0

    @property
    def S(self) -> int:
        return len(self.plan.stages)

    @property
    def T(self) -> int:
        return self.plan.T

    def with_margin_inf(self) -> "GroupedPlan":
        """The parity configuration: no stage can exit, every group runs
        the full cascade and the verdict is the full ensemble's top-k."""
        return dataclasses.replace(
            self, eps_g=np.full(self.S, MARGIN_INF, dtype=np.float32)
        )


def _pad_groups(F: np.ndarray, sizes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(G, Bmax, T) padded score tensor + (G, Bmax) validity for the
    calibration replay (padding never affects a margin — invalid lanes
    score -inf in the top-k selection)."""
    G = sizes.size
    Bmax = int(sizes.max()) if G else 1
    T = F.shape[1]
    out = np.zeros((G, Bmax, T), dtype=np.float32)
    valid = np.zeros((G, Bmax), dtype=bool)
    off = 0
    for i, sz in enumerate(sizes):
        out[i, :sz] = F[off : off + sz]
        valid[i, :sz] = True
        off += sz
    return out, valid


def fit_grouped(
    scores: np.ndarray,
    sizes,
    k: int,
    *,
    costs=None,
    alpha: float = 0.0,
    beta: float = 0.0,
    mode: str = "both",
    optimize_order: bool = True,
    order=None,
    chunk_t: int = DEFAULT_CHUNK_T,
    buckets=None,
    verbose: bool = False,
) -> GroupedPlan:
    """Fit a grouped early-exit cascade on ragged calibration queries.

    ``scores`` is the flat (N, T) per-document score matrix in ORIGINAL
    model order, documents of each query contiguous; ``sizes`` (G,) are
    the ragged group sizes (``sum(sizes) == N``); ``k`` is the ranking
    depth whose stability gates the exit.

    The greedy joint ordering comes straight from ``fit_qwyc`` on the
    flat matrix (same objective: maximize early-exit probability per
    cost).  Stage thresholds are then calibrated sequentially: at each
    stage, still-active groups are ranked by margin and exits are
    admitted greedily while the cumulative top-k disagreement (vs the
    full ensemble's ranking) stays within ``alpha`` of the query count —
    the grouped analogue of ``fit_qwyc``'s alpha contract.  Thresholds
    never drop below 0: a zero margin means the boundary is a tie, so
    the order is NOT determined yet.
    """
    F = np.asarray(scores, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.int64)
    if F.ndim != 2:
        raise ValueError(f"scores must be (N, T), got {F.shape}")
    if sizes.sum() != F.shape[0]:
        raise ValueError(
            f"group sizes sum to {sizes.sum()} but scores have "
            f"{F.shape[0]} rows"
        )
    if (sizes < 1).any():
        raise ValueError("every group needs at least one document")
    model = fit_qwyc(
        F,
        costs=costs,
        beta=beta,
        alpha=alpha,
        mode=mode,
        optimize_order=optimize_order,
        order=order,
        verbose=verbose,
    )
    plan = CascadePlan.from_qwyc(model, chunk_t=chunk_t)
    stages = plan.stages
    S = len(stages)
    G = sizes.size

    Fg, valid = _pad_groups(
        F[:, plan.order].astype(np.float32), sizes
    )  # (G, Bmax, T) cascade order
    # full-cascade reference ranking: accumulate stage by stage, column
    # by column — the SAME f32 add order the executors use
    g = np.zeros(valid.shape, dtype=np.float32)
    margins_by_stage = np.empty((S, G), dtype=np.float32)
    topk_by_stage = np.empty((S, G, k), dtype=np.int32)
    for s, (t0, t1) in enumerate(stages):
        for t in range(t0, t1):
            g = g + Fg[:, :, t]
        idx, margin = topk_margin(g, valid, k)
        margins_by_stage[s] = margin
        topk_by_stage[s] = idx
    final_topk = topk_by_stage[-1]

    eps_g = np.zeros(S, dtype=np.float32)
    active = np.ones(G, dtype=bool)
    exit_stage = np.full(G, S, dtype=np.int64)
    budget = int(np.floor(alpha * G))
    wrong_exits = 0
    for s in range(S):
        margin = margins_by_stage[s]
        wrong = ~(topk_by_stage[s] == final_topk).all(axis=1)
        cand = np.flatnonzero(active & (margin > 0.0))
        cand = cand[np.argsort(-margin[cand], kind="stable")]
        eps = 0.0
        spent = wrong_exits
        for gi in cand:
            if wrong[gi]:
                if spent >= budget:
                    # first unaffordable wrong exit: raise the threshold
                    # to fence it (and everything below it) out
                    eps = float(margin[gi])
                    break
                spent += 1
        eps_g[s] = np.float32(max(eps, 0.0))
        exited = active & (margin > eps_g[s])
        wrong_exits += int((exited & wrong).sum())
        exit_stage[np.flatnonzero(exited)] = s + 1
        active &= ~exited
        if not active.any():
            eps_g[s + 1 :] = eps_g[s]
            break
    # groups that ran the full cascade carry the exact final ranking
    disagree = float(wrong_exits) / max(G, 1)
    if buckets is None:
        from repro_torch.ranking.bucketing import bucket_widths_for

        buckets = bucket_widths_for(sizes)
    return GroupedPlan(
        plan=plan,
        model=model,
        eps_g=eps_g,
        k=int(k),
        buckets=tuple(int(b) for b in buckets),
        train_exit_stage=exit_stage,
        train_disagreement=disagree,
    )
