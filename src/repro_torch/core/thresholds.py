"""Algorithm 2: early-stopping threshold optimization.

Given the running partial scores ``g`` of the examples still active at step
``r`` (the set C_{r-1}), the full-ensemble decisions for those examples, and
the remaining global error budget (``alpha * N`` minus errors already
committed at earlier steps), find the thresholds

    eps_neg:  largest value s.t. classifying ``g < eps_neg`` as NEGATIVE
              commits at most ``budget`` disagreements with the full model,
    eps_pos:  smallest value s.t. classifying ``g > eps_pos`` as POSITIVE
              commits at most the remaining budget.

The paper prescribes binary search, exploiting that the exit count is
monotone and the constraint violation is monotone in each threshold.  The
binary search over a continuous threshold converges onto a gap between two
adjacent sorted ``g`` values, so the *exact* optimum is obtained directly by
sorting — ``optimize_threshold_sorted`` below.  ``optimize_threshold_bisect``
implements the literal binary search.  A numpy copy of
``repro.core.thresholds``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEG_INF = -np.inf
POS_INF = np.inf


@dataclasses.dataclass(frozen=True)
class ThresholdResult:
    """Outcome of optimizing one side's threshold at one step."""

    threshold: float
    n_exited: int
    n_errors: int


def _prefix_best(g_sorted: np.ndarray, err_sorted: np.ndarray, budget: int):
    """Longest prefix of the sorted exit order with cumulative errors <= budget.

    Returns (n_exited, n_errors) for the best *cut between distinct values*;
    the caller converts the cut position back into a threshold.  Exits must be
    strict inequalities (g < eps_neg / g > eps_pos), so a cut may only be
    placed between two distinct g values (ties exit together or not at all).
    """
    n = g_sorted.shape[0]
    if n == 0:
        return 0, 0
    cum_err = np.cumsum(err_sorted)
    # valid cut after position i (0-based, exits = i+1) requires the next
    # value to differ (or i == n-1), and cum_err[i] <= budget.
    distinct_next = np.empty(n, dtype=bool)
    distinct_next[:-1] = g_sorted[1:] != g_sorted[:-1]
    distinct_next[-1] = True
    ok = (cum_err <= budget) & distinct_next
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return 0, 0
    best = int(idx[-1])
    return best + 1, int(cum_err[best])


def optimize_threshold_sorted(
    g: np.ndarray,
    full_positive: np.ndarray,
    budget: int,
    side: str,
) -> ThresholdResult:
    """Exact optimizer for one threshold (the fixed point of Algorithm 2's
    binary search).

    Args:
      g: (n_active,) partial scores of still-active examples.
      full_positive: (n_active,) bool — full-ensemble decision is positive.
      budget: max number of new disagreements this exit may commit.
      side: 'neg' optimizes eps_neg (exit set g < eps, errors are
        full-positives); 'pos' optimizes eps_pos (exit set g > eps, errors are
        full-negatives).
    """
    g = np.asarray(g, dtype=np.float64)
    full_positive = np.asarray(full_positive, dtype=bool)
    if g.shape[0] == 0:
        return ThresholdResult(NEG_INF if side == "neg" else POS_INF, 0, 0)
    if side == "neg":
        order = np.argsort(g, kind="stable")  # ascending: smallest exit first
        errs = full_positive[order]
    elif side == "pos":
        order = np.argsort(-g, kind="stable")  # descending: largest exit first
        errs = ~full_positive[order]
    else:
        raise ValueError(side)
    g_sorted = g[order]
    n_exited, n_errors = _prefix_best(g_sorted, errs.astype(np.int64), budget)
    if n_exited == 0:
        return ThresholdResult(NEG_INF if side == "neg" else POS_INF, 0, 0)
    last_in = g_sorted[n_exited - 1]
    if n_exited < g.shape[0]:
        first_out = g_sorted[n_exited]
        thr = 0.5 * (last_in + first_out)
        if thr == last_in:
            # adjacent doubles: the midpoint rounds onto last_in, which the
            # strict exit test would then keep in; first_out still keeps
            # itself out and lets last_in exit.
            thr = first_out
    else:
        # everything exits: any threshold beyond the extreme value works.
        thr = last_in + 1.0 if side == "neg" else last_in - 1.0
    return ThresholdResult(float(thr), n_exited, n_errors)


def optimize_threshold_bisect(
    g: np.ndarray,
    full_positive: np.ndarray,
    budget: int,
    side: str,
    iters: int = 64,
) -> ThresholdResult:
    """Literal Algorithm-2 binary search (for cross-validation in tests).

    Searches the largest eps_neg (resp. smallest eps_pos by searching the
    largest exit mass) whose committed error count stays within budget.
    """
    g = np.asarray(g, dtype=np.float64)
    full_positive = np.asarray(full_positive, dtype=bool)
    if g.shape[0] == 0:
        return ThresholdResult(NEG_INF if side == "neg" else POS_INF, 0, 0)

    def stats(thr: float):
        if side == "neg":
            exit_mask = g < thr
            err = exit_mask & full_positive
        else:
            exit_mask = g > thr
            err = exit_mask & ~full_positive
        return int(exit_mask.sum()), int(err.sum())

    lo = float(g.min()) - 1.0
    hi = float(g.max()) + 1.0
    if side == "neg":
        # feasible at lo (nothing exits); push threshold up while within budget.
        feasible, infeasible = lo, hi
        _, err_hi = stats(hi)
        if err_hi <= budget:
            feasible = hi
        for _ in range(iters):
            mid = 0.5 * (feasible + infeasible)
            _, e = stats(mid)
            if e <= budget:
                feasible = mid
            else:
                infeasible = mid
            if feasible == hi:
                break
        thr = feasible
    else:
        feasible, infeasible = hi, lo
        _, err_lo = stats(lo)
        if err_lo <= budget:
            feasible = lo
        for _ in range(iters):
            mid = 0.5 * (feasible + infeasible)
            _, e = stats(mid)
            if e <= budget:
                feasible = mid
            else:
                infeasible = mid
            if feasible == lo:
                break
        thr = feasible
    n_exited, n_errors = stats(thr)
    if n_exited == 0:
        thr = NEG_INF if side == "neg" else POS_INF
    return ThresholdResult(float(thr), n_exited, n_errors)


def optimize_step_thresholds(
    g: np.ndarray,
    full_positive: np.ndarray,
    budget: int,
    mode: str = "both",
) -> tuple[ThresholdResult, ThresholdResult]:
    """Optimize (eps_neg, eps_pos) for one step, sharing the error budget.

    Follows Algorithm 2's order: eps_neg first (line 4), then eps_pos with
    whatever budget remains (line 5).  ``mode='neg_only'`` is the paper's
    Filter-and-Score case: positives must be fully scored, so eps_pos = +inf.
    """
    neg = optimize_threshold_sorted(g, full_positive, budget, "neg")
    if mode == "neg_only":
        return neg, ThresholdResult(POS_INF, 0, 0)
    remaining = budget - neg.n_errors
    # examples that exited negative are no longer candidates for eps_pos
    still = ~(g < neg.threshold) if np.isfinite(neg.threshold) else np.ones_like(g, dtype=bool)
    pos = optimize_threshold_sorted(g[still], full_positive[still], remaining, "pos")
    return neg, pos
