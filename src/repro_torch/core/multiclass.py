"""Multi-class QWYC (the paper's 'straightforward to extend' claim, §6 —
implemented here as a beyond-paper feature), a numpy copy of
``repro.core.multiclass``.

Setting: an additive K-class ensemble F(x) = Σ_t f_t(x) ∈ R^K classified by
argmax.  Early stopping rule: after r base models, exit with class
argmax(g_r) iff the partial margin

    m_r(x) = g_r(x)_[1] - g_r(x)_[2]   (top1 - top2 of the running sum)

exceeds a per-step threshold eps_r >= 0.  The threshold search inherits
Algorithm 2's monotone structure (raising eps_r exits fewer examples and
commits fewer disagreements with the full argmax), so the same exact
sort-based optimizer applies to the margin statistic; the ordering loop is
Algorithm 1 verbatim with J_r unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.thresholds import POS_INF

__all__ = ["MulticlassQWYC", "fit_qwyc_multiclass", "evaluate_multiclass"]


@dataclasses.dataclass
class MulticlassQWYC:
    order: np.ndarray  # (T,)
    eps: np.ndarray  # (T,) margin thresholds (POS_INF = exit disabled)
    costs: np.ndarray
    alpha: float
    train_mean_models: float = 0.0
    train_diff_rate: float = 0.0


def _margin_and_argmax(g: np.ndarray):
    """g: (n, K) running sums -> (margin top1-top2, argmax)."""
    part = np.partition(g, -2, axis=1)
    margin = part[:, -1] - part[:, -2]
    return margin, g.argmax(axis=1)


def _best_margin_threshold(margin, agree, budget):
    """Smallest eps s.t. exiting {margin > eps} commits <= budget
    disagreements (agree[i] = partial argmax equals full argmax).  Exact by
    sorting margins descending (same structure as Algorithm 2)."""
    order = np.argsort(-margin, kind="stable")
    errs = ~agree[order]
    cum = np.cumsum(errs)
    m_sorted = margin[order]
    n = margin.shape[0]
    distinct_next = np.empty(n, dtype=bool)
    distinct_next[:-1] = m_sorted[1:] != m_sorted[:-1]
    distinct_next[-1] = True
    ok = (cum <= budget) & distinct_next
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return POS_INF, 0, 0
    best = int(idx[-1])
    last_in = m_sorted[best]
    thr = 0.5 * (last_in + m_sorted[best + 1]) if best + 1 < n else last_in - 1.0
    # margins are nonnegative; clamp so the exit set is exactly the prefix
    return float(max(thr, 0.0)), best + 1, int(cum[best])


def fit_qwyc_multiclass(
    scores: np.ndarray,  # (N, T, K)
    costs: np.ndarray | None = None,
    alpha: float = 0.0,
    optimize_order: bool = True,
) -> MulticlassQWYC:
    F = np.asarray(scores, dtype=np.float64)
    n, T, K = F.shape
    c = np.ones(T) if costs is None else np.asarray(costs, float)
    full_arg = F.sum(axis=1).argmax(axis=1)

    perm = np.arange(T)
    eps = np.full(T, POS_INF)
    budget = int(np.floor(alpha * n))
    g = np.zeros((n, K))
    active = np.ones(n, dtype=bool)
    exit_step = np.full(n, T, dtype=np.int64)
    exit_cls = np.full(n, -1, dtype=np.int64)

    for r in range(T):
        act = np.nonzero(active)[0]
        if act.size == 0:
            break
        if optimize_order:
            best = (np.inf, r, POS_INF, 0)
            for k in range(r, T):
                t = perm[k]
                gc = g[act] + F[act, t]
                margin, arg = _margin_and_argmax(gc)
                agree = arg == full_arg[act]
                thr, n_exit, _ = _best_margin_threshold(margin, agree, budget)
                J = c[t] * act.size / n_exit if n_exit else np.inf
                if J < best[0] or (not np.isfinite(best[0]) and c[t] < c[perm[best[1]]]):
                    best = (J, k, thr, n_exit)
            _, k_best, thr, _ = best
            perm[r], perm[k_best] = perm[k_best], perm[r]
        else:
            t = perm[r]
            gc = g[act] + F[act, t]
            margin, arg = _margin_and_argmax(gc)
            agree = arg == full_arg[act]
            thr, _, _ = _best_margin_threshold(margin, agree, budget)

        t = perm[r]
        g[act] += F[act, t]
        eps[r] = thr
        margin, arg = _margin_and_argmax(g[act])
        out = margin > thr
        budget -= int((arg[out] != full_arg[act][out]).sum())
        exit_step[act[out]] = r + 1
        exit_cls[act[out]] = arg[out]
        active[act[out]] = False

    never = exit_step == T
    exit_cls[never] = full_arg[never]
    m = MulticlassQWYC(order=perm, eps=eps, costs=c, alpha=alpha)
    m.train_mean_models = float(exit_step.mean())
    m.train_diff_rate = float((exit_cls != full_arg).mean())
    return m


def evaluate_multiclass(m: MulticlassQWYC, scores: np.ndarray) -> dict:
    F = np.asarray(scores, dtype=np.float64)
    n, T, K = F.shape
    G = np.cumsum(F[:, m.order], axis=1)  # (n, T, K)
    part = np.partition(G, -2, axis=2)
    margin = part[:, :, -1] - part[:, :, -2]  # (n, T)
    hit = margin > m.eps[None, :]
    any_hit = hit.any(axis=1)
    first = np.where(any_hit, np.argmax(hit, axis=1), T - 1)
    exit_step = np.where(any_hit, first + 1, T)
    rows = np.arange(n)
    dec = np.where(any_hit, G[rows, first].argmax(axis=1), G[:, -1].argmax(axis=1))
    full_arg = G[:, -1].argmax(axis=1)
    return {
        "decisions": dec,
        "exit_step": exit_step,
        "mean_models": float(exit_step.mean()),
        "diff_rate": float((dec != full_arg).mean()),
    }
