"""QWYC (Quit When You Can): joint optimization of base-model ordering and
early-stopping thresholds — Algorithm 1 of the paper.

The optimizer is a calibration-time procedure operating on the precomputed
score matrix ``F`` with ``F[i, t] = f_t(x_i)`` (scores of example i under base
model t), per-model costs ``c``, the ensemble decision threshold ``beta`` and
the allowed disagreement rate ``alpha``.  It runs on host (numpy); the
*runtime* cascade that consumes its output lives in ``core/executor.py`` and
``kernels/cascade_kernel.py`` (the CUDA chunk-decide kernel).  A numpy copy of
``repro.core.qwyc``: calibration is host work in both packages.

Complexity: the greedy loop is O(T^2 N log N) via one batched sort per
(step, candidate-block); the per-step candidate sweep is vectorized across
all remaining candidates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.thresholds import (
    NEG_INF,
    POS_INF,
    optimize_step_thresholds,
)

__all__ = ["QWYCModel", "fit_qwyc", "fit_thresholds_for_order", "evaluate_cascade"]


@dataclasses.dataclass
class QWYCModel:
    """Optimized ordering + thresholds, ready for the runtime cascade."""

    order: np.ndarray  # (T,) permutation: order[r] = original index of r-th model
    eps_pos: np.ndarray  # (T,) early-positive thresholds (POS_INF = disabled)
    eps_neg: np.ndarray  # (T,) early-negative thresholds (NEG_INF = disabled)
    beta: float
    costs: np.ndarray  # (T,) in ORIGINAL model index order
    alpha: float
    mode: str  # 'both' | 'neg_only'
    train_mean_models: float = 0.0
    train_mean_cost: float = 0.0
    train_diff_rate: float = 0.0
    trace: list = dataclasses.field(default_factory=list)

    @property
    def T(self) -> int:
        return int(self.order.shape[0])

    def ordered_costs(self) -> np.ndarray:
        return self.costs[self.order]


def _candidate_side(
    G: np.ndarray,
    err_flag: np.ndarray,
    budget: int | np.ndarray,
    descending: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized one-side threshold optimization for K candidates at once.

    Args:
      G: (n_active, K) partial scores if each candidate were placed next.
        Entries equal to +/-inf are 'excluded' (already exited the other
        side) and can never exit on this side.
      err_flag: (n_active, K) bool — exiting this example on this side is an
        error.
      budget: per-candidate error budget — a scalar (the candidates are
        alternatives sharing one budget) or a (K,) vector (the positive
        side's budget is whatever the negative side left each candidate).
      descending: True for the positive side (exit set g > eps), False for
        the negative side (exit set g < eps).

    Returns (thr, n_exited, n_errors), each (K,).
    """
    n, k = G.shape
    budget = np.broadcast_to(np.asarray(budget, dtype=np.int64), (k,))
    # 'disabled' sentinel: +inf for the positive side (nothing is > +inf),
    # -inf for the negative side (nothing is < -inf).
    disabled_fill = POS_INF if descending else NEG_INF
    if n == 0:
        z = np.zeros(k, dtype=np.int64)
        return np.full(k, disabled_fill), z, z
    key = -G if descending else G
    idx = np.argsort(key, axis=0, kind="stable")
    g_sorted = np.take_along_axis(G, idx, axis=0)
    err_sorted = np.take_along_axis(err_flag, idx, axis=0)
    cum_err = np.cumsum(err_sorted, axis=0)
    distinct_next = np.empty((n, k), dtype=bool)
    distinct_next[:-1] = g_sorted[1:] != g_sorted[:-1]
    distinct_next[-1] = True
    ok = (cum_err <= budget[None, :]) & distinct_next & np.isfinite(g_sorted)
    # deepest valid cut per column: last True along axis 0
    rev_arg = np.argmax(ok[::-1], axis=0)
    any_ok = ok.any(axis=0)
    best = np.where(any_ok, n - 1 - rev_arg, -1)
    cols = np.arange(k)
    n_exited = np.where(any_ok, best + 1, 0)
    n_errors = np.where(any_ok, cum_err[np.clip(best, 0, n - 1), cols], 0)
    last_in = g_sorted[np.clip(best, 0, n - 1), cols]
    nxt = np.clip(best + 1, 0, n - 1)
    first_out = g_sorted[nxt, cols]
    full_exit = best == n - 1
    bump = -1.0 if descending else 1.0
    thr = np.where(
        full_exit | ~np.isfinite(first_out), last_in + bump, 0.5 * (last_in + first_out)
    )
    thr = np.where(any_ok, thr, disabled_fill)
    return thr, n_exited.astype(np.int64), n_errors.astype(np.int64)


def _eval_candidates(
    G: np.ndarray,
    full_pos: np.ndarray,
    budget: int,
    mode: str,
):
    """Evaluate all K candidate base models for the current position.

    Per Algorithm 2's ordering: eps_neg is optimized first with the whole
    remaining budget, then eps_pos with what the neg side left over.
    Returns dict of (K,) arrays.
    """
    n, k = G.shape
    fp = np.broadcast_to(full_pos[:, None], (n, k))
    thr_neg, nex_neg, nerr_neg = _candidate_side(G, fp, budget, descending=False)
    if mode == "neg_only":
        thr_pos = np.full(k, POS_INF)
        nex_pos = np.zeros(k, dtype=np.int64)
        nerr_pos = np.zeros(k, dtype=np.int64)
    else:
        # mask out already-exited (negative-side) examples per candidate
        exited_neg = G < thr_neg[None, :]
        G_pos = np.where(exited_neg, -POS_INF, G)
        err_pos = (~fp) & ~exited_neg
        # per-candidate remaining budget: one grouped sweep (vector budget)
        # instead of one _candidate_side call per distinct budget value,
        # which degraded to K sorts of the full matrix when budgets were
        # all distinct.
        remaining = budget - nerr_neg
        thr_pos, nex_pos, nerr_pos = _candidate_side(
            G_pos, err_pos, remaining, descending=True
        )
    return {
        "thr_neg": thr_neg,
        "thr_pos": thr_pos,
        "n_exited": nex_neg + nex_pos,
        "n_errors": nerr_neg + nerr_pos,
    }


def fit_qwyc(
    scores: np.ndarray,
    costs: np.ndarray | None = None,
    beta: float = 0.0,
    alpha: float = 0.0,
    mode: str = "both",
    optimize_order: bool = True,
    order: np.ndarray | None = None,
    verbose: bool = False,
) -> QWYCModel:
    """Fit QWYC on a calibration score matrix.

    Args:
      scores: (N, T) with scores[i, t] = f_t(x_i).  Unlabeled — QWYC only
        needs agreement with the full ensemble, not ground truth.
      costs: (T,) evaluation cost per base model (default all-ones).
      beta: full-ensemble decision threshold.
      alpha: max fraction of examples allowed to disagree with the full model.
      mode: 'both' or 'neg_only' (Filter-and-Score: only early rejection).
      optimize_order: True = Algorithm 1 (QWYC*); False = Algorithm 2 with
        the pre-selected ``order`` (identity if None).
      order: pre-selected ordering when optimize_order=False.
    """
    F = np.asarray(scores, dtype=np.float64)
    n, T = F.shape
    c = np.ones(T) if costs is None else np.asarray(costs, dtype=np.float64)
    assert c.shape == (T,)
    full_score = F.sum(axis=1)
    full_pos = full_score >= beta

    if optimize_order:
        perm = np.arange(T)
    else:
        perm = np.arange(T) if order is None else np.asarray(order).copy()
        assert sorted(perm.tolist()) == list(range(T))

    eps_pos = np.full(T, POS_INF)
    eps_neg = np.full(T, NEG_INF)
    budget = int(np.floor(alpha * n))
    g = np.zeros(n)
    active = np.ones(n, dtype=bool)
    exit_step = np.full(n, T, dtype=np.int64)  # 1-based step of exit; T = never
    exit_pos = np.zeros(n, dtype=bool)
    trace = []

    for r in range(T):
        n_active = int(active.sum())
        if n_active == 0:
            # everyone exited; remaining models are appended in given order
            # with disabled thresholds (they will never be evaluated).
            break
        act_idx = np.nonzero(active)[0]
        fp_active = full_pos[act_idx]
        if optimize_order:
            cands = perm[r:]
            G = g[act_idx, None] + F[np.ix_(act_idx, cands)]
            res = _eval_candidates(G, fp_active, budget, mode)
            with np.errstate(divide="ignore"):
                J = np.where(
                    res["n_exited"] > 0, c[cands] * n_active / res["n_exited"], POS_INF
                )
            if np.isfinite(J).any():
                k_best = int(np.argmin(J))
            else:
                k_best = int(np.argmin(c[cands]))  # nobody exits: cheapest next
            # swap into position r
            perm[r], perm[r + k_best] = perm[r + k_best], perm[r]
            t_choice = perm[r]
            thr_neg = float(res["thr_neg"][k_best])
            thr_pos = float(res["thr_pos"][k_best])
            step_errors = int(res["n_errors"][k_best])
            step_J = float(J[k_best])
        else:
            t_choice = perm[r]
            g_cand = g[act_idx] + F[act_idx, t_choice]
            neg, pos = optimize_step_thresholds(g_cand, fp_active, budget, mode)
            thr_neg, thr_pos = neg.threshold, pos.threshold
            step_errors = neg.n_errors + pos.n_errors
            denom = neg.n_exited + pos.n_exited
            step_J = c[t_choice] * n_active / denom if denom else POS_INF

        # commit step r.  Enforce the paper's eps_neg <= eps_pos constraint:
        # when one side exits every remaining example its threshold can
        # overshoot the other side's; clamping preserves the exit sets
        # (thresholds sit strictly between observed g values).
        if np.isfinite(thr_neg) and thr_pos < thr_neg:
            thr_pos = thr_neg
        g[act_idx] += F[act_idx, t_choice]
        eps_neg[r], eps_pos[r] = thr_neg, thr_pos
        budget -= step_errors
        g_act = g[act_idx]
        out_neg = g_act < thr_neg  # negative exit takes priority (Alg. 2 order)
        out_pos = (g_act > thr_pos) & ~out_neg
        newly = out_neg | out_pos
        exit_step[act_idx[newly]] = r + 1
        exit_pos[act_idx[out_pos]] = True
        active[act_idx[newly]] = False
        trace.append(
            {
                "step": r,
                "model": int(t_choice),
                "n_active": n_active,
                "n_exited": int(newly.sum()),
                "n_errors": step_errors,
                "J": step_J,
                "eps_neg": thr_neg,
                "eps_pos": thr_pos,
                "budget_left": budget,
            }
        )
        if verbose:
            print(
                f"[qwyc] r={r:4d} model={t_choice:4d} active={n_active:6d} "
                f"exited={int(newly.sum()):6d} errs={step_errors} J={step_J:.3f}"
            )

    # examples never exited: classified by the full ensemble (no error)
    never = exit_step == T
    exit_pos[never] = full_pos[never]
    decisions = exit_pos

    cum_cost = np.cumsum(c[perm])
    mean_models = float(exit_step.mean())
    mean_cost = float(cum_cost[exit_step - 1].mean())
    diff_rate = float((decisions != full_pos).mean())
    model = QWYCModel(
        order=perm,
        eps_pos=eps_pos,
        eps_neg=eps_neg,
        beta=float(beta),
        costs=c,
        alpha=float(alpha),
        mode=mode,
        train_mean_models=mean_models,
        train_mean_cost=mean_cost,
        train_diff_rate=diff_rate,
        trace=trace,
    )
    return model


def fit_thresholds_for_order(
    scores: np.ndarray,
    order: np.ndarray,
    costs: np.ndarray | None = None,
    beta: float = 0.0,
    alpha: float = 0.0,
    mode: str = "both",
) -> QWYCModel:
    """Algorithm 2 alone: optimize thresholds for a pre-selected ordering."""
    return fit_qwyc(
        scores,
        costs=costs,
        beta=beta,
        alpha=alpha,
        mode=mode,
        optimize_order=False,
        order=order,
    )


def evaluate_cascade(
    model: QWYCModel, scores: np.ndarray
) -> dict:
    """Run the cascade on a test score matrix (vectorized reference).

    Returns decisions, exit steps (1-based; T if never exited early), mean
    #models, mean modeled cost, and disagreement rate vs the full ensemble.
    """
    F = np.asarray(scores, dtype=np.float64)
    n, T = F.shape
    assert T == model.T
    G = np.cumsum(F[:, model.order], axis=1)  # (n, T) partial scores
    hit_pos = G > model.eps_pos[None, :]
    hit_neg = G < model.eps_neg[None, :]
    hit = hit_pos | hit_neg
    any_hit = hit.any(axis=1)
    first = np.where(any_hit, np.argmax(hit, axis=1), T - 1)
    exit_step = np.where(any_hit, first + 1, T)
    rows = np.arange(n)
    early_dec = hit_pos[rows, first] & ~hit_neg[rows, first]  # neg priority
    full_pos = G[:, -1] >= model.beta
    decisions = np.where(any_hit, early_dec, full_pos)
    cum_cost = np.cumsum(model.ordered_costs())
    return {
        "decisions": decisions,
        "exit_step": exit_step,
        "mean_models": float(exit_step.mean()),
        "mean_cost": float(cum_cost[exit_step - 1].mean()),
        "diff_rate": float((decisions != full_pos).mean()),
        "full_decisions": full_pos,
    }
