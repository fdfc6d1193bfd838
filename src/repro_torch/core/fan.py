"""Fan et al. (2002) 'dynamic scheduling' early-stopping baseline, a numpy
copy of ``repro.core.fan`` (calibration and evaluation are host work in
both packages).

Reimplementation of the paper's Appendix C: for each prefix length r, the
partial score g_r(x) is binned as b_r(x) = floor(g_r(x) / lambda); each bin
stores the empirical mean/std of the *remainder* diff_r(x) = g_r(x) - f(x)
over the calibration set.  At serve time:

    g_r(x) > beta + mu_B + gamma * sigma_B   -> classify positive, stop
    g_r(x) < beta + mu_B - gamma * sigma_B   -> classify negative, stop
    otherwise                                 -> evaluate base model r+1

The paper uses a hash table from bin id -> (mu, sigma); the reference
materializes a *dense* bin array instead, and so does this copy, over
the observed bin range per step (bins are integers in a bounded range once
lambda is fixed).  Out-of-range bins at test time get (mu, sigma) = (0, inf),
i.e. never stop early — exactly Fan et al.'s 'unseen bin -> full evaluation'
fallback.  Empty in-range bins behave the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FanModel", "fit_fan", "evaluate_fan"]

_INF = np.inf


@dataclasses.dataclass
class FanModel:
    order: np.ndarray  # (T,) permutation
    lam: float  # bin width lambda
    gamma: float  # confidence knob
    beta: float
    costs: np.ndarray  # (T,) original order
    bin_lo: np.ndarray  # (T,) int — lowest observed bin per step
    mu: np.ndarray  # (T, n_bins) padded dense bin means
    sigma: np.ndarray  # (T, n_bins) padded dense bin stds (inf = no data)
    n_bins: np.ndarray  # (T,) valid bins per step

    @property
    def T(self) -> int:
        return int(self.order.shape[0])


def fit_fan(
    scores: np.ndarray,
    order: np.ndarray,
    lam: float = 0.01,
    gamma: float = 3.0,
    beta: float = 0.0,
    costs: np.ndarray | None = None,
) -> FanModel:
    """Fit per-(step, bin) remainder statistics on a calibration set."""
    F = np.asarray(scores, dtype=np.float64)
    n, T = F.shape
    order = np.asarray(order)
    c = np.ones(T) if costs is None else np.asarray(costs, dtype=np.float64)
    G = np.cumsum(F[:, order], axis=1)
    full = G[:, -1]
    diffs = G - full[:, None]  # (n, T): g_r - f

    bins = np.floor(G / lam).astype(np.int64)  # (n, T)
    bin_lo = bins.min(axis=0)
    width = (bins.max(axis=0) - bin_lo + 1).astype(np.int64)
    max_w = int(width.max())
    mu = np.zeros((T, max_w))
    sigma = np.full((T, max_w), _INF)
    for r in range(T):
        idx = bins[:, r] - bin_lo[r]
        cnt = np.bincount(idx, minlength=max_w).astype(np.float64)
        s1 = np.bincount(idx, weights=diffs[:, r], minlength=max_w)
        s2 = np.bincount(idx, weights=diffs[:, r] ** 2, minlength=max_w)
        nz = cnt > 0
        m = np.where(nz, s1 / np.maximum(cnt, 1), 0.0)
        var = np.where(nz, s2 / np.maximum(cnt, 1) - m**2, _INF)
        mu[r] = m
        sigma[r] = np.where(nz, np.sqrt(np.maximum(var, 0.0)), _INF)
    return FanModel(
        order=order,
        lam=float(lam),
        gamma=float(gamma),
        beta=float(beta),
        costs=c,
        bin_lo=bin_lo,
        mu=mu,
        sigma=sigma,
        n_bins=width,
    )


def evaluate_fan(model: FanModel, scores: np.ndarray, gamma: float | None = None) -> dict:
    """Run the Fan et al. cascade on a test score matrix (vectorized).

    ``gamma`` may override the fitted knob to sweep the tradeoff curve without
    re-fitting (the statistics are gamma-independent).
    """
    gam = model.gamma if gamma is None else float(gamma)
    F = np.asarray(scores, dtype=np.float64)
    n, T = F.shape
    G = np.cumsum(F[:, model.order], axis=1)
    full_pos = G[:, -1] >= model.beta

    bins = np.floor(G / model.lam).astype(np.int64) - model.bin_lo[None, :]
    in_range = (bins >= 0) & (bins < model.n_bins[None, :])
    safe = np.clip(bins, 0, model.mu.shape[1] - 1)
    steps = np.arange(T)
    mu = model.mu[steps[None, :], safe]
    sig = model.sigma[steps[None, :], safe]
    usable = in_range & np.isfinite(sig)
    hi = np.where(usable, model.beta + mu + gam * sig, _INF)
    lo = np.where(usable, model.beta + mu - gam * sig, -_INF)
    hit_pos = G > hi
    hit_neg = G < lo
    hit = hit_pos | hit_neg
    any_hit = hit.any(axis=1)
    first = np.where(any_hit, np.argmax(hit, axis=1), T - 1)
    exit_step = np.where(any_hit, first + 1, T)
    rows = np.arange(n)
    early_dec = hit_pos[rows, first]
    decisions = np.where(any_hit, early_dec, full_pos)
    cum_cost = np.cumsum(model.costs[model.order])
    return {
        "decisions": decisions,
        "exit_step": exit_step,
        "mean_models": float(exit_step.mean()),
        "mean_cost": float(cum_cost[exit_step - 1].mean()),
        "diff_rate": float((decisions != full_pos).mean()),
        "full_decisions": full_pos,
    }
