"""Pre-selected base-model orderings (paper Appendix B), a numpy copy of
``repro.core.orderings``.

All functions return a permutation ``order`` with ``order[r]`` = original
index of the base model evaluated r-th.  These combine with
``fit_thresholds_for_order`` (Algorithm 2) or with the Fan et al. early
stopping mechanism (``core/fan.py``) to reproduce the paper's baselines.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gbt_order",
    "random_order",
    "individual_mse_order",
    "greedy_mse_order",
]


def gbt_order(T: int) -> np.ndarray:
    """The natural training order of a sequentially-trained (boosted) ensemble."""
    return np.arange(T)


def random_order(T: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(T)


def individual_mse_order(scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Order by each base model's individual MSE against the labels, ascending.

    ``labels`` are +-1 (or {0,1}, remapped).  Used by Fan et al. (2002) as the
    'total benefits' ordering.  Requires labeled calibration data — one of the
    practical disadvantages vs QWYC* the paper points out.
    """
    y = np.asarray(labels, dtype=np.float64)
    if set(np.unique(y)) <= {0.0, 1.0}:
        y = 2.0 * y - 1.0
    mse = ((np.asarray(scores) - y[:, None]) ** 2).mean(axis=0)
    return np.argsort(mse, kind="stable")


def greedy_mse_order(scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Greedily grow the partial ensemble minimizing partial-sum MSE.

    First pick the best individual model by MSE, then repeatedly add the base
    model minimizing the MSE of the running sum (Appendix B, 'Greedy MSE').
    Vectorized: each round evaluates all remaining candidates at once.
    """
    F = np.asarray(scores, dtype=np.float64)
    y = np.asarray(labels, dtype=np.float64)
    if set(np.unique(y)) <= {0.0, 1.0}:
        y = 2.0 * y - 1.0
    n, T = F.shape
    remaining = list(range(T))
    order = []
    g = np.zeros(n)
    for _ in range(T):
        cand = np.asarray(remaining)
        # mse of (g + F[:, c] - y) for each candidate c, in one shot
        resid = g[:, None] + F[:, cand] - y[:, None]
        mse = (resid**2).mean(axis=0)
        k = int(np.argmin(mse))
        t = remaining.pop(k)
        order.append(t)
        g = g + F[:, t]
    return np.asarray(order)
