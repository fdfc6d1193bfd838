"""Synthetic dataset generators mimicking the paper's four datasets.

The container is offline, so the UCI Adult / Nomao datasets and the two
proprietary real-world datasets are unavailable.  We substitute generators
matched on the published statistics that matter to QWYC's behaviour:

  * adult-like:  D=14 mixed-ish features, ~24% positive rate, moderately
    separable with a hard boundary region (many 'easy negative' examples).
  * nomao-like:  D=8 strong features, near-balanced, high separability
    (dedup problems have many obvious matches/non-matches).
  * rw1-like:    D=16, heavy negative prior (p(neg)=0.95) — the paper's
    Filter-and-Score case 1 (T=5 lattices).
  * rw2-like:    D=30, roughly equal class priors, features of wildly varying
    usefulness (paper: '500 random feature subsets ... some base models much
    more useful than others') — Filter-and-Score case 2 (T=500 lattices).

Each returns float32 features in [0, 1] (lattice-friendly) and {0,1} labels.
A verbatim numpy copy of ``repro.data.synthetic``: the same seed gives the
same arrays in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Dataset", "make_dataset", "DATASETS"]


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def D(self) -> int:
        return int(self.x_train.shape[1])


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _squash(x):
    """Map unbounded features to [0, 1] per-column by rank-preserving CDF."""
    return _sigmoid((x - x.mean(0)) / (x.std(0) + 1e-9))


def _nonlinear_logit(x, rng, hardness: float, n_terms: int = 12):
    """Random smooth nonlinear decision function over the features."""
    d = x.shape[1]
    w = rng.normal(size=(n_terms, d)) / np.sqrt(d)
    b = rng.normal(size=n_terms)
    amp = rng.normal(size=n_terms)
    h = np.tanh(x @ w.T + b) @ amp
    pair = np.zeros(x.shape[0])
    for _ in range(min(6, d)):
        i, j = rng.integers(0, d, size=2)
        pair += rng.normal() * x[:, i] * x[:, j]
    z = h + pair
    z = (z - z.mean()) / (z.std() + 1e-9)
    return z / max(hardness, 1e-3)


def _make(
    name: str,
    n_train: int,
    n_test: int,
    d: int,
    pos_rate: float,
    hardness: float,
    label_noise: float,
    seed: int,
) -> Dataset:
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    # correlated feature base (mixture of 3 clusters, like demographic data)
    centers = rng.normal(size=(3, d))
    comp = rng.integers(0, 3, size=n)
    x = centers[comp] + rng.normal(size=(n, d)) * rng.uniform(0.5, 1.5, size=d)
    z = _nonlinear_logit(x, rng, hardness)
    thr = np.quantile(z, 1.0 - pos_rate)
    p = _sigmoid((z - thr) / max(hardness, 1e-3) * 2.0)
    y = (rng.uniform(size=n) < p).astype(np.int64)
    flip = rng.uniform(size=n) < label_noise
    y = np.where(flip, 1 - y, y)
    x = _squash(x).astype(np.float32)
    return Dataset(
        name=name,
        x_train=x[:n_train],
        y_train=y[:n_train],
        x_test=x[n_train:],
        y_test=y[n_train:],
    )


DATASETS = {
    # name: (n_train, n_test, d, pos_rate, hardness, label_noise)
    "adult": (8000, 2000, 14, 0.24, 0.6, 0.05),
    "nomao": (8000, 2000, 8, 0.50, 0.35, 0.02),
    "rw1": (12000, 3000, 16, 0.05, 0.5, 0.03),
    "rw2": (8000, 2000, 30, 0.50, 0.8, 0.05),
}


def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> Dataset:
    """Build one of the paper-analogue datasets.  ``scale`` shrinks sizes for
    tests (e.g. scale=0.1 for smoke tests)."""
    n_train, n_test, d, pos, hard, noise = DATASETS[name]
    return _make(
        name,
        max(64, int(n_train * scale)),
        max(64, int(n_test * scale)),
        d,
        pos,
        hard,
        noise,
        seed,
    )
