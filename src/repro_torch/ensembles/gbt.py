"""Gradient-boosted oblivious trees, trained on host, evaluated in PyTorch.

The counterpart of ``repro.ensembles.gbt``: ``train_gbt`` is a numpy copy
of the reference trainer (the same seed gives the same trees), and the
evaluation functions run on tensors.  Oblivious trees use one (feature,
threshold) pair per level, shared across the level, so a tree evaluates as
a ``depth``-bit leaf index followed by a table read (kernel B3,
``kernels/tree_kernel.py``).

Parameters (stacked over T trees, on one device):
    feats:  (T, depth) int32   feature id per level
    thrs:   (T, depth) float32 threshold per level
    leaves: (T, 2**depth) float32 leaf values (already scaled by learning rate)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "GBTParams",
    "train_gbt",
    "apply_gbt",
    "apply_gbt_scores",
    "gbt_params_from_numpy",
]


@dataclasses.dataclass
class GBTParams:
    feats: torch.Tensor
    thrs: torch.Tensor
    leaves: torch.Tensor
    base_score: float  # prior logit added to the full sum

    @property
    def T(self) -> int:
        return int(self.feats.shape[0])

    @property
    def depth(self) -> int:
        return int(self.feats.shape[1])

    @property
    def device(self) -> torch.device:
        return self.feats.device

    def stacked(self) -> dict:
        return {"feats": self.feats, "thrs": self.thrs, "leaves": self.leaves}


def gbt_params_from_numpy(feats, thrs, leaves, base_score, device="cuda") -> GBTParams:
    """Stacked forest arrays (numpy, e.g. ``np.asarray`` of the JAX
    package's ``GBTParams`` fields) -> ``GBTParams`` on ``device``.

    Validates what the tree kernels take on trust: (T, depth) feature ids
    and thresholds, (T, 2**depth) leaves, and non-negative feature ids.
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    feats = np.asarray(feats, dtype=np.int32)
    thrs = np.asarray(thrs, dtype=np.float32)
    leaves = np.asarray(leaves, dtype=np.float32)
    if feats.ndim != 2 or thrs.shape != feats.shape:
        raise ValueError(f"feats {feats.shape} / thrs {thrs.shape} must both be (T, depth)")
    if leaves.shape != (feats.shape[0], 1 << feats.shape[1]):
        raise ValueError(
            f"leaves {leaves.shape} must be (T, 2**depth) = "
            f"{(feats.shape[0], 1 << feats.shape[1])}"
        )
    if feats.size and feats.min() < 0:
        raise ValueError("feature ids must be non-negative")
    return GBTParams(
        feats=torch.from_numpy(feats).to(dev),
        thrs=torch.from_numpy(thrs).to(dev),
        leaves=torch.from_numpy(leaves).to(dev),
        base_score=float(base_score),
    )


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _fit_oblivious_tree(
    x: np.ndarray,
    grad: np.ndarray,
    hess: np.ndarray,
    bins: np.ndarray,
    edges: np.ndarray,
    depth: int,
    l2: float,
    rng: np.random.Generator,
    feature_subsample: float = 1.0,
):
    """One oblivious tree via greedy level-wise search on binned features.

    bins:  (N, D) int16 — precomputed quantile bin of each feature value.
    edges: (D, B) float — bin upper edges (threshold candidates).
    """
    n, d = bins.shape
    b = edges.shape[1]
    leaf = np.zeros(n, dtype=np.int64)
    feats, thrs = [], []
    active_feats = np.arange(d)
    if feature_subsample < 1.0:
        k = max(1, int(round(d * feature_subsample)))
        active_feats = rng.choice(d, size=k, replace=False)
    for lev in range(depth):
        n_leaf = 1 << lev
        best = (-np.inf, 0, 0)  # (gain, feat, bin_k)
        for f in active_feats:
            # joint (leaf, bin) histogram of grad & hess in one bincount pass
            idx = leaf * b + bins[:, f]
            cnt_g = np.bincount(idx, weights=grad, minlength=n_leaf * b).reshape(n_leaf, b)
            cnt_h = np.bincount(idx, weights=hess, minlength=n_leaf * b).reshape(n_leaf, b)
            gl = np.cumsum(cnt_g, axis=1)  # left stats for threshold k = bins <= k
            hl = np.cumsum(cnt_h, axis=1)
            gt = gl[:, -1:]
            ht = hl[:, -1:]
            gr = gt - gl
            hr = ht - hl
            gain_k = (gl**2 / (hl + l2) + gr**2 / (hr + l2)).sum(axis=0)  # (B,)
            k = int(np.argmax(gain_k[:-1]))  # last bin = no split
            if gain_k[k] > best[0]:
                best = (float(gain_k[k]), int(f), k)
        _, f, k = best
        feats.append(f)
        thrs.append(float(edges[f, k]))
        leaf = 2 * leaf + (bins[:, f] > k)
    # Newton leaf values
    n_leaves = 1 << depth
    gs = np.bincount(leaf, weights=grad, minlength=n_leaves)
    hs = np.bincount(leaf, weights=hess, minlength=n_leaves)
    values = gs / (hs + l2)
    return np.asarray(feats), np.asarray(thrs), values


def train_gbt(
    x: np.ndarray,
    y: np.ndarray,
    n_trees: int = 500,
    depth: int = 5,
    lr: float = 0.1,
    n_bins: int = 32,
    l2: float = 1.0,
    feature_subsample: float = 1.0,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
) -> GBTParams:
    """Boosted logistic-loss training (residual = y - p, Newton leaves).

    Training is host numpy, as in the reference; the stacked parameters
    are handed to ``device`` at the end."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    # quantile bin edges per feature
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T  # (D, B-1)
    edges = np.concatenate([edges, x.max(0)[:, None] + 1.0], axis=1)  # (D, B)
    bins = np.empty((n, d), dtype=np.int16)
    for f in range(d):
        bins[:, f] = np.searchsorted(edges[f], x[:, f], side="left")
    bins = np.minimum(bins, n_bins - 1)

    p0 = np.clip(y.mean(), 1e-6, 1 - 1e-6)
    base = float(np.log(p0 / (1 - p0)))
    s = np.full(n, base)
    feats = np.zeros((n_trees, depth), dtype=np.int32)
    thrs = np.zeros((n_trees, depth), dtype=np.float32)
    leaves = np.zeros((n_trees, 1 << depth), dtype=np.float32)
    for t in range(n_trees):
        p = _sigmoid(s)
        grad = y - p
        hess = np.maximum(p * (1 - p), 1e-6)
        f_t, thr_t, val_t = _fit_oblivious_tree(
            x, grad, hess, bins, edges, depth, l2, rng, feature_subsample
        )
        feats[t], thrs[t] = f_t, thr_t
        leaves[t] = lr * val_t
        # update scores: evaluate the new tree on the binned data
        leaf = np.zeros(n, dtype=np.int64)
        for j in range(depth):
            leaf = 2 * leaf + (x[:, f_t[j]] > thr_t[j])
        s = s + leaves[t][leaf]
        if verbose and (t + 1) % 50 == 0:
            loss = -(y * np.log(_sigmoid(s)) + (1 - y) * np.log(1 - _sigmoid(s))).mean()
            acc = ((s >= 0) == (y > 0.5)).mean()
            print(f"[gbt] tree {t+1}/{n_trees} loss={loss:.4f} acc={acc:.4f}")
    return gbt_params_from_numpy(feats, thrs, leaves, base, device=device)


def apply_gbt_scores(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-tree scores (N, T) — the QWYC ``F`` matrix.  Plain tensor ops
    (the oracle for the tree kernel); the same compares at the same dtype
    and the same leaf as the reference's jnp version."""
    feats, thrs, leaves = params["feats"], params["thrs"], params["leaves"]
    n = x.shape[0]
    xg = x[:, feats.reshape(-1).long()].reshape(n, *feats.shape)  # (N, T, depth)
    bits = (xg > thrs[None]).to(torch.int32)
    idx = torch.zeros(n, feats.shape[0], dtype=torch.int32, device=x.device)
    for k in range(feats.shape[1]):
        idx = 2 * idx + bits[:, :, k]  # MSB-first, matches training layout
    t = torch.arange(feats.shape[0], device=x.device)
    return leaves[t[None, :], idx.long()]


def apply_gbt(params: dict, x: torch.Tensor, base_score: float = 0.0) -> torch.Tensor:
    """Full-ensemble logit f(x)."""
    return apply_gbt_scores(params, x).sum(dim=1) + base_score
