"""Ensembles of lattices (interpolated look-up tables) in PyTorch.

The counterpart of ``repro.ensembles.lattice``.  Each base model f_t picks
S of the D features and multilinearly interpolates a 2^S-vertex table over
the unit hypercube.  Training is plain PyTorch autograd with the
reference's AdamW step, on the caller's device; ``joint`` and
``independent`` are the reference's two regimes.

``apply_lattice_scores`` is the one plain evaluator of the port: the
kernels' plain versions (B5, B4's lattice variant) call it, and the CUDA
kernels repeat its arithmetic (``csrc/lattice.cuh``).  It contracts the
(2,)*S table dimension by dimension, feature 0 first, as the reference's
``_interp_one`` does, with the same f32 multiplies and adds, so the scores
are bit-identical to the JAX package's on the CPU.

Parameters (stacked over T, on one device):
{"feats": (T, S) int32, "theta": (T, 2**S) float32}.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import adamw_init, adamw_update

__all__ = [
    "init_lattice_ensemble",
    "lattice_params_from_numpy",
    "apply_lattice_scores",
    "apply_lattice",
    "interpolate",
    "train_lattice_ensemble",
]

# (rows x lattices x 2^(S-1)) partial values of the first halving that one
# pass of apply_lattice_scores holds: lattices are taken in groups below it
_GROUP_ELEMS = 1 << 25


def lattice_params_from_numpy(theta, feats, device="cuda") -> dict:
    """Stacked lattice arrays (numpy, e.g. ``np.asarray`` of the JAX
    package's params) -> the port's params dict on ``device``.

    Validates what the lattice kernels take on trust: (T, S) feature ids,
    non-negative, distinct within a lattice, and (T, 2**S) vertex values.
    """
    dev = resolve_device(device)
    theta = np.array(theta, dtype=np.float32)  # copies: torch takes it writable
    feats = np.array(feats, dtype=np.int32)
    if feats.ndim != 2 or feats.shape[1] < 1:
        raise ValueError(f"feats {feats.shape} must be (T, S) with S >= 1")
    if theta.shape != (feats.shape[0], 1 << feats.shape[1]):
        raise ValueError(
            f"theta {theta.shape} must be (T, 2**S) = "
            f"{(feats.shape[0], 1 << feats.shape[1])}"
        )
    if feats.size and feats.min() < 0:
        raise ValueError("feature ids must be non-negative")
    return {
        "feats": torch.from_numpy(feats).to(dev),
        "theta": torch.from_numpy(theta).to(dev),
    }


def init_lattice_ensemble(
    T: int,
    D: int,
    S: int,
    seed: int = 0,
    feature_subsets: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """The reference's initialisation: the same ``default_rng(seed)`` draws
    (a feature subset per lattice, then N(0, 0.1^2) vertex values)."""
    rng = np.random.default_rng(seed)
    if feature_subsets is None:
        feature_subsets = np.stack(
            [rng.choice(D, size=S, replace=False) for _ in range(T)]
        )
    theta = rng.normal(size=(T, 1 << S)) * 0.1
    return lattice_params_from_numpy(theta, feature_subsets, device=device)


def interpolate(v: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of vertex values ``v`` (..., 2^S) at the
    inputs ``xs`` (..., S) -> (...): S halvings, feature 0 first, each
    ``v_lo * (1 - x_j) + v_hi * x_j`` in separately rounded f32 ops (the
    order of ``csrc/lattice.cuh``).  ``v`` broadcasts against ``xs``'s
    leading dimensions at the first halving."""
    for j in range(xs.shape[-1]):
        h = v.shape[-1] // 2
        xj = xs[..., j : j + 1]
        v = v[..., :h] * (1.0 - xj) + v[..., h:] * xj
    return v[..., 0]


def _contract(theta: torch.Tensor, feats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n, t) scores of the t lattices on the n rows of ``x``."""
    n = x.shape[0]
    t, s = feats.shape
    xs = x[:, feats.reshape(-1).long()].reshape(n, t, s)
    return interpolate(theta, xs)  # theta (t, 2^S) broadcasts over the rows


def apply_lattice_scores(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-lattice scores (N, T), the QWYC ``F`` matrix.

    Lattices are taken a group at a time so that the first halving's
    partial values stay under ``_GROUP_ELEMS``; every score is computed the
    same way whatever the grouping.  Differentiable in ``theta``.
    """
    feats, theta = params["feats"], params["theta"]
    T = feats.shape[0]
    per_lattice = max(1, x.shape[0] * (theta.shape[1] // 2))
    group = max(1, _GROUP_ELEMS // per_lattice)
    if group >= T:
        return _contract(theta, feats, x)
    return torch.cat(
        [
            _contract(theta[t : t + group], feats[t : t + group], x)
            for t in range(0, T, group)
        ],
        dim=1,
    )


def apply_lattice(params: dict, x: torch.Tensor) -> torch.Tensor:
    return apply_lattice_scores(params, x).sum(dim=1)


def _logaddexp0(z: torch.Tensor) -> torch.Tensor:
    """``logaddexp(0, z)`` by the reference's formula:
    ``max(0, z) + log1p(exp(-|z|))``."""
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def _loss_fn(theta, feats, x, y, mode: str) -> torch.Tensor:
    scores = apply_lattice_scores({"feats": feats, "theta": theta}, x)  # (N, T)
    yy = 2.0 * y - 1.0
    if mode == "joint":
        logit = scores.sum(dim=1)
        return torch.mean(_logaddexp0(-yy * logit))
    if mode == "independent":
        # each lattice fits the labels on its own, scaled so that the sum
        # stays in a sane logit range
        T = scores.shape[1]
        return torch.mean(_logaddexp0(-yy[:, None] * scores * T)) / T
    raise ValueError(mode)


def train_lattice_ensemble(
    params: dict,
    x,
    y,
    mode: str = "joint",
    steps: int = 300,
    lr: float = 0.05,
    batch: int = 2048,
    seed: int = 0,
    verbose: bool = False,
) -> dict:
    """Train theta by AdamW on the logistic loss, on the device the params
    lie on.  Minibatches are the reference's: ``default_rng(seed).integers``
    row indices, ``min(batch, N)`` a step.  The reference differentiates
    with JAX; the two backward passes reduce in different orders, so the
    trained theta agrees to a tolerance, not bit for bit."""
    feats = params["feats"]
    dev = feats.device
    x, y = (torch.as_tensor(a).to(device=dev, dtype=torch.float32) for a in (x, y))
    theta = params["theta"].detach().clone()
    opt = adamw_init(theta)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=min(batch, n))).to(dev)
        th = theta.requires_grad_(True)
        (g,) = torch.autograd.grad(_loss_fn(th, feats, x[idx], y[idx], mode), th)
        theta, opt = adamw_update(theta.detach(), g, opt, lr=lr)
        if verbose and (i + 1) % 100 == 0:
            with torch.no_grad():
                loss = _loss_fn(theta, feats, x, y, mode)
            print(f"[lattice-{mode}] step {i+1}/{steps} loss={float(loss):.4f}")
    return {"feats": feats, "theta": theta.detach()}
