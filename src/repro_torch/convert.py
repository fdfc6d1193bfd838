"""Carry fitted objects across from the JAX package.

Every function takes numpy arrays (``np.asarray`` of the JAX objects'
fields), so this module imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.qwyc import QWYCModel
from repro_torch.ensembles.gbt import gbt_params_from_numpy
from repro_torch.ensembles.lattice import lattice_params_from_numpy

__all__ = ["gbt_params_from_numpy", "lattice_params_from_numpy", "qwyc_model_from_numpy"]


def qwyc_model_from_numpy(
    order, eps_pos, eps_neg, beta, costs, alpha, mode
) -> QWYCModel:
    """A fitted cascade -> the port's ``QWYCModel``.

    The model is calibration-time host data in both packages (numpy, f64
    thresholds); the executors lower it onto their device when they build
    their ``DevicePlan``.
    """
    order = np.asarray(order, dtype=np.int64)
    T = order.shape[0]
    if sorted(order.tolist()) != list(range(T)):
        raise ValueError("order must be a permutation of range(T)")
    arrays = {
        "eps_pos": np.asarray(eps_pos, dtype=np.float64),
        "eps_neg": np.asarray(eps_neg, dtype=np.float64),
        "costs": np.asarray(costs, dtype=np.float64),
    }
    for name, a in arrays.items():
        if a.shape != (T,):
            raise ValueError(f"{name} has shape {a.shape}, expected ({T},)")
    if mode not in ("both", "neg_only"):
        raise ValueError(f"mode must be 'both' or 'neg_only', got {mode!r}")
    return QWYCModel(
        order=order, beta=float(beta), alpha=float(alpha), mode=mode, **arrays
    )

