"""Carry fitted objects across from the JAX package.

Every function takes numpy arrays (``np.asarray`` of the JAX objects'
fields), so this module imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan
from repro_torch.core.qwyc import QWYCModel
from repro_torch.ensembles.gbt import gbt_params_from_numpy
from repro_torch.ensembles.lattice import lattice_params_from_numpy
from repro_torch.kernels.megakernel import PAYLOAD_DTYPES, QUANTS, ParamSlabs
from repro_torch.optim.adamw import AdamWState
from repro_torch.ranking.plan import GroupedPlan

__all__ = [
    "adamw_state_from_numpy",
    "cache_from_numpy",
    "gbt_params_from_numpy",
    "grouped_plan_from_numpy",
    "lattice_params_from_numpy",
    "moe_params_from_numpy",
    "param_slabs_from_numpy",
    "qwyc_model_from_numpy",
    "transformer_params_from_numpy",
]


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



def grouped_plan_from_numpy(
    model: QWYCModel,
    eps_g,
    k: int,
    buckets,
    chunk_t: int,
    train_exit_stage=None,
    train_disagreement: float = 0.0,
) -> GroupedPlan:
    """A fitted grouped (ranking) cascade -> the port's ``GroupedPlan``.

    ``model`` is the port's ``QWYCModel`` of the grouped fit (see
    ``qwyc_model_from_numpy``); ``eps_g`` (S,) the per-stage margin
    thresholds for the stages that ``chunk_t`` cuts, ``k`` the ranking
    depth, ``buckets`` the admission pad widths.
    """
    plan = CascadePlan.from_qwyc(model, chunk_t=chunk_t)
    eps_g = np.asarray(eps_g, dtype=np.float32)
    if eps_g.shape != (len(plan.stages),):
        raise ValueError(
            f"eps_g has shape {eps_g.shape}, expected ({len(plan.stages)},) "
            f"stages at chunk_t={chunk_t}"
        )
    return GroupedPlan(
        plan=plan,
        model=model,
        eps_g=eps_g,
        k=int(k),
        buckets=tuple(int(b) for b in buckets),
        train_exit_stage=(
            None if train_exit_stage is None else np.asarray(train_exit_stage, np.int64)
        ),
        train_disagreement=float(train_disagreement),
    )


def param_slabs_from_numpy(
    variant: str, quant: str, data: dict, scale, eps_position, W: int, S: int,
    device="cuda",
) -> ParamSlabs:
    """Tree or lattice ``ParamSlabs`` of the JAX package -> the port's.

    ``data`` holds the stacked slab arrays as numpy: ``feats`` and
    ``payload`` (trees also ``thrs``), each (S, W, ...).  A bf16 payload
    crosses as its f32 view (``np.asarray(p, np.float32)``) and is cast
    back here, which is exact.  ``scale`` is the (S, 1) per-stage scale,
    ``eps_position`` the (T,) per-position error.  Matrix slabs carry no
    parameters: build them from the plan (``build_matrix_slabs``).
    """
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    names = {"tree": ("feats", "thrs", "payload"), "lattice": ("feats", "payload")}
    if variant not in names:
        raise ValueError(f"param_slabs_from_numpy takes tree or lattice slabs, got {variant!r}")
    if set(data) != set(names[variant]):
        raise ValueError(f"{variant} slabs hold {names[variant]}, got {sorted(data)}")
    dtypes = {"feats": torch.int32, "thrs": torch.float32, "payload": PAYLOAD_DTYPES[quant]}
    out = {}
    for name in names[variant]:
        a = np.asarray(data[name])
        if a.shape[:2] != (S, W):
            raise ValueError(f"{name} has shape {a.shape}, expected ({S}, {W}, ...)")
        src = a.astype(np.float32) if dtypes[name] == torch.bfloat16 else a
        out[name] = torch.from_numpy(np.array(src)).to(dtypes[name]).to(device)
    scale = np.array(scale, dtype=np.float32).reshape(S, 1)
    return ParamSlabs(
        variant=variant, quant=quant, data=out,
        scale=torch.from_numpy(scale).to(device),
        eps_position=np.asarray(eps_position, dtype=np.float64), W=int(W), S=int(S),
    )


def moe_params_from_numpy(router, wi, wg, wo, device="cuda") -> dict:
    """A routed MoE layer's weights -> the float32 tensors
    ``core.moe_qwyc.expert_contributions`` takes: ``router`` (d, E), ``wi``
    and ``wg`` (E, d, f), ``wo`` (E, f, d), on ``device``."""
    out = {}
    for name, a in (("router", router), ("wi", wi), ("wg", wg), ("wo", wo)):
        out[name] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    E, d = out["router"].shape[1], out["router"].shape[0]
    f = out["wi"].shape[2]
    want = {"wi": (E, d, f), "wg": (E, d, f), "wo": (E, f, d)}
    for name, shape in want.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(out[name].shape)}, expected {shape}")
    return out


def transformer_params_from_numpy(params: dict, device="cuda") -> dict:
    """The reference's transformer params (``repro.models.transformer.
    init_params``, its leaves as numpy arrays) -> the port's param dict on
    ``device``, leaf for leaf: the ``(d_in, d_out)`` layout, the leading-L
    stacked ``layers``, the ``pre_layers`` and ``loop_layers`` lists, the
    ``attn`` / ``mix`` / ``moe`` / ``mlp`` leaves and the ``exit_heads``
    kept, so both packages compute the same products."""

    def leaf(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            raise ValueError(f"expected float params, got {a.dtype}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return leaf(tree)

    return walk(params)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """One leaf in its own dtype; a bf16 leaf (ml_dtypes' ``bfloat16``,
    which numpy reads as an opaque 2-byte type) through its ``uint16``
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device) for v in tree]
    return _tensor_from_numpy(tree, device)


def cache_from_numpy(cache: dict, device="cuda") -> dict:
    """The reference's decode cache (``repro.models.transformer.
    init_cache`` or a step's returned cache, its leaves as numpy) -> the
    port's, leaf for leaf in the same layout and dtypes: int32 ``pos``,
    f32 recurrent state, K/V, latents and ``last_x`` in their own dtype
    (bf16 included)."""
    return _tree_from_numpy(cache, device)


def adamw_state_from_numpy(step, mu, nu, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` fields (the int32 step, the ``mu``
    and ``nu`` trees, as numpy) -> the port's, dtypes kept."""
    return AdamWState(
        step=_tensor_from_numpy(np.asarray(step, dtype=np.int32), device),
        mu=_tree_from_numpy(mu, device),
        nu=_tree_from_numpy(nu, device),
    )
