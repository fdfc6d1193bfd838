"""QWYC over MoE experts, the counterpart of ``repro.core.moe_qwyc``: the full
joint optimization (Algorithm 1) on an exchangeable neural ensemble.

A routed MoE layer's output for a classification readout is an additive
ensemble over experts:  score(x) = sum_e  w_e(x) * (readout . expert_e(h(x)))
where w_e(x) is the (renormalized) router weight, zero for unrouted experts.
Experts within a layer are exchangeable (evaluation order is free), so
QWYC's joint ordering + thresholds applies verbatim: evaluate experts in
QWYC order, accumulate the weighted contributions, and quit as soon as the
running score crosses a threshold.

This module computes the per-expert contribution matrix from a layer's
weights on ``device`` and hands it to the stock QWYC optimizer (host numpy).
The routing is softmax -> top-k -> renormalise -> scatter into a dense
gate; the experts' products run as one batched matmul over the expert axis
(PyTorch's own matmul: the reference computes them outside any Pallas
kernel), in float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qwyc import QWYCModel, evaluate_cascade, fit_qwyc
from repro_torch.device import resolve_device

__all__ = ["expert_contributions", "fit_moe_qwyc", "report_moe_qwyc"]


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _gate(x: torch.Tensor, router: torch.Tensor, k: int) -> torch.Tensor:
    """(N, E) dense gate: the top-k router probabilities, renormalised to
    sum to one, zero for the unrouted experts."""
    probs = torch.softmax(x @ router, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    return torch.zeros_like(probs).scatter_(1, topi, topw)


def expert_contributions(moe_params: dict, x, readout, cfg, device="cuda") -> torch.Tensor:
    """(N, E) per-expert contribution scores for inputs x (N, d), a float32
    tensor on ``device``.

    contribution_e(x) = w_e(x) * readout . expert_e(x), zero when unrouted;
    expert_e(x) = (silu(x @ wi_e) * (x @ wg_e)) @ wo_e.  ``moe_params``
    holds ``router`` (d, E), ``wi`` / ``wg`` (E, d, f) and ``wo`` (E, f, d)
    (``convert.moe_params_from_numpy``); ``cfg`` is read for ``n_experts``
    and ``top_k`` only.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    p = {k: torch.as_tensor(moe_params[k], device=dev).to(f32) for k in ("router", "wi", "wg", "wo")}
    if p["router"].shape[1] != cfg.n_experts:
        raise ValueError(
            f"router has {p['router'].shape[1]} experts, cfg.n_experts is {cfg.n_experts}"
        )
    x = torch.as_tensor(x, device=dev).to(f32)
    r = torch.as_tensor(readout, device=dev).to(f32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gate = _gate(x, p["router"], int(cfg.top_k))
        # every expert at once: (E, N, f) hidden, (E, N, d) output, (E, N)
        h = torch.nn.functional.silu(torch.matmul(x, p["wi"])) * torch.matmul(x, p["wg"])
        per_expert = torch.matmul(torch.matmul(h, p["wo"]), r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return gate * per_expert.T


def fit_moe_qwyc(contributions, alpha: float = 0.01, beta: float = 0.0) -> QWYCModel:
    """Joint ordering + thresholds over the expert ensemble (Algorithm 1)."""
    return fit_qwyc(_numpy(contributions), beta=beta, alpha=alpha, optimize_order=True)


def report_moe_qwyc(model: QWYCModel, contributions_test) -> dict:
    c = _numpy(contributions_test)
    ev = evaluate_cascade(model, c)
    e = c.shape[1]
    return {
        "mean_experts": ev["mean_models"],
        "full_experts": e,
        "speedup": e / ev["mean_models"],
        "diff_rate": ev["diff_rate"],
        "order": model.order.tolist(),
    }
