"""Mixture-of-Experts FFN with capacity-slot scatter dispatch, the
counterpart of ``repro.models.moe``.

Routing is top-k over the softmax of an f32 router, the k weights
renormalised.  Dispatch packs each (token, routing slot) assignment into
its expert's queue of ``capacity`` slots with k scatters; an assignment
whose place in the queue is at or past the capacity goes to one overflow
slot, which is dropped.  The experts run as batched matmuls over the
expert axis, and the k gathers combine their outputs.  Shared experts
(DeepSeek) are a dense FFN applied to every token.

The tokens of one call are coupled: the capacity follows the call's token
count, ``int(capacity_factor * n * k / e)``, and a token's place in an
expert's queue counts every assignment ahead of it, token-major over
``(n, k)``.  So a row's output depends on the rows that share its call,
and callers keep the reference's call shapes (``core.early_exit``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, init_dense, init_mlp

Params = dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> Params:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    p: Params = {
        "router": init_dense(gen, d, e, torch.float32, device),  # f32 router
        "wi": normal((e, d, f), 1.0 / math.sqrt(d)),
        "wg": normal((e, d, f), 1.0 / math.sqrt(d)),
        "wo": normal((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts,
                               dtype=dtype, device=device)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices, in
    descending order, ties to the lowest index (``lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(topi: torch.Tensor, e: int) -> torch.Tensor:
    """(e,) int64 assignments to each expert (``bincount`` without its
    read-back of the largest id, so a captured loop can run it)."""
    flat = topi.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """The routing of one call's tokens ``xt`` (n, d) -> ``(probs, topw,
    topi, pos, capacity)``: the (n, e) router probabilities, the (n, k)
    renormalised weights and expert ids, and each assignment's place in its
    expert's queue (token-major over ``(n, k)``); ``pos < capacity`` is kept."""
    n = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)  # (n, e)
    topw, topi = top_k(probs, k)  # (n, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    capacity = max(1, int(cfg.capacity_factor * n * k / e))
    # the place of each assignment in its expert's queue: its rank among
    # the same expert's assignments in token-major order (the reference's
    # one-hot cumsum), from a stable sort of the flat expert ids
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = expert_counts(topi, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat.numel(), device=xt.device) - starts[flat[order]]
    pos = torch.empty_like(flat).index_copy_(0, order, rank).reshape(n, k)
    return probs, topw, topi, pos, capacity


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), all B * S tokens in one call."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    xt = x.reshape(n, d)
    probs, topw, topi, pos, capacity = route(p["router"], xt, cfg)
    keep = pos < capacity
    # slot id in the flat (e * capacity + 1 overflow) buffer
    slot = torch.where(keep, topi * capacity + pos, e * capacity)

    buf = x.new_zeros((e * capacity + 1, d))
    for j in range(k):  # k scatters; only the overflow slot repeats
        buf.index_copy_(0, slot[:, j], xt)
    expert_in = buf[: e * capacity].view(e, capacity, d)
    h = torch.bmm(expert_in, p["wi"])
    g = torch.bmm(expert_in, p["wg"])
    if torch.is_grad_enabled() and (x.requires_grad or p["wi"].requires_grad):
        # under autograd: the same values out of place (the experts'
        # outputs and a zero overflow row)
        y = torch.bmm(F.silu(h) * g, p["wo"]).reshape(e * capacity, d)
        buf = torch.cat([y, y.new_zeros((1, d))])
    else:
        h = F.silu(h).mul_(g)
        del g
        # the experts' outputs overwrite their inputs, and the overflow
        # slot reads zero (the reference's concatenated zero row)
        torch.bmm(h, p["wo"], out=expert_in)
        del h
        buf[e * capacity].zero_()

    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for j in range(k):  # k gathers
        w_j = (topw[:, j] * keep[:, j]).to(x.dtype)
        out = out + w_j[:, None] * buf[slot[:, j]]
    out = out.reshape(b, s, d)

    # switch-style load-balance aux loss; a token's k experts are distinct,
    # so the share of tokens routed to each expert is its count over n
    me = probs.mean(0)
    ce = expert_counts(topi, e).float() / n
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out, aux
