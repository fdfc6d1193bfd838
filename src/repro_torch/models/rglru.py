"""RG-LRU recurrent block (RecurrentGemma / Griffin), the counterpart of
``repro.models.rglru`` in its cache-less (prefill) form::

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),   i_t = sigmoid(W_i x)

inside the Griffin recurrent block: a linear in-projection to two
branches, a short causal temporal conv (the reference's sum of shifted
products) on the recurrent branch, the RG-LRU (the reference's scan over
time, a loop here, in f32), a gated merge and the out-projection.  Decode
carries ``h`` and the conv tail a layer (``init_rglru_cache``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, settle

Params = dict[str, Any]


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cuda") -> Params:
    d = cfg.d_model
    dr = d  # recurrent width = d_model
    conv_w = torch.randn((cfg.conv_width, dr), generator=gen, device=device) * 0.1
    lam = torch.rand((dr,), generator=gen, device=device) * 3.0 + 1.0
    return {
        "w_x": init_dense(gen, d, dr, dtype, device),  # recurrent branch in-proj
        "w_y": init_dense(gen, d, dr, dtype, device),  # gate branch in-proj
        "conv_w": conv_w.to(dtype),
        "w_a": init_dense(gen, dr, dr, dtype, device),  # recurrence gate
        "w_i": init_dense(gen, dr, dr, dtype, device),  # input gate
        "lam": lam.to(dtype),
        "w_o": init_dense(gen, dr, d, dtype, device),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device="cuda") -> Params:
    """``h`` (B, dr), always f32, and ``conv`` (B, conv_width - 1, dr) in
    ``dtype``: the recurrent branch's last ``conv_width - 1`` inputs."""
    dr = cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype, device=device),
    }


def apply_rglru(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Params | None = None):
    """Without a cache, the reference's cache-less branch (a zero conv
    tail, zero h) -> the block's output (B, S, d).  With a cache
    (``init_rglru_cache``, an added keyword) -> ``(out, cache)``: the conv
    runs over the cached tail and the loop starts from ``cache["h"]``;
    both are updated in place."""
    s = x.shape[1]
    xb = x @ p["w_x"]  # recurrent branch (B, S, dr)
    yb = F.gelu(x @ p["w_y"], approximate="tanh")  # gate branch (jax.nn.gelu's default)

    # short causal conv over time; torch.cat promotes as jnp.concatenate
    if cache is None:
        xc = F.pad(xb, (0, 0, cfg.conv_width - 1, 0))  # (B, cw - 1 + S, dr)
    else:
        xc = torch.cat([cache["conv"], xb], dim=1)
    conv = sum(xc[:, j : j + s] * p["conv_w"][j][None, None] for j in range(cfg.conv_width))

    # RG-LRU; softplus as jax.nn.softplus, logaddexp(x, 0)
    lam = p["lam"].float()
    lam = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-cfg.rglru_c * lam[None, None] * torch.sigmoid((conv @ p["w_a"]).float()))
    gate_in = torch.sigmoid((conv @ p["w_i"]).float())
    drive = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * gate_in * conv.float()

    if cache is None:
        h = torch.zeros((x.shape[0], conv.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        h = cache["h"]
    hs = []
    for t in range(s):
        h = a[:, t] * h + drive[:, t]
        hs.append(h)
    rec = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, dr)
    out = (rec * yb) @ p["w_o"]
    if cache is None:
        return out
    cache["h"].copy_(h)
    settle(cache, "conv", xc[:, -(cfg.conv_width - 1):])
    return out, cache
