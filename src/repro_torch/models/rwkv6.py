"""RWKV6 ("Finch") time-mix block, attention-free token mixing: the
counterpart of ``repro.models.rwkv6`` in its cache-less (prefill) form.

The v6 recurrence with data-dependent decay, per head (hd x hd state)::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with data-dependent token-shift interpolation (ddlerp through a small
LoRA) for the r/k/v/w/g projections, per-channel decay
w_t = exp(-exp(ww_t)), and a gated output.  The reference's ``lax.scan``
over time is a loop over time here, the state in f32.  Decode carries
the state and the last input token a layer (``init_rwkv_cache``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, rms_norm, settle

Params = dict[str, Any]

LORA_R = 32


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
              device="cuda") -> Params:
    d = cfg.d_model
    h = cfg.rnn_heads or cfg.n_heads
    hd = d // h

    def draw(shape, fn=torch.randn):
        return fn(shape, generator=gen, device=device, dtype=torch.float32)

    return {
        "wr": init_dense(gen, d, d, dtype, device),
        "wk": init_dense(gen, d, d, dtype, device),
        "wv": init_dense(gen, d, d, dtype, device),
        "wg": init_dense(gen, d, d, dtype, device),
        "wo": init_dense(gen, d, d, dtype, device),
        # base token-shift mix coefficients per channel for r/k/v/w/g
        "mu": (draw((5, d), torch.rand) * 0.5 + 0.25).to(dtype),
        # ddlerp LoRA: delta-mix from the shifted input
        "mix_a": init_dense(gen, d, LORA_R * 5, dtype, device),
        "mix_b": (draw((5, LORA_R, d)) * 0.01).to(dtype),
        # decay: base per-channel + data-dependent LoRA
        "w_base": (draw((d,)) * 0.5 - 5.0).to(dtype),
        "w_a": init_dense(gen, d, 64, dtype, device),
        "w_b": (draw((64, d)) * 0.01).to(dtype),
        "u": (draw((h, hd)) * 0.1).to(dtype),  # bonus
        "ln_x": torch.ones((d,), dtype=dtype, device=device),
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device="cuda") -> Params:
    """``state`` (B, H, hd, hd), always f32, and ``last_x`` (B, d) in
    ``dtype``: the block's input before the chunk (zeros: none yet)."""
    d = cfg.d_model
    h = cfg.rnn_heads or cfg.n_heads
    hd = d // h
    return {
        "state": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "last_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _projections(p: Params, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """ddlerp token-shift + r/k/v/w/g projections.  x, x_prev: (B, S, d)."""
    delta = x_prev - x
    # data-dependent mix offsets (5 lanes via one fused LoRA)
    lora = torch.tanh(x @ p["mix_a"]).reshape(*x.shape[:-1], 5, LORA_R)
    dd = torch.einsum("bslr,lrd->bsld", lora, p["mix_b"])  # (B, S, 5, d)
    mix = p["mu"][None, None] + dd
    xs = x[:, :, None, :] + delta[:, :, None, :] * mix  # (B, S, 5, d)
    xr, xk, xv, xw, xg = xs.unbind(2)
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    ww = p["w_base"][None, None] + torch.tanh(xw @ p["w_a"]) @ p["w_b"]
    w = torch.exp(-torch.exp(ww.float()))  # (B, S, d) decay in (0, 1)
    return r, k, v, g, w


def apply_rwkv(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Params | None = None):
    """Without a cache, the reference's cache-less branch (zero state, a
    zero token before the first) -> the block's output (B, S, d).  With a
    cache (``init_rwkv_cache``, an added keyword) -> ``(out, cache)``: the
    shifted input's first token is ``cache["last_x"]``, the loop starts
    from ``cache["state"]``, and both are updated in place."""
    b, s, d = x.shape
    h = cfg.rnn_heads or cfg.n_heads
    hd = d // h
    if cache is None:
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    else:
        # torch.cat promotes mixed dtypes as jnp.concatenate does
        x_prev = torch.cat([cache["last_x"][:, None], x[:, :-1]], dim=1)
        state = cache["state"]
    r, k, v, g, w = _projections(p, x, x_prev, cfg)
    rh, kh, vh, wh = (a.reshape(b, s, h, hd).float() for a in (r, k, v, w))
    u = p["u"].float()[None, :, :, None]
    outs = []
    for t in range(s):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]  # (B, H, hd, hd)
        outs.append((rh[:, t, :, None, :] @ (state + u * kv))[:, :, 0])
        state = wh[:, t, :, :, None] * state + kv
    out = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    out = rms_norm(out, p["ln_x"], cfg.norm_eps) * g
    out = out @ p["wo"]
    if cache is None:
        return out
    cache["state"].copy_(state)
    settle(cache, "last_x", x[:, -1])
    return out, cache
