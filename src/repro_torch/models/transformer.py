"""The decoder backbone for uniform stacks, the counterpart of
``repro.models.transformer``.

The port builds the reference's uniform dense GQA stack: every layer of
kind ``G`` (global) or ``L`` (local sliding window) with a dense FFN.
Layer params carry a leading L axis (the reference's scan-stacked layout),
and ``forward`` walks them with a Python loop, reading layer ``i`` as
``layer_params(params["layers"], i)``.  With ``cfg.exit_interval`` set,
``init_params`` adds the (n_exits, d_model) ``exit_heads``.

MLA, MoE, RWKV6, RG-LRU, ``first_dense_layers`` and the non-uniform
(hybrid) loop raise a ``ValueError`` naming ROADMAP A13: they come with
its second part, with the decode caches.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]

_A13_TODO = "is not ported yet (ROADMAP A13, second part); the port builds uniform dense GQA stacks"


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a stack the port builds: uniform G/L layers,
    dense GQA attention, a dense FFN on every layer."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {"G", "L"}:
        what = "a non-uniform (hybrid) stack" if not cfg.uniform else f"layer kinds {sorted(kinds)}"
        raise ValueError(f"{cfg.name}: {what} {_A13_TODO}")
    for field, what in (
        ("kv_lora_rank", "MLA attention"),
        ("n_experts", "a MoE FFN"),
        ("first_dense_layers", "first_dense_layers"),
    ):
        if getattr(cfg, field):
            raise ValueError(f"{cfg.name}: {what} {_A13_TODO}")


# -- per-layer block -----------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cuda") -> Params:
    """One G/L block with a dense FFN (G and L differ only by their window)."""
    check_supported(cfg)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": L.init_attn(gen, cfg, dtype, device),
        "mlp": L.init_mlp(gen, cfg, dtype=dtype, device=device),
    }


def _apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 window: int) -> torch.Tensor:
    """One pre-norm G/L block -> the new residual stream (the reference's
    first output; its cache and MoE aux loss come with A13's second part)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix_out, _ = L.apply_attn(p["attn"], h, cfg, positions, window)
    x = x + mix_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, cfg)


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the leading-L stacked layer params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


# -- windows: per-layer attention window values --------------------------------


def layer_windows(cfg: ModelConfig, serve: bool = False) -> list[int]:
    """Effective per-layer window (0 = full attention)."""
    ws = []
    for kind in cfg.layer_kinds():
        if kind == "L":
            w = cfg.sliding_window or 4096
        elif kind == "G":
            w = 0
        else:
            w = 0
        if serve and cfg.serve_window_override and kind in ("G", "L"):
            w = min(w, cfg.serve_window_override) if w else cfg.serve_window_override
        ws.append(w)
    return ws


# -- init -----------------------------------------------------------------------


def _stack(blocks: list[Params]) -> Params:
    return {
        k: _stack([b[k] for b in blocks]) if isinstance(v, dict) else torch.stack([b[k] for b in blocks])
        for k, v in blocks[0].items()
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                device="cuda") -> Params:
    """Random params in the reference's layout and scales (``1/sqrt(d_in)``
    dense layers, ``0.02`` embedding and exit heads, ones for the norms),
    drawn in order from ``gen`` on ``device``: the embedding, each layer,
    then the exit heads.  Not bit-equal to ``jax.random``: parity tests
    carry the reference's weights across instead."""
    check_supported(cfg)
    params: Params = {
        "embed": L.init_embed(gen, cfg, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "layers": _stack([_init_block(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]),
    }
    if cfg.exit_interval:
        n_exits = cfg.n_layers // cfg.exit_interval
        heads = torch.randn((n_exits, cfg.d_model), generator=gen, device=device)
        params["exit_heads"] = (heads * 0.02).to(dtype)
    return params


# -- forward --------------------------------------------------------------------


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor,  # (S,) absolute positions
    collect_hidden: bool = False,
):
    """-> logits (B, S, vocab), or ``(logits, hidden)`` with
    ``collect_hidden``: hidden (L, B, S, d) is every layer's output
    residual stream.  The cache-less (prefill) form."""
    check_supported(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    windows = layer_windows(cfg)
    hidden = []
    for i in range(cfg.n_layers):
        x = _apply_block(layer_params(params["layers"], i), x, cfg, positions, windows[i])
        if collect_hidden:
            hidden.append(x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    if collect_hidden:
        return logits, torch.stack(hidden)
    return logits
