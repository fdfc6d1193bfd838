"""The decoder backbone over every model family of the reference, the
counterpart of ``repro.models.transformer`` in its cache-less (prefill)
form.

Layer stacking follows the reference's:

* uniform configs (dense GQA with local/global alternation, MLA, MoE,
  RWKV6, the audio and vision backbones) carry their layer params with a
  leading L axis (the reference's scan-stacked layout) and run one code
  path, the kind of the first stacked layer; the window is a per-layer
  value;
* ``first_dense_layers`` (DeepSeek: layer 0 keeps a dense FFN) are peeled
  off into ``pre_layers``, a list;
* hybrid configs (RecurrentGemma's R, R, L) keep a list of per-layer
  params, ``loop_layers``.

``forward`` walks the layers with a Python loop, reading layer ``i``
through ``layer_at``.  Frontend embeddings (the stubbed vision and audio
towers) are prepended to the token embeddings.  With ``cfg.exit_interval``
set, ``init_params`` adds the (n_exits, d_model) ``exit_heads``.  The
decode caches go with the decode steps (ROADMAP A13, third part).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


# -- per-layer block -----------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dense_ffn: bool,
                dtype=torch.float32, device="cuda") -> Params:
    p: Params = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if kind in ("G", "L"):
        init = MLA.init_mla if cfg.kv_lora_rank else L.init_attn
        p["attn"] = init(gen, cfg, dtype, device)
    elif kind == "W":
        p["mix"] = RW.init_rwkv(gen, cfg, dtype, device)
    elif kind == "R":
        p["mix"] = RG.init_rglru(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if cfg.n_experts and not dense_ffn:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype=dtype, device=device)
    return p


def _apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block -> ``(x, aux)``: the new residual stream and the
    block's MoE load-balance loss (a zero f32 scalar for a dense FFN), the
    reference's outputs without its cache."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("G", "L"):
        if cfg.kv_lora_rank:
            mix_out = MLA.apply_mla(p["attn"], h, cfg, positions)
        else:
            mix_out, _ = L.apply_attn(p["attn"], h, cfg, positions, window)
    elif kind == "W":
        mix_out = RW.apply_rwkv(p["mix"], h, cfg)
    elif kind == "R":
        mix_out = RG.apply_rglru(p["mix"], h, cfg)
    else:
        raise ValueError(kind)
    x = x + mix_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        ffn_out, aux = MOE.apply_moe(p["moe"], h, cfg)
    else:
        ffn_out, aux = L.apply_mlp(p["mlp"], h, cfg), x.new_zeros((), dtype=torch.float32)
    return x + ffn_out, aux


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the leading-L stacked layer params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def layer_at(params: Params, cfg: ModelConfig, i: int) -> tuple[Params, str]:
    """Layer ``i``'s params and the kind of code path it runs: a peeled
    ``pre_layers`` entry, a view into the stacked ``layers`` (every one of
    the stack's kind), or a ``loop_layers`` entry."""
    kinds = cfg.layer_kinds()
    if not cfg.uniform:
        return params["loop_layers"][i], kinds[i]
    n_pre = cfg.first_dense_layers
    if i < n_pre:
        return params["pre_layers"][i], kinds[i]
    return layer_params(params["layers"], i - n_pre), kinds[n_pre]


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


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _put(stack: Params, i: int, block: Params) -> None:
    for k, v in block.items():
        if isinstance(v, dict):
            _put(stack[k], i, v)
        else:
            stack[k][i].copy_(v)


def _init_stack(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int, dtype,
                device) -> Params:
    """``n`` blocks of one kind drawn in order, each copied into the
    leading-L stack as it is drawn: the peak holds the stack and one block."""
    block = _init_block(gen, cfg, kind, dense_ffn=False, dtype=dtype, device=device)
    stack = _map(lambda a: a.new_empty((n, *a.shape)), block)
    for i in range(n):
        if i:
            block = _init_block(gen, cfg, kind, dense_ffn=False, dtype=dtype, device=device)
        _put(stack, i, block)
    return stack


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                device="cuda") -> Params:
    """Random params in the reference's layout and scales (``1/sqrt(d_in)``
    dense layers, ``0.02`` embedding and exit heads, ones for the norms),
    drawn in order from ``gen`` on ``device``: the embedding, each layer,
    then the exit heads.  Not bit-equal to ``jax.random``: parity tests
    carry the reference's weights across instead."""
    kinds = cfg.layer_kinds()
    params: Params = {
        "embed": L.init_embed(gen, cfg, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    n_pre = cfg.first_dense_layers
    if cfg.uniform:
        if n_pre:
            params["pre_layers"] = [
                _init_block(gen, cfg, kinds[i], dense_ffn=True, dtype=dtype, device=device)
                for i in range(n_pre)
            ]
        params["layers"] = _init_stack(gen, cfg, kinds[n_pre], cfg.n_layers - n_pre, dtype,
                                       device)
    else:
        params["loop_layers"] = [
            _init_block(gen, cfg, kinds[i], dense_ffn=False, dtype=dtype, device=device)
            for i in range(cfg.n_layers)
        ]
    if cfg.exit_interval:
        n_exits = cfg.n_layers // cfg.exit_interval
        heads = torch.randn((n_exits, cfg.d_model), generator=gen, device=device)
        params["exit_heads"] = (heads * 0.02).to(dtype)
    return params


# -- forward --------------------------------------------------------------------


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The residual stream's input: the token embeddings (B, S_text, d),
    with the frontend embeddings (B, S_front, d) prepended when given."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    return x


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S_text) int
    positions: torch.Tensor,  # (S_total,) absolute positions
    frontend_embeds: torch.Tensor | None = None,  # (B, S_front, d)
    collect_hidden: bool = False,
):
    """-> ``(logits, aux_loss)``, or ``(logits, aux_loss, hidden)`` with
    ``collect_hidden``: hidden (L', B, S_total, d) is the output residual
    stream of every layer after the ``first_dense_layers`` (the
    reference's scan collects the stacked layers only; L' = L without
    them).  The reference's outputs without its cache."""
    x = embed_inputs(params, cfg, tokens, frontend_embeds)
    windows = layer_windows(cfg)
    n_pre = cfg.first_dense_layers if cfg.uniform else 0
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    hidden = []
    for i in range(cfg.n_layers):
        p, kind = layer_at(params, cfg, i)
        x, aux = _apply_block(p, x, cfg, kind, positions, windows[i])
        aux_total = aux_total + aux
        if collect_hidden and i >= n_pre:
            hidden.append(x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    if collect_hidden:
        return logits, aux_total, torch.stack(hidden)
    return logits, aux_total
