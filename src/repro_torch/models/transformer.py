"""The decoder backbone over every model family of the reference, the
counterpart of ``repro.models.transformer``.

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

``forward`` walks the layers with a Python loop (``layer_blocks``: the
stack unbound once); other callers read layer ``i`` through ``layer_at``.  Frontend embeddings (the stubbed vision and audio
towers) are prepended to the token embeddings.  With ``cfg.exit_interval``
set, ``init_params`` adds the (n_exits, d_model) ``exit_heads``.

Decode caches mirror the stacking (``init_cache``): a list ``pre`` and a
leading-L ``stack`` for uniform configs, a list ``loop`` for hybrid ones.
``forward(cache=)`` writes them in place and returns them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

Params = dict[str, Any]

_SHARDED_TODO = (
    "residual_sharding needs the sharded executors, not ported yet (ROADMAP A15)"
)


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


def _mix(p: Params, h: torch.Tensor, cfg: ModelConfig, kind: str, positions: torch.Tensor,
         window: int, cache: Params | None):
    """The block's token mixer -> ``(out, cache)`` (``cache`` None without
    one; the MLA, RWKV6 and RG-LRU mixers take theirs as a keyword)."""
    if kind in ("G", "L") and not cfg.kv_lora_rank:
        return L.apply_attn(p["attn"], h, cfg, positions, window, cache)
    if kind in ("G", "L"):
        fn, args = MLA.apply_mla, (p["attn"], h, cfg, positions)
    elif kind == "W":
        fn, args = RW.apply_rwkv, (p["mix"], h, cfg)
    elif kind == "R":
        fn, args = RG.apply_rglru, (p["mix"], h, cfg)
    else:
        raise ValueError(kind)
    return (fn(*args), None) if cache is None else fn(*args, cache=cache)


def _apply_block_cached(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                        positions: torch.Tensor, window: int, cache: Params | None):
    """One pre-norm block with the layer's decode cache (a sibling of
    ``_apply_block``) -> ``(x, cache, aux)``, the reference's outputs: the
    new residual stream, the cache written in place (None without one)
    and the block's MoE load-balance loss (a zero f32 scalar for a dense
    FFN)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix_out, cache = _mix(p, h, cfg, kind, positions, window, cache)
    x = x + mix_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        ffn_out, aux = MOE.apply_moe(p["moe"], h, cfg)
    else:
        ffn_out, aux = L.apply_mlp(p["mlp"], h, cfg), x.new_zeros((), dtype=torch.float32)
    return x + ffn_out, cache, aux


def _apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block without a cache -> ``(x, aux)``."""
    x, _, aux = _apply_block_cached(p, x, cfg, kind, positions, window, None)
    return x, aux


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the leading-L stacked layer params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def unstack(layers: Params) -> list[Params]:
    """Every layer of the leading-L stacked layer params, as views from one
    ``unbind`` a leaf.  Under autograd the stack's gradient is then one
    ``stack`` of the layers' gradients; ``layer_params`` a layer would add
    a stack-sized gradient for every layer (quadratic in the depth)."""
    cols = {k: unstack(v) if isinstance(v, dict) else v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


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


def layer_blocks(params: Params, cfg: ModelConfig) -> list[tuple[Params, str]]:
    """``layer_at`` for every layer in order, the stacked layers unbound
    once (``unstack``)."""
    if not cfg.uniform:
        return [layer_at(params, cfg, i) for i in range(cfg.n_layers)]
    n_pre = cfg.first_dense_layers
    kind = cfg.layer_kinds()[n_pre]
    return ([layer_at(params, cfg, i) for i in range(n_pre)]
            + [(p, kind) for p in unstack(params["layers"])])


def layer_cache(cache: Params, cfg: ModelConfig, i: int) -> Params:
    """Layer ``i``'s decode cache: a ``pre`` or ``loop`` entry, or views
    into the leading-L ``stack`` (writes to them land in the stack)."""
    if not cfg.uniform:
        return cache["loop"][i]
    n_pre = cfg.first_dense_layers
    if i < n_pre:
        return cache["pre"][i]
    return layer_params(cache["stack"], i - n_pre)


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
    stack = tree_map(lambda a: a.new_empty((n, *a.shape)), block)
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


# -- caches --------------------------------------------------------------------


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, window: int, dtype,
                      device) -> Params:
    if kind in ("G", "L"):
        if cfg.kv_lora_rank:
            return MLA.init_mla_cache(cfg, batch, seq, dtype, device)
        return L.init_attn_cache(cfg, batch, seq, window, dtype, device)
    if kind == "W":
        return RW.init_rwkv_cache(cfg, batch, dtype, device)
    if kind == "R":
        return RG.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               serve: bool = True, device="cuda") -> Params:
    """Decode cache for the whole stack, in the reference's layout:
    ``{"pre": [...], "stack": {leading-L tensors}}`` for uniform configs,
    ``{"loop": [...]}`` for hybrid ones.  A ring is ``min(seq, window)``
    long (``seq`` for full attention); the stacked layers share one length,
    the largest of their rings, as the reference's scanned layers are drawn
    with window 0.  K/V and latents are in ``dtype`` (bf16 by default, as
    the reference's), recurrent state in f32, positions int32."""
    kinds = cfg.layer_kinds()
    windows = layer_windows(cfg, serve=serve)
    if not cfg.uniform:
        return {"loop": [_init_layer_cache(cfg, kinds[i], batch, seq, windows[i], dtype, device)
                         for i in range(cfg.n_layers)]}
    n_pre = cfg.first_dense_layers
    pre = [_init_layer_cache(cfg, kinds[i], batch, seq, windows[i], dtype, device)
           for i in range(n_pre)]
    max_len = max(min(seq, w) if w else seq for w in windows[n_pre:])
    per = _init_layer_cache(cfg, kinds[n_pre], batch, max_len, 0, dtype, device)
    n = cfg.n_layers - n_pre
    stack = {k: v[None].repeat(n, *([1] * v.dim())) for k, v in per.items()}
    return {"pre": pre, "stack": stack}


def _stack_dtypes(stack: Params, kind: str, dtype: torch.dtype) -> None:
    """Give the stacked cache the dtypes its layers write (the reference's
    scan stacks the new leaves): RWKV6's ``last_x`` the model's, the
    RG-LRU conv tail the promotion of its own and the model's.  A no-op
    after the first chunk."""
    name = {"W": "last_x", "R": "conv"}.get(kind)
    if name is not None:
        want = dtype if kind == "W" else torch.promote_types(stack[name].dtype, dtype)
        if stack[name].dtype != want:
            stack[name] = stack[name].to(want)


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
    *,
    cache: Params | None = None,
    serve: bool = False,
    remat: bool = False,
    residual_sharding=None,
):
    """-> ``(logits, aux_loss)``, or ``(logits, aux_loss, hidden)`` with
    ``collect_hidden``: hidden (L', B, S_total, d) is the output residual
    stream of every layer after the ``first_dense_layers`` (the
    reference's scan collects the stacked layers only; L' = L without
    them).  With a ``cache`` (``init_cache``) -> ``(logits, cache,
    aux_loss)``, the reference's outputs; the cache is written in place.
    ``serve`` applies ``layer_windows(cfg, serve=True)``; ``remat`` runs
    each block under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), keeping only its input for the backward pass."""
    if residual_sharding is not None:
        raise ValueError(_SHARDED_TODO)
    if cache is not None and collect_hidden:
        raise ValueError("collect_hidden is not taken with a cache")
    x = embed_inputs(params, cfg, tokens, frontend_embeds)
    windows = layer_windows(cfg, serve=serve)
    n_pre = cfg.first_dense_layers if cfg.uniform else 0
    if cache is not None and cfg.uniform:
        _stack_dtypes(cache["stack"], cfg.layer_kinds()[n_pre], x.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    hidden = []
    for i, (p, kind) in enumerate(layer_blocks(params, cfg)):
        if remat and cache is None:
            x, aux = checkpoint(_apply_block, p, x, cfg, kind, positions, windows[i],
                                use_reentrant=False)
        else:
            c = layer_cache(cache, cfg, i) if cache is not None else None
            x, _, aux = _apply_block_cached(p, x, cfg, kind, positions, windows[i], c)
        aux_total = aux_total + aux
        if collect_hidden and i >= n_pre:
            hidden.append(x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    if cache is not None:
        return logits, cache, aux_total
    if collect_hidden:
        return logits, aux_total, torch.stack(hidden)
    return logits, aux_total
