"""Shared neural building blocks, the counterpart of ``repro.models.layers``.

Plain functions over param dicts: ``init_*`` draws a dict of tensors from
an explicit ``torch.Generator`` on an explicit device, ``apply_*``
consumes it.  Weights keep the reference's ``(d_in, d_out)`` layout, so
``x @ w`` is the same product in both packages and the reference's weights
carry across as they are (``repro_torch.convert.transformer_params_from_numpy``).

Attention is the reference's query-chunked causal attention (``_attend``),
in its order of operations: f32 logits, softcap, ``-1e30`` masking,
softmax, then the value contraction.  Decode keeps a ring-buffer KV cache
a layer (``init_attn_cache``; length ``min(seq, window)``), which
``apply_attn`` writes in place.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = dict[str, Any]

Q_CHUNK = 256  # attention query block

# -- basics --------------------------------------------------------------------


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n_heads, head_dim); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP / SwiGLU --------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             dtype=torch.float32, device="cuda") -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "wi": init_dense(gen, d, f, dtype, device),
            "wg": init_dense(gen, d, f, dtype, device),
            "wo": init_dense(gen, f, d, dtype, device),
        }
    return {"wi": init_dense(gen, d, f, dtype, device), "wo": init_dense(gen, f, d, dtype, device)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


# -- query-chunked attention core ---------------------------------------------


def _attend(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    q_pos: torch.Tensor,  # (Sq,) absolute positions of queries
    k_pos: torch.Tensor,  # (Sk,) absolute positions of keys
    window: int,  # 0 = full causal
    attn_softcap: float,
    q_chunk: int = Q_CHUNK,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, chunked over queries.

    Never materialises more than (B, KV, rep, q_chunk, Sk) logits, and
    never repeats the KV heads (grouped-query layout).  Queries past ``Sq``
    in the last chunk carry position -1 and are sliced off.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    n_chunks = max(1, (sq + q_chunk - 1) // q_chunk)
    pad = n_chunks * q_chunk - sq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    qc = q.reshape(b, n_chunks, q_chunk, kvh, rep, hd)
    qp = q_pos.reshape(n_chunks, q_chunk)
    kf, vf = k.float(), v.float()
    outs = []
    for c in range(n_chunks):
        qi, qpi = qc[:, c], qp[c]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qi.float(), kf)
        logits = logits * scale
        logits = softcap(logits, attn_softcap)
        causal = qpi[:, None] >= k_pos[None, :]  # (qc, Sk)
        valid = (k_pos >= 0)[None, :] & (qpi >= 0)[:, None]
        mask = causal & valid
        if window > 0:
            mask &= qpi[:, None] - k_pos[None, :] < window
        logits = torch.where(mask[None, None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w, vf)
        outs.append(out.to(qi.dtype))
    out = torch.stack(outs, dim=1).reshape(b, n_chunks * q_chunk, h, hd)
    return out[:, :sq]


# -- GQA attention layer (optionally windowed / softcapped / qk-normed) -------


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
              device="cuda") -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    p = {
        "wq": init_dense(gen, d, h * hd, dtype, device),
        "wk": init_dense(gen, d, kv * hd, dtype, device),
        "wv": init_dense(gen, d, kv * hd, dtype, device),
        "wo": init_dense(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def init_attn_cache(cfg: ModelConfig, batch: int, seq: int, window: int, dtype,
                    device="cuda") -> Params:
    """Ring-buffer KV cache for one layer: ``k`` and ``v`` (B, length, KV,
    hd) in the cache dtype, ``pos`` (B, length) int32 at -1 (empty), where
    length = ``min(seq, window)``, or ``seq`` for full attention."""
    length = min(seq, window) if window else seq
    kv, hd = cfg.n_kv_heads, cfg.hd()
    return {
        "k": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def ring_write(cache: Params, positions: torch.Tensor, **rows: torch.Tensor) -> None:
    """Write ``rows`` (each (B, S, ...)) and their positions into the ring
    slots ``positions % length`` of ``cache``, in place, cast to the
    cache's dtypes.  A chunk longer than the ring writes its last
    ``length`` positions only: the reference's scatter keeps the last of
    duplicate slots, and ``index_copy_`` with duplicate indices keeps no
    defined one on CUDA.  So a prompt longer than a ring loses the keys its
    earlier queries need, in both packages (ROADMAP C14)."""
    length = cache["pos"].shape[1]
    if positions.shape[0] > length:
        positions = positions[-length:]
        rows = {k: v[:, -length:] for k, v in rows.items()}
    slot = (positions % length).long()
    for name, v in rows.items():
        cache[name].index_copy_(1, slot, v.to(cache[name].dtype))
    pos = positions.to(torch.int32)[None, :].expand(cache["pos"].shape[0], -1)
    cache["pos"].index_copy_(1, slot, pos)


def settle(cache: Params, name: str, value: torch.Tensor) -> None:
    """Store ``value`` as ``cache[name]``: copied in place where the dtype
    matches, else the entry is rebound to ``value`` (the reference's cache
    takes each new leaf's dtype, e.g. ``last_x`` the model's after a bf16
    cache's first chunk)."""
    if cache[name].dtype == value.dtype:
        cache[name].copy_(value)
    else:
        cache[name] = value.clone()


def apply_attn(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,)
    window: int,
    cache: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """-> ``(out, cache)``.  Without a cache, the cache-less branch and
    ``None``.  With a cache (``init_attn_cache``), K and V are written into
    its ring in place (PyTorch's idiom; it also keeps the step capturable)
    and the queries attend over the ring, its keys masked by the positions
    of the cache's batch row 0, as the reference's; the same dict is
    returned."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions[None, :], cfg.rope_theta)
    k = rope(k, positions[None, :], cfg.rope_theta)
    if cache is None:
        out = _attend(q, k, v, positions, positions, window, cfg.attn_softcap)
    else:
        ring_write(cache, positions, k=k, v=v)
        out = _attend(q, cache["k"], cache["v"], positions, cache["pos"][0], window,
                      cfg.attn_softcap)
    return out.reshape(b, s, h * hd) @ p["wo"], cache


# -- embeddings / head ---------------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cuda") -> Params:
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device)
    p = {"tok": (tok * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens] * math.sqrt(cfg.d_model)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["tok"].T
    else:
        logits = x @ p["unembed"]
    return softcap(logits, cfg.logit_softcap)
