"""Multi-head Latent Attention (DeepSeek-V2), the counterpart of
``repro.models.mla`` in its cache-less (prefill) form.

MLA compresses the KV path into a low-rank latent c_kv (``kv_lora_rank``)
plus a small decoupled RoPE key; queries are optionally low-rank too.  The
per-head no-PE keys and the values are up-projected from the normed
latent, and attention runs over the concatenated (no-PE, RoPE) head dims,
chunked over queries as the reference's ``_mla_attend``.  Decode keeps
the latent cache, ``(c_kv, k_rope)`` a position (``init_mla_cache``), and
with ``cfg.mla_absorb`` a chunk of at most ``Q_CHUNK`` queries contracts
the cached latent directly (the absorbed variant), as the reference's.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, ring_write, rms_norm, rope, softcap

Params = dict[str, Any]

Q_CHUNK = 256


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> Params:
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    p: Params = {}
    if r_q:
        p["wq_a"] = init_dense(gen, d, r_q, dtype, device)
        p["q_norm"] = torch.ones((r_q,), dtype=dtype, device=device)
        p["wq_b"] = init_dense(gen, r_q, h * (dn + dr), dtype, device)
    else:
        p["wq"] = init_dense(gen, d, h * (dn + dr), dtype, device)
    p["wkv_a"] = init_dense(gen, d, r_kv + dr, dtype, device)  # latent + rope key
    p["kv_norm"] = torch.ones((r_kv,), dtype=dtype, device=device)
    p["wk_b"] = init_dense(gen, r_kv, h * dn, dtype, device)
    p["wv_b"] = init_dense(gen, r_kv, h * dv, dtype, device)
    p["wo"] = init_dense(gen, h * dv, d, dtype, device)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device="cuda") -> Params:
    """Latent KV cache: ``lat`` (B, seq, kv_lora_rank + rope_head_dim) in
    the cache dtype, ``pos`` (B, seq) int32 at -1 (empty)."""
    width = cfg.kv_lora_rank + cfg.rope_head_dim
    return {
        "lat": torch.zeros((batch, seq, width), dtype=dtype, device=device),
        "pos": torch.full((batch, seq), -1, dtype=torch.int32, device=device),
    }


def _mla_attend(q_n, q_r, k_n, k_r, v, q_pos, k_pos, attn_cap: float, q_chunk: int = Q_CHUNK):
    """Causal attention over concatenated (nope, rope) head dims, chunked
    over queries: q_n (B, Sq, H, dn), q_r (B, Sq, H, dr), k_n (B, Sk, H,
    dn), k_r (B, Sk, dr) shared by the heads, v (B, Sk, H, dv)."""
    b, sq, h, dn = q_n.shape
    dr = q_r.shape[-1]
    scale = 1.0 / math.sqrt(dn + dr)
    n_chunks = max(1, (sq + q_chunk - 1) // q_chunk)
    pad = n_chunks * q_chunk - sq
    if pad:
        q_n = F.pad(q_n, (0, 0, 0, 0, 0, pad))
        q_r = F.pad(q_r, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    qn = q_n.reshape(b, n_chunks, q_chunk, h, dn)
    qr = q_r.reshape(b, n_chunks, q_chunk, h, dr)
    qp = q_pos.reshape(n_chunks, q_chunk)
    kn, kr, vf = k_n.float(), k_r.float(), v.float()
    outs = []
    for c in range(n_chunks):
        qni, qri, qpi = qn[:, c], qr[:, c], qp[c]
        logits = torch.einsum("bqhd,bkhd->bhqk", qni.float(), kn)
        logits = logits + torch.einsum("bqhd,bkd->bhqk", qri.float(), kr)
        logits = logits * scale
        logits = softcap(logits, attn_cap)
        mask = (qpi[:, None] >= k_pos[None, :]) & (k_pos >= 0)[None, :] & (qpi >= 0)[:, None]
        logits = torch.where(mask[None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, vf).to(qni.dtype))
    out = torch.stack(outs, dim=1).reshape(b, n_chunks * q_chunk, h, v.shape[-1])
    return out[:, :sq]


def apply_mla(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
              cache: Params | None = None):
    """Without a cache, the reference's cache-less branch -> the attention
    output (B, S, d).  With a cache (``init_mla_cache``, an added keyword)
    -> ``(out, cache)``: the new latents are written into it in place and
    the queries attend over every cached position, through the absorbed
    weights when ``cfg.mla_absorb`` and ``S <= Q_CHUNK`` (whose mask, as
    the reference's, has no ``q_pos >= 0`` term: no query is padding)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r_kv = cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    if "wq_a" in p:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, -1)
    q_n, q_r = q[..., :dn], q[..., dn:]
    q_r = rope(q_r, positions[None, :], cfg.rope_theta)

    lat = x @ p["wkv_a"]  # (B, S, r_kv + dr)
    k_r = rope(lat[..., r_kv:][:, :, None, :], positions[None, :], cfg.rope_theta)[:, :, 0]
    k_pos = positions
    if cache is not None:
        ring_write(cache, positions, lat=torch.cat([lat[..., :r_kv], k_r], dim=-1))
        lat, k_pos = cache["lat"], cache["pos"][0]
        k_r = lat[..., r_kv:]
    c_kv = rms_norm(lat[..., :r_kv], p["kv_norm"], cfg.norm_eps)

    if cfg.mla_absorb and cache is not None and s <= Q_CHUNK:
        # fold wk_b into the query and wv_b into the output: the latent
        # cache is contracted directly, the (B, S, H, dn) keys and (B, S,
        # H, dv) values never materialised
        scale = 1.0 / math.sqrt(dn + dr)
        wk = p["wk_b"].reshape(r_kv, h, dn)
        q_abs = torch.einsum("bshd,rhd->bshr", q_n.float(), wk.float())
        logits = torch.einsum("bshr,bkr->bhsk", q_abs, c_kv.float())
        logits = logits + torch.einsum("bshd,bkd->bhsk", q_r.float(), k_r.float())
        logits = logits * scale
        logits = softcap(logits, cfg.attn_softcap)
        mask = (positions[:, None] >= k_pos[None, :]) & (k_pos >= 0)[None, :]
        logits = torch.where(mask[None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhsk,bkr->bshr", w, c_kv.float())
        wv = p["wv_b"].reshape(r_kv, h, dv)
        out = torch.einsum("bshr,rhd->bshd", ctx, wv.float()).to(x.dtype)
    else:
        k_n = (c_kv @ p["wk_b"]).reshape(b, -1, h, dn)
        v = (c_kv @ p["wv_b"]).reshape(b, -1, h, dv)
        out = _mla_attend(q_n, q_r, k_n, k_r, v, positions, k_pos, cfg.attn_softcap)
    out = out.reshape(b, s, h * dv) @ p["wo"]
    return out if cache is None else (out, cache)
