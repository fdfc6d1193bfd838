"""Multi-head Latent Attention (DeepSeek-V2), the counterpart of
``repro.models.mla`` in its cache-less (prefill) form.

MLA compresses the KV path into a low-rank latent c_kv (``kv_lora_rank``)
plus a small decoupled RoPE key; queries are optionally low-rank too.  The
per-head no-PE keys and the values are up-projected from the normed
latent, and attention runs over the concatenated (no-PE, RoPE) head dims,
chunked over queries as the reference's ``_mla_attend``.  The latent
cache and the absorbed decode variant (``mla_absorb``) go with the decode
steps (ROADMAP A13, third part).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, rms_norm, rope, softcap

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


def apply_mla(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """The reference's cache-less branch -> the attention output (B, S, d)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r_kv = cfg.kv_lora_rank
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim

    if "wq_a" in p:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, -1)
    q_n, q_r = q[..., :dn], q[..., dn:]
    q_r = rope(q_r, positions[None, :], cfg.rope_theta)

    lat = x @ p["wkv_a"]  # (B, S, r_kv + dr)
    k_r = rope(lat[..., r_kv:][:, :, None, :], positions[None, :], cfg.rope_theta)[:, :, 0]
    c_kv = rms_norm(lat[..., :r_kv], p["kv_norm"], cfg.norm_eps)
    k_n = (c_kv @ p["wk_b"]).reshape(b, s, h, dn)
    v = (c_kv @ p["wv_b"]).reshape(b, s, h, dv)
    out = _mla_attend(q_n, q_r, k_n, k_r, v, positions, positions, cfg.attn_softcap)
    return out.reshape(b, s, h * dv) @ p["wo"]
