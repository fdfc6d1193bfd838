"""Unified model configuration, a copy of ``repro.models.config``.

One ``ModelConfig`` describes a decoder-style backbone: dense GQA, MLA
(DeepSeek), MoE, RWKV6 (attention-free), RG-LRU hybrid (RecurrentGemma),
and the VLM/audio variants (``models.transformer`` builds each of them).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention variants -------------------------------------------------
    attn_kind: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False  # qwen3
    logit_softcap: float = 0.0  # gemma2 final-logit softcapping (0 = off)
    attn_softcap: float = 0.0  # gemma2 attention-logit softcapping
    sliding_window: int = 0  # 0 = full attention
    # per-layer pattern string, one char per layer, cycled:
    #   'G' full/global attention, 'L' local sliding-window attention,
    #   'R' recurrent block (RG-LRU), 'W' RWKV6 time-mix block.
    layer_pattern: str = "G"
    rope_theta: float = 10000.0
    attn_bias: bool = False

    # --- MLA (DeepSeek) -----------------------------------------------------
    kv_lora_rank: int = 0  # >0 enables MLA
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = False  # decode-time weight absorption (perf variant)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0  # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden size
    first_dense_layers: int = 0  # deepseek: layer 0 keeps a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- recurrent (rwkv / rglru) --------------------------------------------
    rnn_heads: int = 0  # rwkv6 wkv heads (0 -> n_heads)
    conv_width: int = 4  # rglru temporal conv
    rglru_c: float = 8.0

    # --- modality frontend (stubbed: precomputed embeddings) ----------------
    frontend: str = ""  # "" | "vision" | "audio"
    n_frontend_tokens: int = 0

    # --- misc ----------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    mlp_kind: str = "swiglu"  # swiglu | gelu
    # serving-time override: cap attention window for ultra-long decode
    # (documented deviation for full-attention archs at long_500k).
    serve_window_override: int = 0
    # early-exit integration (QWYC depth-level): insert an exit head every
    # ``exit_interval`` layers (0 = disabled).
    exit_interval: int = 0

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def pattern_at(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def layer_kinds(self) -> list[str]:
        return [self.pattern_at(i) for i in range(self.n_layers)]

    @property
    def uniform(self) -> bool:
        """True when all layers share one code path (scan-stackable)."""
        kinds = set(self.layer_kinds())
        if kinds <= {"G", "L"}:
            return True  # local vs global is a per-layer window *value*
        return len(kinds) == 1

    @property
    def is_recurrent_only(self) -> bool:
        return set(self.layer_kinds()) <= {"W", "R"}

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            q_lora_rank=min(self.q_lora_rank, 32),
            rope_head_dim=16 if self.kv_lora_rank else self.rope_head_dim,
            nope_head_dim=32 if self.kv_lora_rank else self.nope_head_dim,
            v_head_dim=32 if self.kv_lora_rank else self.v_head_dim,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 64) if self.moe_d_ff else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            rnn_heads=min(self.rnn_heads, 4) if self.rnn_heads else 0,
        )


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embedding + per-layer weights)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.hd()
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    for kind in cfg.layer_kinds():
        if kind in ("G", "L"):
            if cfg.kv_lora_rank:  # MLA
                qd = cfg.q_lora_rank or d
                per_layer += d * cfg.q_lora_rank if cfg.q_lora_rank else 0
                per_layer += qd * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
                per_layer += d * (cfg.kv_lora_rank + cfg.rope_head_dim)
                per_layer += cfg.kv_lora_rank * cfg.n_heads * (
                    cfg.nope_head_dim + cfg.v_head_dim
                )
                per_layer += cfg.n_heads * cfg.v_head_dim * d
            else:
                per_layer += d * cfg.n_heads * hd  # q
                per_layer += 2 * d * cfg.n_kv_heads * hd  # k, v
                per_layer += cfg.n_heads * hd * d  # o
        elif kind == "R":  # rglru block
            per_layer += 2 * d * int(d * 1.0) + 3 * d  # gates + lru params (rough)
        elif kind == "W":  # rwkv6
            per_layer += 5 * d * d + d * 64 * 2
        # mlp
        if cfg.n_experts:
            per_layer += cfg.n_experts * 3 * d * cfg.moe_d_ff / cfg.n_layers * 1  # averaged below
        else:
            mult = 3 if cfg.mlp_kind == "swiglu" else 2
            per_layer += mult * d * f
    total = emb + per_layer
    if cfg.n_experts:
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        total += moe_layers * (cfg.n_experts + cfg.n_shared_experts) * 3 * d * cfg.moe_d_ff
        total += moe_layers * cfg.n_experts * d  # router
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k + shared experts count)."""
    if not cfg.n_experts:
        return param_count(cfg)
    dense = param_count(cfg)
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    all_exp = moe_layers * (cfg.n_experts + cfg.n_shared_experts) * 3 * cfg.d_model * cfg.moe_d_ff
    act_exp = moe_layers * (cfg.top_k + cfg.n_shared_experts) * 3 * cfg.d_model * cfg.moe_d_ff
    return int(dense - all_exp + act_exp)
