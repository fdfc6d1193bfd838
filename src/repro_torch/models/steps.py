"""Step functions, the counterpart of ``repro.models.steps``: the train,
prefill and decode step builders and ``init_train_state``.

Each ``make_*`` returns a plain function on tensors.  Batch dict layout:

    tokens:   (B, S_text) int
    frontend: (B, S_front, d) float, for the vision and audio backbones
              only (the stubbed modality encoder's output)

Knobs, as the reference's:

* ``remat``: activation checkpointing a block (``torch.utils.checkpoint``);
* ``microbatch``: gradient accumulation over ``B // microbatch`` equal
  slices, the losses and gradients summed into f32 buffers shaped like
  the masters, then divided by the count;
* ``compute_dtype``: the masters are cast once a step and the gradients
  taken with respect to the cast copies, clipped, then cast back to the
  masters' dtype for the update.

``residual_sharding`` needs the model axis (ROADMAP A15, second part), and
``unroll`` has no meaning for a Python loop over the layers: neither is
taken.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _SHARDED_TODO, forward, init_params
from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import leaves, tree_map

Params = dict[str, Any]


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, remat: bool = False) -> torch.Tensor:
    """Mean next-token NLL (log-softmax in f32) plus the MoE aux loss.  With
    frontend embeddings, the logits at positions ``S_front - 1 .. -2``
    predict the text tokens."""
    tokens = batch["tokens"]
    fe = batch.get("frontend")
    s_front = fe.shape[1] if fe is not None else 0
    positions = torch.arange(tokens.shape[1] + s_front, device=tokens.device)
    logits, aux = forward(params, cfg, tokens, positions, frontend_embeds=fe, remat=remat)
    if s_front:
        pred, labels = logits[:, s_front - 1 : -1], tokens
    else:
        pred, labels = logits[:, :-1], tokens[:, 1:]
    logp = F.log_softmax(pred.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + aux


def _grads_of(params: Params, cfg: ModelConfig, batch: dict, remat: bool):
    """(loss, grads): the gradients with respect to the floating leaves of
    ``params`` (zeros elsewhere)."""
    inputs = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    with torch.enable_grad():
        loss = loss_fn(inputs, cfg, batch, remat=remat)
        wrt = [p for p in leaves(inputs) if p.requires_grad]
        got = dict(zip(map(id, wrt), torch.autograd.grad(loss, wrt)))
    return loss.detach(), tree_map(
        lambda p: got[id(p)] if p.requires_grad else torch.zeros_like(p), inputs)


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, clip: float = 1.0,
                    microbatch: int = 0, remat: bool = False, residual_sharding=None,
                    compute_dtype=None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: one AdamW step (weight decay 0.01) after
    clipping by the global norm, nothing updated in place."""
    if residual_sharding is not None:
        raise ValueError(_SHARDED_TODO)

    def train_step(params: Params, opt_state, batch: dict):
        masters = params
        if compute_dtype is not None:
            params = tree_map(lambda p: p.to(compute_dtype) if p.is_floating_point() else p,
                              params)
        b = batch["tokens"].shape[0]
        if microbatch and b > microbatch:
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of microbatch {microbatch}")
            nm = b // microbatch
            loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = tree_map(torch.zeros_like, masters)
            for j in range(nm):
                mb = {k: v[j * microbatch:(j + 1) * microbatch] for k, v in batch.items()}
                loss, g = _grads_of(params, cfg, mb, remat)
                loss_sum = loss_sum + loss
                grads = tree_map(torch.add, grads, g)
            loss = loss_sum / nm
            grads = tree_map(lambda g: g / nm, grads)
        else:
            loss, grads = _grads_of(params, cfg, batch, remat)
        grads, gnorm = clip_by_global_norm(grads, clip)
        if compute_dtype is not None:
            grads = tree_map(lambda g, m: g.to(m.dtype), grads, masters)
        masters, opt_state = adamw_update(masters, grads, opt_state, lr=lr, weight_decay=0.01)
        return masters, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, residual_sharding=None):
    """-> ``prefill_step(params, cache, batch) -> (logits[:, -1:], cache)``:
    the whole prompt (frontend embeddings first) through the model at the
    serving windows, filling ``cache`` in place."""
    if residual_sharding is not None:
        raise ValueError(_SHARDED_TODO)

    @torch.no_grad()
    def prefill_step(params: Params, cache, batch: dict):
        tokens = batch["tokens"]
        fe = batch.get("frontend")
        s_front = fe.shape[1] if fe is not None else 0
        positions = torch.arange(tokens.shape[1] + s_front, device=tokens.device)
        logits, cache, _ = forward(params, cfg, tokens, positions, frontend_embeds=fe,
                                   cache=cache, serve=True)
        return logits[:, -1:], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """-> ``decode_step(params, cache, tokens, pos) -> (logits, cache)``:
    one new token a sequence, ``tokens`` (B, 1) at the scalar absolute
    position ``pos``, against the running cache (written in place)."""

    @torch.no_grad()
    def decode_step(params: Params, cache, tokens: torch.Tensor, pos):
        positions = torch.as_tensor(pos, device=tokens.device).reshape(1).to(torch.int32)
        logits, cache, _ = forward(params, cfg, tokens, positions, cache=cache, serve=True)
        return logits, cache

    return decode_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                     device="cuda"):
    """-> (params, AdamW state): ``init_params`` drawn from ``gen`` on
    ``device`` and zero moments."""
    params = init_params(cfg, gen, dtype, device)
    return params, adamw_init(params)
