"""QWYC depth-level early exit for transformer classifiers, the counterpart
of ``repro.core.early_exit``.

The additive-ensemble view of a residual-stream transformer: with an exit
head every ``exit_interval`` layers, the classifier score at exit r is
s_r(x) = h_r(x) . w_exit, and the per-segment deltas f_t = s_t - s_{t-1}
form an additive ensemble whose running sum IS the exit-r score.  QWYC's
Algorithm 2 then calibrates two thresholds per exit, with the order pinned
to depth (layer t consumes layer t-1's output).  Costs are the layers of a
segment, so "mean cost" is the mean number of layers run per example.

``exit_scores`` gives the numbers of the reference's (the exit head on the
RAW last-token residual after each exit layer), computed without what the
reference builds and throws away: no final norm, no (N, S, vocab) logits
and no (L, N, S, d) hidden stack, and no layer past the last exit.  Where
rows are independent it runs a chunk of rows at a time.  A MoE layer
couples the rows of one call (the expert capacity and a token's place in
an expert's queue follow the call's tokens, ``models.moe``), so with
``cfg.n_experts`` set every layer runs over all N rows in one call, as the
reference's single ``forward`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.qwyc import QWYCModel, evaluate_cascade, fit_thresholds_for_order
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _apply_block, embed_inputs, layer_at, layer_windows

__all__ = [
    "exit_scores",
    "exit_layers",
    "exit_head_score",
    "exit_deltas",
    "calibrate_early_exit",
    "EarlyExitReport",
    "evaluate_early_exit",
]

# rows per chunk of exit_scores: at Qwen3-1.7B's widths and 128 tokens, a
# chunk's largest activation (the FFN's) is 64 x 128 x 6144 f32, 201 MB
EXIT_CHUNK_ROWS = 64


def exit_head_score(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(B,) f32 score of exit head ``head`` (d,) on the residual stream
    ``h`` (B, S, d): the raw last-token state against the head.  The one
    contraction of ``exit_scores`` and of the neural stage scorer."""
    return h[:, -1, :].float() @ head.float()


def exit_layers(cfg: ModelConfig) -> list[int]:
    """The layer after which each exit head reads the residual stream:
    layer (r + 1) * exit_interval - 1 for exit r.  The reference's
    ``exit_scores`` counts it in its hidden stack, which holds only the
    layers after the ``first_dense_layers``, the index clamped to the last
    of them; so do these (the same layers on every other stack)."""
    k = cfg.exit_interval
    n_pre = cfg.first_dense_layers if cfg.uniform else 0
    last = cfg.n_layers - n_pre - 1
    return [n_pre + min((r + 1) * k - 1, last) for r in range(cfg.n_layers // k)]


@torch.no_grad()
def exit_scores(params, cfg: ModelConfig, tokens, frontend=None) -> torch.Tensor:
    """(N, n_exits) f32 classifier scores at every exit point, on the
    params' device.  The score at exit r is the exit head applied to the
    raw last-token residual after layer ``exit_layers(cfg)[r]``, as the
    reference computes it (its docstring says "normed"; its code does not
    norm).  ``tokens`` (N, S) ints and ``frontend`` (N, S_front, d)
    embeddings prepended to the tokens' (or None), arrays or tensors; run
    ``EXIT_CHUNK_ROWS`` rows at a time, or all N at once for a MoE config."""
    if not cfg.exit_interval:
        raise ValueError("config must set exit_interval")
    heads = params["exit_heads"]
    dev = heads.device

    def tensor(a):
        return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a)).to(dev)

    toks = tensor(tokens).long()
    front = None if frontend is None else tensor(frontend)
    at = exit_layers(cfg)
    windows = layer_windows(cfg)
    n = toks.shape[0]
    positions = torch.arange(toks.shape[1] + (0 if front is None else front.shape[1]), device=dev)
    out = torch.empty((n, len(at)), dtype=torch.float32, device=dev)
    step = max(n, 1) if cfg.n_experts else EXIT_CHUNK_ROWS
    for r0 in range(0, n, step):
        rows = slice(r0, r0 + step)
        x = embed_inputs(params, cfg, toks[rows], None if front is None else front[rows])
        for i in range(at[-1] + 1):
            p, kind = layer_at(params, cfg, i)
            x, _ = _apply_block(p, x, cfg, kind, positions, windows[i])
            for r in (r for r, li in enumerate(at) if li == i):
                out[rows, r] = exit_head_score(x, heads[r])
    return out


@dataclasses.dataclass
class EarlyExitReport:
    model: QWYCModel
    mean_layers: float
    full_layers: int
    diff_rate: float
    speedup: float


def exit_deltas(scores) -> np.ndarray:
    """(N, n_exits) f64 per-segment deltas f_t = s_t - s_{t-1} of exit
    scores (an array or a tensor): the additive ensemble QWYC fits."""
    s = (scores.cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)).astype(
        np.float64
    )
    return np.diff(np.concatenate([np.zeros((s.shape[0], 1)), s], axis=1), axis=1)


def calibrate_early_exit(
    scores_calib,
    cfg: ModelConfig,
    alpha: float = 0.01,
    beta: float = 0.0,
    mode: str = "both",
) -> QWYCModel:
    """Fit per-exit thresholds (Algorithm 2, depth order) on calibration
    exit scores (N, n_exits)."""
    deltas = exit_deltas(scores_calib)
    n_exits = deltas.shape[1]
    costs = np.full(n_exits, float(cfg.exit_interval))
    return fit_thresholds_for_order(
        deltas, np.arange(n_exits), costs=costs, beta=beta, alpha=alpha, mode=mode
    )


def evaluate_early_exit(model: QWYCModel, scores_test, cfg: ModelConfig) -> EarlyExitReport:
    ev = evaluate_cascade(model, exit_deltas(scores_test))
    mean_layers = ev["mean_cost"]  # costs were layers-per-segment
    full = cfg.n_layers
    return EarlyExitReport(
        model=model,
        mean_layers=float(mean_layers),
        full_layers=full,
        diff_rate=float(ev["diff_rate"]),
        speedup=full / float(mean_layers),
    )
