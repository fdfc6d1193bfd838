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
and no (L, N, S, d) hidden stack.  It keeps the (E, rows, d) last-token
states of a chunk of rows at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.qwyc import QWYCModel, evaluate_cascade, fit_thresholds_for_order
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _apply_block, check_supported, layer_params, layer_windows

__all__ = [
    "exit_scores",
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


@torch.no_grad()
def exit_scores(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """(N, n_exits) f32 classifier scores at every exit point, on the
    params' device.  The score at exit r is the exit head applied to the
    raw last-token residual after layer (r + 1) * exit_interval, as the
    reference computes it (its docstring says "normed"; its code does not
    norm).  ``tokens`` (N, S) ints, an array or a tensor, run
    ``EXIT_CHUNK_ROWS`` rows at a time."""
    if not cfg.exit_interval:
        raise ValueError("config must set exit_interval")
    check_supported(cfg)
    heads = params["exit_heads"]
    dev = heads.device
    toks = torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor) else tokens)
    toks = toks.to(dev).long()
    k = cfg.exit_interval
    windows = layer_windows(cfg)
    positions = torch.arange(toks.shape[1], device=dev)
    n_exits = cfg.n_layers // k
    out = torch.empty((toks.shape[0], n_exits), dtype=torch.float32, device=dev)
    for r0 in range(0, toks.shape[0], EXIT_CHUNK_ROWS):
        x = L.embed_tokens(params["embed"], toks[r0 : r0 + EXIT_CHUNK_ROWS], cfg)
        for i in range(n_exits * k):
            x = _apply_block(layer_params(params["layers"], i), x, cfg, positions, windows[i])
            if (i + 1) % k == 0:
                out[r0 : r0 + EXIT_CHUNK_ROWS, i // k] = exit_head_score(x, heads[i // k])
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
