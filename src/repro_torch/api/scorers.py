"""The public ``StageScorer`` protocol, the counterpart of
``repro.api.scorers`` for the ported slice.

A ``StageScorer`` is a plan-independent template: it holds ensemble params
in ORIGINAL order, and ``bind(dplan, device)`` applies the plan's cascade
order and lowers it onto the device as the executors' ``BoundScorer``.
The port's ``bind`` takes the torch device explicitly (the reference's
binds onto JAX's default device).  Scorer families live in a registry
(``register_scorer`` / ``get_scorer`` / ``scorer_names``), and
``host_producer`` drives a bound scorer as the host ``ChunkedExecutor``'s
producer.  The matrix, tree and lattice scorers are stateless;
``NeuralScorer`` (the depth cascade over a transformer's exit heads)
carries the residual stream through the survivor buffers, so a row that
exits early stops paying for deeper layers.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core.early_exit import exit_deltas, exit_head_score, exit_scores
from repro_torch.core.executor import CascadePlan
from repro_torch.device import resolve_device
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    BoundScorer,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.kernels.ops import _bucket_rows
from repro_torch.models import layers as L
from repro_torch.models.transformer import _apply_block, layer_at, layer_windows

__all__ = [
    "StageScorer",
    "MatrixScorer",
    "TreeScorer",
    "LatticeScorer",
    "NeuralScorer",
    "FunctionScorer",
    "register_scorer",
    "get_scorer",
    "scorer_names",
    "host_producer",
]


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class StageScorer(abc.ABC):
    """A plan-independent stage-scorer template."""

    #: registry name of the scorer family ("matrix"/"tree"/"lattice"/...)
    name: str = "?"

    @abc.abstractmethod
    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        """Lower onto ``dplan`` and ``device`` -> the executors' ``BoundScorer``."""

    def calibration_scores(self, X) -> np.ndarray:
        """(N, T) additive stage scores for ``api.fit(scorer, X)``, the
        model-backed fit.  Optional: scorers that cannot score themselves
        fit on a precomputed score matrix instead."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot score calibration inputs itself; "
            "pass a precomputed (N, T) score matrix to api.fit instead"
        )

    def fit_overrides(self) -> dict:
        """``FitConfig`` fields this scorer family pins (the neural
        cascade's depth order and layer costs), merged over the user's
        config by ``api.fit``; the user's explicit ``costs`` win."""
        return {}


@dataclasses.dataclass(frozen=True)
class MatrixScorer(StageScorer):
    """Scorer over a precomputed (N, T) score matrix in ORIGINAL ensemble
    order — ``prepare`` applies the plan's cascade order itself."""

    quant: str | None = None
    name: str = dataclasses.field(default="matrix", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        base = matrix_stage_scorer(dplan, quant=self.quant, device=device)
        order = np.asarray(dplan.plan.order)

        def prepare(original):
            F = _numpy(original)
            if F.ndim != 2 or F.shape[1] != order.shape[0]:
                raise ValueError(
                    f"MatrixScorer expects an (N, {order.shape[0]}) "
                    f"original-order score matrix, got {F.shape}"
                )
            return base.prepare(F[:, order])

        return dataclasses.replace(base, prepare=prepare)


@dataclasses.dataclass(frozen=True)
class TreeScorer(StageScorer):
    """Oblivious-forest scorer over stacked per-tree params in ORIGINAL
    ensemble order ((T, depth) feats/thrs, (T, 2**depth) leaves; numpy
    arrays or tensors)."""

    feats: object
    thrs: object
    leaves: object
    block_n: int = DEFAULT_BLOCK_N
    quant: str | None = None
    name: str = dataclasses.field(default="tree", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        order = np.asarray(dplan.plan.order)
        return tree_stage_scorer(
            dplan,
            _numpy(self.feats)[order],
            _numpy(self.thrs)[order],
            _numpy(self.leaves)[order],
            block_n=self.block_n,
            quant=self.quant,
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class LatticeScorer(StageScorer):
    """Lattice scorer over (T, 2**S) theta / (T, S) feats stacks in
    ORIGINAL ensemble order (numpy arrays or tensors)."""

    theta: object
    feats: object
    block_n: int = DEFAULT_BLOCK_N
    quant: str | None = None
    name: str = dataclasses.field(default="lattice", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        order = np.asarray(dplan.plan.order)
        return lattice_stage_scorer(
            dplan,
            _numpy(self.theta)[order],
            _numpy(self.feats)[order],
            block_n=self.block_n,
            quant=self.quant,
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class FunctionScorer(StageScorer):
    """Escape hatch: wrap a ``factory(dplan, device) -> BoundScorer``
    closure.

    For custom scorers that build their own kernel-layer ``BoundScorer``
    (tests, benchmarks, one-off experiments) without defining a full
    ``StageScorer`` subclass.  ``bind(dplan, device)`` calls
    ``factory(dplan, device)``: the port passes the torch device the
    executor runs on, where the reference's ``factory(dplan)`` takes
    JAX's default device.  Lanes and slabs are whatever the closure put
    on the scorer.
    """

    factory: object
    name: str = dataclasses.field(default="function", init=False)

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        return self.factory(dplan, device)


def _params_to(tree, device):
    """The param tree on ``device`` (no copy for tensors already there)."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device) for v in tree]
    return tree.to(device)


class NeuralScorer(StageScorer):
    """QWYC over transformer depth: cascade position t is the exit head
    after layer ``(t + 1) * exit_interval``, and the stage score is the
    per-segment delta f_t = s_t - s_{t-1} (``core.early_exit``'s
    additive-ensemble view), so the executor's running sum g IS the exit-t
    score and ``g >= beta`` at margin-infinity is the full-depth verdict.

    ``params`` is the port's param dict (``models.transformer.init_params``,
    or the reference's carried across by ``convert.transformer_params_from_numpy``)
    with ``exit_heads``; the scorer runs on the device its ``bind`` names,
    where the params are moved (no copy when they are there already).

    The carried state is the residual stream itself::

        state = {"h": (seq_len, d_model) residual, "s_prev": () f32}

    ``stage(state, t0, t0 + W, ...)`` runs layers ``t0 * k .. (t0 + W) * k``
    on the survivors' carried ``h`` (the same ``_apply_block``, windows and
    positions as ``forward``), and scores the raw last-token state against
    the exit head after each segment.  Attention K/V (and the RWKV6 and
    RG-LRU recurrences) are recomputed from the carried residual each
    segment (prefill-style classification, exact by construction), so no
    cache rides the buffers.  Any uniform stack serves: dense or MLA
    attention, RWKV6 or RG-LRU mixing, a dense or MoE FFN.  A MoE layer
    couples the rows of one call (``models.moe``), so a batch stage runs
    over the loop's whole buffer of rows in the loop's order, and the lane
    sweep runs every stage start over every lane, as the reference's do.
    At ``t0 == 0`` the state comes from the prepared operand (the embedded
    tokens), which also covers streaming rookies admitted into recycled
    lanes.  The port's loops pass ``t0`` as a Python int, so a stage's
    layer indices are static: it reads the layers by index (``layer_at``).
    Exits past the last (a ragged last stage) give zero columns and leave
    the state as it was.

    Depth order is pinned (layer t consumes layer t-1's output): ``bind``
    refuses a plan whose order is not ``arange``, one with a lead stage
    (the ``sorted-kernel`` policy), and one whose T is not the model's
    exit count.  The lane variant the streaming loops call is a masked
    sweep over the plan's static stage starts: S times a batch stage's
    compute.  No ``slabs``: the fused stage step has no state lane, so the
    executors never take it for this scorer (``megakernel=True`` raises).
    """

    name = "neural"

    def __init__(self, params, cfg, seq_len: int):
        if not cfg.exit_interval:
            raise ValueError("NeuralScorer needs cfg.exit_interval > 0")
        if not cfg.uniform:
            raise ValueError(
                "NeuralScorer requires a uniform (scan-stacked) layer stack; "
                f"layer_pattern={cfg.layer_pattern!r} is not uniform"
            )
        if cfg.first_dense_layers:
            raise ValueError(
                "NeuralScorer does not support first_dense_layers > 0: every "
                "layer must sit on the exit grid"
            )
        if "exit_heads" not in params:
            raise ValueError("params must carry 'exit_heads' (cfg.exit_interval set at init)")
        self.params = params
        self.cfg = cfg
        self.seq_len = int(seq_len)

    @property
    def n_exits(self) -> int:
        return self.cfg.n_layers // self.cfg.exit_interval

    def calibration_scores(self, tokens) -> np.ndarray:
        """Per-block logit margins: the (N, n_exits) per-segment deltas
        f_t = s_t - s_{t-1} of the exit-head scores, as f64 (what the
        thresholds are fit on), scored on the params' device."""
        return exit_deltas(exit_scores(self.params, self.cfg, tokens))

    def fit_overrides(self) -> dict:
        E = self.n_exits
        return {
            "optimize_order": False,
            "order": np.arange(E),
            "costs": np.full(E, float(self.cfg.exit_interval)),
        }

    def bind(self, dplan: DevicePlan, device="cuda") -> BoundScorer:
        cfg = self.cfg
        k = int(cfg.exit_interval)
        E = self.n_exits
        plan = dplan.plan
        if plan.T != E:
            raise ValueError(
                f"plan has {plan.T} cascade positions but the model has {E} "
                f"exits (n_layers={cfg.n_layers}, exit_interval={k})"
            )
        if not np.array_equal(np.asarray(plan.order), np.arange(E)):
            raise ValueError(
                "neural stages are depth-pinned: layer t consumes layer t-1's "
                "output, so the cascade order must be arange(n_exits) "
                "(fit with a pre-selected ordering)"
            )
        if plan.lead_t:
            raise ValueError(
                "neural stages do not support a lead stage (lead_t="
                f"{plan.lead_t}); use the 'kernel' policy, not 'sorted-kernel'"
            )
        dev = resolve_device(device)
        params = _params_to(self.params, dev)
        heads, embed = params["exit_heads"], params["embed"]
        blocks = [layer_at(params, cfg, li) for li in range(E * k)]
        windows = layer_windows(cfg)
        positions = torch.arange(self.seq_len, device=dev)
        W = dplan.W
        dt = embed["tok"].dtype
        f32 = torch.float32
        seq_len = self.seq_len
        state_spec = {"h": ((seq_len, int(cfg.d_model)), dt), "s_prev": ((), f32)}

        def prepare(tokens) -> torch.Tensor:
            toks = tokens if isinstance(tokens, torch.Tensor) else torch.as_tensor(np.asarray(tokens))
            if toks.ndim != 2 or toks.shape[1] != seq_len:
                raise ValueError(
                    f"NeuralScorer(seq_len={seq_len}) got tokens of shape {tuple(toks.shape)}"
                )
            return L.embed_tokens(embed, toks.to(dev).long(), cfg)

        def segment(h, sp, t0: int):
            """Exits [t0, t0 + W) on the carried residual stream; exits
            past E give zero columns and leave ``h`` and ``sp`` as they are."""
            cols = []
            for p in range(t0, t0 + W):
                if p >= E:
                    cols.append(torch.zeros_like(sp))
                    continue
                for li in range(p * k, (p + 1) * k):
                    lp, kind = blocks[li]
                    h, _ = _apply_block(lp, h, cfg, kind, positions, windows[li])
                s = exit_head_score(h, heads[p])
                cols.append(s - sp)
                sp = s
            return torch.stack(cols, dim=1), h, sp

        def stage_fn(state, t0, t1, rows, x, n_valid):
            t0 = int(t0)
            if t0 == 0:
                xr = x[rows]
                h, sp = xr.to(dt), torch.zeros(xr.shape[0], dtype=f32, device=xr.device)
            else:
                h, sp = state["h"], state["s_prev"]
            scores, h, sp = segment(h, sp, t0)
            return scores, {"h": h, "s_prev": sp}

        stage_starts = [int(t) for t in dplan.stage_t0]

        def lane_stage_fn(state, t0_lane, rows, x, n_valid):
            first = t0_lane == 0
            h = torch.where(first[:, None, None], x[rows].to(dt), state["h"])
            sp = torch.where(first, 0.0, state["s_prev"])
            out = torch.zeros((h.shape[0], W), dtype=f32, device=h.device)
            h_out, sp_out = h, sp
            for q in stage_starts:
                s_q, h_q, sp_q = segment(h, sp, q)
                sel = t0_lane == q
                out = torch.where(sel[:, None], s_q, out)
                h_out = torch.where(sel[:, None, None], h_q, h_out)
                sp_out = torch.where(sel, sp_q, sp_out)
            return out, {"h": h_out, "s_prev": sp_out}

        return BoundScorer(
            fn=None,
            prepare=prepare,
            width=W,
            state_spec=state_spec,
            stage_fn=stage_fn,
            lane_stage_fn=lane_stage_fn,
        )


# -- registry ----------------------------------------------------------------

_SCORERS: dict[str, type] = {
    "matrix": MatrixScorer,
    "tree": TreeScorer,
    "lattice": LatticeScorer,
    "neural": NeuralScorer,
    "function": FunctionScorer,
}


def register_scorer(name: str, cls: type) -> None:
    """Register a ``StageScorer`` subclass under ``name``."""
    if not (isinstance(cls, type) and issubclass(cls, StageScorer)):
        raise TypeError(f"{cls!r} is not a StageScorer subclass")
    _SCORERS[str(name)] = cls


def get_scorer(name: str) -> type:
    try:
        return _SCORERS[name]
    except KeyError:
        raise KeyError(f"unknown scorer {name!r}; registered: {sorted(_SCORERS)}") from None


def scorer_names() -> tuple[str, ...]:
    return tuple(sorted(_SCORERS))


# -- host adapter: StageScorer -> ChunkedExecutor producer --------------------


def _as_device_plan(plan) -> DevicePlan:
    if isinstance(plan, DevicePlan):
        return plan
    if isinstance(plan, CascadePlan):
        return DevicePlan.from_plan(plan)
    raise TypeError(f"expected CascadePlan or DevicePlan, got {type(plan).__name__}")


def host_producer(scorer, plan, batch, device="cuda"):
    """Adapt a ``StageScorer`` (bound onto ``device``) or an already-bound
    ``BoundScorer`` to the host ``ChunkedExecutor`` producer contract ->
    ``(producer, n)``.

    The producer drives the bound scorer's ``stage`` protocol over the
    requested rows on the scorer's device (where its ``prepare`` put the
    operand): each call is W wide (the scorer's uniform stage width), its
    rows padded to the scorer's ``block_n`` as ``ops._bucket_rows`` pads
    them, and the result is sliced back to the rows and to ``t1 - t0``
    columns, as f64 numpy.  A stateful scorer's state lives here for the
    whole batch: each call gathers the requested rows' state, stages it,
    and scatters back only the ``m`` real rows (a pad row repeats a real
    one and must not advance its state twice).
    """
    dplan = _as_device_plan(plan)
    bound = scorer.bind(dplan, device=device) if isinstance(scorer, StageScorer) else scorer
    if not isinstance(bound, BoundScorer):
        raise TypeError(f"expected a StageScorer or BoundScorer, got {type(scorer).__name__}")
    x = bound.prepare(batch)
    n = int(x.shape[0])
    state = bound.init_state(n, x.device)

    def producer(rows, t0, t1):
        m = len(rows)
        if m == 0:
            return np.zeros((0, t1 - t0), dtype=np.float64)
        # the kernel-backed scorers compute at their own block_n granularity
        rows_t, _ = _bucket_rows(
            torch.as_tensor(np.asarray(rows, dtype=np.int64), device=x.device),
            bound.block_n or 1,
        )
        sub = {name: buf[rows_t] for name, buf in state.items()}
        scores, sub_new = bound.stage(sub, int(t0), int(t0) + bound.width, rows_t, x, m)
        for name, buf in state.items():
            buf[rows_t[:m]] = sub_new[name][:m]
        return _numpy(scores)[:m, : t1 - t0].astype(np.float64)

    return producer, n
