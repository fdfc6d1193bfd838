"""The QWYC pipeline: ``fit -> compile -> evaluate / rank / serve``, the
counterpart of ``repro.api.pipeline``.

    fitted   = api.fit(scores_or_score_fn, X, beta=..., alpha=...)
    compiled = fitted.compile("auto")          # or "host" | "device"
    result   = compiled.evaluate(scores=F_test)
    server   = compiled.serve(score_fn=score_fn, batch_size=256)

    ranked   = api.fit(F, groups=sizes, topk=10, alpha=0.05)
    verdicts = ranked.compile("device").rank(scores=F_test, groups=sizes_test)

``fit`` wraps Algorithm 1 (joint order + threshold optimization), or with
``groups=`` the grouped (ranking) fit; ``compile`` resolves an execution
backend through the registry and binds the cascade plan to it;
``evaluate`` runs one batch; ``rank`` ranks one batch of ragged query
groups; ``serve`` builds a ``QWYCServer`` / ``StreamingServer`` (or, for a
grouped fit, a ``GroupedRankServer``) on the same backend.

``compile`` defaults to ``device="cuda"`` and raises without a card unless
the CPU is named; ``"auto"`` is always the device backend, and ``host``
runs only when named or reached down the runtime degradation ladder
(``api.backends.DegradationLadder``): an injected construction or wave
fault is retried with backoff, then falls device -> host, each step
recorded on ``CompiledCascade.degradation_events``.  Any other error
propagates (ROADMAP C11).  The mesh and shard options, whose executors
are not ported, raise ``ValueError`` naming ROADMAP A15.

A model-backed fit (``fit(NeuralScorer(params, cfg, seq_len), tokens)``)
calibrates on the scorer's own per-block scores, pins the fields its
family requires (depth order, layer costs), and keeps the scorer as the
default that ``compile`` and ``serve`` bind.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.backends import RETRYABLE, BackoffPolicy, DegradationLadder
from repro_torch.api.registry import AUTO, backend_names, get_backend, resolve_backend
from repro_torch.api.scorers import StageScorer, host_producer
from repro_torch.core.executor import (
    DEFAULT_CHUNK_T,
    CascadePlan,
    ExecutorResult,
    matrix_producer,
)
from repro_torch.core.qwyc import QWYCModel, fit_qwyc
from repro_torch.device import resolve_device
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    DevicePlan,
    matrix_stage_scorer,
)
from repro_torch.ranking import GroupedRankServer, fit_grouped, group_offsets

__all__ = ["FitConfig", "FittedCascade", "CompiledCascade", "fit"]

_SHARDED_TODO = (
    "mesh/shards/model_shards/rebalance need the sharded executors, not "
    "ported yet (ROADMAP A15)"
)


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _device_scores(score_fn, x, device: torch.device):
    """``score_fn`` over the inputs ``x``, handed over as a float32 tensor
    on ``device`` (as the servers hand them over); its output as it is."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return score_fn(x.to(device))


def _score(score_fn, x, device: torch.device) -> np.ndarray:
    """``_device_scores`` as a host array."""
    return _numpy(_device_scores(score_fn, x, device))


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Calibration + planning knobs for ``fit`` (defaults = ``fit_qwyc``'s).

    ``alpha`` is the allowed disagreement rate vs the FULL ensemble (QWYC
    needs no labels).  ``chunk_t`` is the default stage width ``compile``
    splits the cascade into.
    """

    beta: float = 0.0
    alpha: float = 0.0
    mode: str = "both"
    costs: Any = None
    optimize_order: bool = True
    order: Any = None
    verbose: bool = False
    chunk_t: int = DEFAULT_CHUNK_T


def _normalize_config(config, overrides: dict) -> FitConfig:
    if config is None:
        cfg = FitConfig()
    elif isinstance(config, FitConfig):
        cfg = config
    elif isinstance(config, dict):
        cfg = FitConfig(**config)
    else:
        raise TypeError(f"config must be FitConfig/dict/None, got {type(config)}")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def fit(
    ensemble,
    X=None,
    y=None,
    config: FitConfig | dict | None = None,
    *,
    groups=None,
    topk: int | None = None,
    device="cuda",
    **overrides,
) -> "FittedCascade":
    """Jointly optimize evaluation order + early-exit thresholds.

    Args:
      ensemble: a precomputed calibration score matrix ``(N, T)`` with
        ``F[i, t] = f_t(x_i)`` (original model order; an array or a
        tensor), or a callable ``score_fn(X) -> (N, T)``, the ensemble's
        batched scorer (e.g. a closure over ``ops.gbt_scores``), kept on
        the result so ``evaluate(x=...)``, ``rank(x=...)`` and ``serve()``
        can score with it.  It receives ``X`` as a float32 tensor on
        ``device``.  Or a ``StageScorer`` that scores itself (the
        model-backed fit): ``NeuralScorer(params, cfg, seq_len)``
        calibrates on its per-block logit margins
        (``calibration_scores``, on its params' device), pins the config
        fields its family requires (depth order, layer costs; explicit
        user ``costs`` win), and becomes the default scorer of
        ``compile`` / ``serve``.
      X: calibration features (tokens, for the neural scorer); required
        iff ``ensemble`` is callable or a ``StageScorer``.
      y: unused (calibration is label-free); accepted for symmetry.
      groups: per-QUERY document counts ``(G,)`` for ranking ensembles:
        calibration rows become ragged query groups (contiguous in the
        score matrix) and the fit also calibrates group-level margin
        thresholds (``ranking.fit_grouped``): a query exits as a unit once
        its top-``topk`` ranking is stable.  The result then supports
        ``compile(...).rank(...)`` and a grouped ``serve()``.
      topk: ranking depth ``k`` for grouped calibration (default 10;
        requires ``groups=``).
      device: where a callable ``ensemble`` scores ``X`` (default the
        card; an error without one).
      config / **overrides: a ``FitConfig`` (or dict), with keyword
        overrides applied on top — ``fit(F, beta=0.5, alpha=0.01)``.
    """
    cfg = _normalize_config(config, overrides)
    score_fn = None
    scorer = None
    if isinstance(ensemble, StageScorer):
        if X is None:
            raise ValueError("fit(scorer, ...) needs calibration inputs X to score")
        scorer = ensemble
        score_fn = scorer.calibration_scores
        F = np.asarray(score_fn(X))
        forced = dict(scorer.fit_overrides())
        if cfg.costs is not None:
            forced.pop("costs", None)  # explicit user costs win
        if forced:
            cfg = dataclasses.replace(cfg, **forced)
    elif callable(ensemble):
        if X is None:
            raise ValueError("fit(score_fn, ...) needs calibration features X to score")
        score_fn = ensemble
        F = _score(ensemble, X, resolve_device(device))
    else:
        F = _numpy(ensemble)
    if F.ndim != 2:
        raise ValueError(f"calibration scores must be (N, T), got {F.shape}")
    if groups is not None:
        grouped = fit_grouped(
            F,
            np.asarray(groups, dtype=np.int64),
            10 if topk is None else int(topk),
            costs=cfg.costs,
            alpha=cfg.alpha,
            beta=cfg.beta,
            mode=cfg.mode,
            optimize_order=cfg.optimize_order,
            order=cfg.order,
            chunk_t=cfg.chunk_t,
            verbose=cfg.verbose,
        )
        return FittedCascade(
            model=grouped.model, config=cfg, score_fn=score_fn,
            calibration_scores=F, scorer=scorer, grouped=grouped,
        )
    if topk is not None:
        raise ValueError("topk= requires groups= (per-query document counts)")
    model = fit_qwyc(
        F,
        costs=cfg.costs,
        beta=cfg.beta,
        alpha=cfg.alpha,
        mode=cfg.mode,
        optimize_order=cfg.optimize_order,
        order=cfg.order,
        verbose=cfg.verbose,
    )
    return FittedCascade(
        model=model, config=cfg, score_fn=score_fn, calibration_scores=F, scorer=scorer
    )


@dataclasses.dataclass
class FittedCascade:
    """A fitted QWYC cascade (ordering + thresholds), backend-agnostic.

    ``model`` is the plain ``QWYCModel``; ``calibration_scores`` the (N, T)
    matrix ``fit`` calibrated on (original model order); ``scorer`` the
    ``StageScorer`` template of a model-backed fit, which ``compile`` and
    ``serve`` bind by default; ``grouped`` the ``GroupedPlan`` of
    ``fit(groups=...)`` (None for row-level fits).
    """

    model: QWYCModel
    config: FitConfig = dataclasses.field(default_factory=FitConfig)
    score_fn: Callable | None = None
    calibration_scores: np.ndarray | None = dataclasses.field(default=None, repr=False)
    scorer: StageScorer | None = None
    grouped: Any | None = None

    @property
    def T(self) -> int:
        return self.model.T

    def plan(self, chunk_t: int | None = None) -> CascadePlan:
        return CascadePlan.from_qwyc(
            self.model, chunk_t=self.config.chunk_t if chunk_t is None else chunk_t
        )

    def compile(
        self,
        backend="auto",
        *,
        chunk_t: int | None = None,
        block_n: int | None = None,
        device="cuda",
        decide: str | None = None,
        bill_block: int | None = None,
        scorer: StageScorer | None = None,
        mesh=None,
        shards: int | None = None,
        model_shards: int = 1,
        rebalance: bool = False,
        backoff: BackoffPolicy | None = None,
        sleep=None,
    ) -> "CompiledCascade":
        """Bind the cascade to an execution backend.

        ``backend``: ``"auto"`` (the device backend), ``"device"``,
        ``"host"``, or a backend instance.  ``device``: the torch device
        the executor (and the score functions' inputs) live on; the default
        card raises without one, ``"cpu"`` runs the kernels' plain
        versions.  Host-only options: ``decide`` (``"reference"``, the
        numpy oracle, or ``"kernel"``, the chunk decide B2) and
        ``bill_block``.  ``scorer``: a ``StageScorer`` template for lazy
        scoring (``evaluate(x=...)``; ``serve()`` on the device): the device
        loop's scorer, or on the host the producer ``host_producer`` drives
        on ``device``; it defaults to the template a model-backed ``fit``
        calibrated.  ``backoff`` / ``sleep`` tune the runtime
        degradation ladder (``sleep`` is injectable so tests never wait).
        """
        if mesh is not None or shards is not None or int(model_shards) > 1 or rebalance:
            raise ValueError(_SHARDED_TODO)
        if scorer is None:
            scorer = self.scorer
        if scorer is not None and not isinstance(scorer, StageScorer):
            raise TypeError(
                f"scorer= must be a repro_torch StageScorer, got {type(scorer).__name__}"
            )
        dev = resolve_device(device)
        if isinstance(backend, str) and backend != AUTO:
            try:
                b = get_backend(backend)
            except KeyError:
                raise ValueError(
                    f"unknown backend {backend!r}; registered backends: "
                    f"{list(backend_names())} (or {AUTO!r})"
                ) from None
        else:
            b = resolve_backend(backend, device=dev)
        caps = b.capabilities
        if caps.on_device:
            for opt, val in (("decide", decide), ("bill_block", bill_block)):
                if val is not None:
                    raise ValueError(f"{opt!r} is a host-backend option; backend is {b.name!r}")
        if self.grouped is not None and not caps.grouped:
            raise ValueError(
                f"fit(groups=...) needs a backend with the grouped capability; "
                f"backend {b.name!r} has none"
            )
        return CompiledCascade(
            fitted=self, backend=b, plan=self.plan(chunk_t), device=dev,
            block_n=block_n, decide=decide, bill_block=bill_block, scorer=scorer,
            backoff=backoff, sleep=sleep,
        )


class CompiledCascade:
    """A ``FittedCascade`` bound to one backend, ready to run batches.

    On-device backends construct their executor here; the host backend
    binds a fresh ``ChunkedExecutor`` per call.  ``serve`` builds a server
    on the same backend and device.  An injected construction fault is
    retried, then falls a rung (``degradation_events``).
    """

    def __init__(
        self,
        fitted: FittedCascade,
        backend,
        plan: CascadePlan,
        *,
        device,
        block_n: int | None = None,
        decide: str | None = None,
        bill_block: int | None = None,
        scorer: StageScorer | None = None,
        backoff: BackoffPolicy | None = None,
        sleep=None,
    ):
        self.fitted = fitted
        self.backend = backend
        self.plan = plan
        self.device = resolve_device(device)
        self.block_n = block_n
        self.decide = decide or "reference"
        if self.decide not in ("reference", "kernel"):
            raise ValueError(f"decide must be 'reference' or 'kernel', got {decide!r}")
        self.bill_block = bill_block
        self.scorer_template = scorer
        self.last_rank_stats = None
        self.ladder = DegradationLadder(backoff=backoff, sleep=sleep)
        self._executor = None
        try:
            self._bind_backend(backend)
        except RETRYABLE as e:
            self._fall_and_rebind("construct", e)

    def _fall_and_rebind(self, kind: str, error, accept=None):
        """Fall down the ladder until a backend binds (or the ladder runs
        out and re-raises the last error)."""
        err = error
        while True:
            nxt = self.ladder.fall(kind, self.backend.name, err, accept=accept)
            try:
                self._bind_backend(nxt)
                return nxt
            except RETRYABLE as e:
                err = e

    def _bind_backend(self, backend) -> None:
        """(Re)build the executor for one rung; the host rung binds at
        ``evaluate`` time."""
        self.backend = backend
        if not backend.capabilities.on_device:
            self._executor = None
            return
        dplan = DevicePlan.from_plan(self.plan)
        template = self.scorer_template
        self.scorer = (
            template.bind(dplan, device=self.device)
            if template is not None
            else matrix_stage_scorer(dplan, device=self.device)
        )
        bn = DEFAULT_BLOCK_N if self.block_n is None else self.block_n
        self._executor = self.ladder.attempt(
            "construct", backend.name,
            lambda: backend.make_executor(
                dplan, scorer=self.scorer, block_n=bn, device=self.device
            ),
        )

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def degradation_events(self) -> list:
        """The ladder's history: same-rung recoveries and rung falls."""
        return self.ladder.events

    @property
    def traces(self) -> int | None:
        """The executor's program count (``DeviceExecutor.traces``; None on
        the host backend)."""
        return getattr(self._executor, "traces", None)

    def _ordered_scores(self, scores, x) -> np.ndarray:
        if scores is None:
            if x is None:
                raise ValueError("evaluate() needs scores=, x=, or producer=")
            if self.fitted.score_fn is None:
                raise ValueError(
                    "evaluate(x=...) needs a score_fn captured by fit() (or compile "
                    "with scorer= for lazy scoring on the device)"
                )
            scores = _device_scores(self.fitted.score_fn, x, self.device)
        # the device loop takes a tensor as it is (no round trip through
        # the host); only the host rung works on numpy
        F = scores if isinstance(scores, torch.Tensor) and self._executor is not None else _numpy(scores)
        if F.ndim != 2 or F.shape[1] != self.fitted.T:
            raise ValueError(
                f"scores must be (N, {self.fitted.T}) in original model order, got {F.shape}"
            )
        return F[:, self.fitted.model.order]

    def evaluate(
        self,
        scores=None,
        *,
        x=None,
        producer=None,
        n: int | None = None,
        row_order=None,
        capacity: int | None = None,
    ) -> ExecutorResult:
        """Run the cascade on one batch.

        ``scores``: a precomputed ``(N, T)`` matrix in ORIGINAL model order
        (every backend).  ``x``: the raw batch, fed to the compiled
        ``scorer=`` template (on the device, or through ``host_producer``
        on the host), else scored through the ``fit``-captured
        ``score_fn``.  ``producer(rows, t0, t1)``: a host
        lazy producer in cascade order (host backend, requires ``n``).
        ``row_order`` / ``capacity`` follow the executors' contracts.

        An injected wave fault is retried on the same rung with backoff,
        then falls a rung and re-runs; the host floor is accepted only if
        this call can score there (precomputed ``scores``, a
        ``fit``-captured ``score_fn``, or ``scorer=`` with ``x``).
        """
        while True:
            if not self.backend.capabilities.on_device:
                return self._evaluate_host(scores, x, producer, n, row_order)
            if producer is not None:
                raise ValueError(
                    "producer= is a host-backend option; compile with scorer= for "
                    "lazy scoring on the device"
                )
            if self.scorer_template is not None:
                if x is None:
                    raise ValueError(
                        "compiled with scorer=: pass the scorer's batch operand via x="
                    )
                operand, run_n = x, int(np.shape(x)[0]) if n is None else n
            else:
                operand = self._ordered_scores(scores, x)
                run_n = operand.shape[0]
            ex = self._executor
            try:
                return self.ladder.attempt(
                    "wave", self.backend.name,
                    lambda: ex.run(operand, run_n, row_order=row_order, capacity=capacity),
                )
            except RETRYABLE as e:
                can_host = (
                    scores is not None
                    or self.fitted.score_fn is not None
                    or (self.scorer_template is not None and x is not None)
                )
                self._fall_and_rebind(
                    "wave", e, accept=lambda b: b.capabilities.on_device or can_host
                )

    def _evaluate_host(self, scores, x, producer, n, row_order) -> ExecutorResult:
        if producer is not None:
            if n is None:
                raise ValueError("producer= requires n= (batch row count)")
            p = producer
        elif self.scorer_template is not None and scores is None:
            if x is None:
                raise ValueError("compiled with scorer=: pass the scorer's batch operand via x=")
            # the template bound onto this compile's device, driven stage by
            # stage by the host loop
            p, n = host_producer(self.scorer_template, self.plan, x, device=self.device)
        else:
            ordered = self._ordered_scores(scores, x)
            n = ordered.shape[0]
            p = matrix_producer(ordered)
        decide_fn = None
        bill = 1 if self.bill_block is None else self.bill_block
        if self.decide == "kernel":
            from repro_torch.kernels import ops

            bn = 256 if self.block_n is None else self.block_n
            decide_fn = ops.kernel_decide_fn(block_n=bn, device=self.device)
            if self.bill_block is None:
                bill = bn
        ex = self.backend.make_executor(
            self.plan, producer=p, decide_fn=decide_fn, bill_block=bill
        )
        return ex.run(n, row_order=row_order)

    def _grouped_plan(self):
        """The fit-time ``GroupedPlan``, validated against this compile's
        stage layout."""
        gp = self.fitted.grouped
        if gp is None:
            raise ValueError(
                "no grouped plan: calibrate with fit(..., groups=sizes, topk=k) "
                "to rank ragged query groups"
            )
        if list(self.plan.stages) != list(gp.plan.stages):
            raise ValueError(
                f"compile(chunk_t=...) changed the stage layout "
                f"({len(self.plan.stages)} stages vs the grouped plan's {gp.S}); "
                f"compile with chunk_t={gp.plan.chunk_t} (the fit-time chunking "
                "the group thresholds were calibrated on)"
            )
        if self.scorer_template is not None:
            raise ValueError(
                "grouped ranking scores through the matrix scorer; drop "
                "compile(scorer=...) for rank()/grouped serve()"
            )
        return gp

    def rank(
        self,
        scores=None,
        *,
        x=None,
        groups=None,
        capacity_groups: int | None = None,
        margin_inf: bool = False,
    ) -> list[dict]:
        """Rank one batch of ragged query groups through the grouped
        cascade (requires ``fit(..., groups=)``).

        ``scores`` is the flat ``(N, T)`` per-document score matrix in
        ORIGINAL model order (or pass ``x`` to score through the
        ``fit``-captured ``score_fn``); ``groups`` the per-query document
        counts of THIS batch (documents of each query contiguous).  Returns
        one dict per query, in order: ``"ranking"`` (top-k LOCAL document
        positions), ``"exit_stage"`` (1-based), ``"margin"``.
        ``margin_inf=True`` forces the full cascade.  The flush's billing
        lands on ``last_rank_stats``.
        """
        gp = self._grouped_plan()
        if groups is None:
            raise ValueError("rank() needs groups= (per-query document counts for this batch)")
        if scores is None:
            if x is None:
                raise ValueError("rank() needs scores= or x=")
            if self.fitted.score_fn is None:
                raise ValueError("rank(x=...) needs a score_fn captured by fit()")
            scores = _device_scores(self.fitted.score_fn, x, self.device)
        # the device loop takes a tensor as it is (no round trip through
        # the host); only the host rung works on numpy
        F = scores if isinstance(scores, torch.Tensor) and self._executor is not None else _numpy(scores)
        sizes = np.asarray(groups, dtype=np.int64)
        if F.ndim != 2 or F.shape[1] != self.fitted.T:
            raise ValueError(
                f"scores must be (N, {self.fitted.T}) in original model order, got {F.shape}"
            )
        if sizes.ndim != 1 or int(sizes.sum()) != F.shape[0]:
            raise ValueError(
                f"group sizes sum to {sizes.sum()} but scores have {F.shape[0]} rows"
            )
        server = GroupedRankServer(
            gp,
            executor=self._executor,
            batch_groups=max(int(sizes.size), 1),
            capacity_groups=capacity_groups,
            margin_inf=margin_inf,
            device=self.device,
        )
        offsets = group_offsets(sizes)
        for i in range(sizes.size):
            server.submit(F[offsets[i] : offsets[i + 1]])
        out = server.drain()
        self.last_rank_stats = server.stats
        return out

    def _serve_grouped(
        self,
        *,
        score_fn=None,
        batch_size: int = 32,
        policy: str = "sorted-kernel",
        streaming: bool = False,
        **server_kw,
    ) -> GroupedRankServer:
        """Grouped serving: a ``GroupedRankServer`` on this backend.

        ``batch_size`` counts QUERIES per flush; ``policy`` becomes the
        streaming admission policy (the row-level default maps to
        ``"skip-ahead"``; pass ``"wait"`` for strict arrival order).
        Streaming needs the device backend's grouped admission ring.
        """
        gp = self._grouped_plan()
        if streaming:
            if self._executor is None:
                raise ValueError(
                    "grouped streaming needs an on-device backend with the grouped "
                    "admission ring; compile onto 'device'"
                )
            if not hasattr(self._executor, "run_stream_grouped"):
                raise ValueError(
                    f"backend {self.backend.name!r} has no grouped streaming path; "
                    "compile onto 'device'"
                )
        return GroupedRankServer(
            gp,
            score_fn=self.fitted.score_fn if score_fn is None else score_fn,
            executor=self._executor,
            batch_groups=batch_size,
            streaming=streaming,
            policy="skip-ahead" if policy == "sorted-kernel" else policy,
            device=self.device,
            **server_kw,
        )

    def serve(
        self,
        *,
        score_fn: Callable | None = None,
        chunk_score_fn: Callable | None = None,
        batch_size: int = 256,
        policy: str = "sorted-kernel",
        audit_full_scores: bool = True,
        score_block_n: int = 1,
        streaming: bool = False,
        window: int | None = None,
        max_wait: float | None = None,
        **server_kw,
    ):
        """Build a batched ``QWYCServer`` on this backend and device.

        ``policy`` is the server's sorting/decide policy (``cascade-scan``
        | ``kernel`` | ``sorted-kernel``).  ``score_fn`` defaults to the one
        captured by ``fit``; a compiled ``scorer=`` template becomes the
        server's device scorer.  ``streaming=True`` builds a
        ``StreamingServer`` (``batch_size`` is then the lane capacity,
        ``window`` the admission ring, ``max_wait`` the partial-admission
        deadline in stage steps).

        A grouped fit (``fit(..., groups=)``) serves QUERIES: the call
        returns a ``ranking.GroupedRankServer`` (``batch_size`` counts
        queries per flush; with ``streaming=True`` the grouped admission
        ring, ``policy`` its admission policy: ``"skip-ahead"``, the
        default's mapping, or ``"wait"``).
        """
        if self.fitted.grouped is not None:
            return self._serve_grouped(
                score_fn=score_fn, batch_size=batch_size, policy=policy,
                streaming=streaming, **server_kw,
            )
        from repro_torch.serving.engine import QWYCServer, StreamingServer

        if self.block_n is not None:
            server_kw.setdefault("block_n", self.block_n)
        common = dict(
            score_fn=self.fitted.score_fn if score_fn is None else score_fn,
            chunk_score_fn=chunk_score_fn,
            batch_size=batch_size,
            chunk_t=self.plan.chunk_t,
            audit_full_scores=audit_full_scores,
            score_block_n=score_block_n,
            scorer=self.scorer_template if self.backend.capabilities.on_device else None,
            exec_backend=self.backend,
            device=self.device,
        )
        if streaming:
            if not self.backend.capabilities.streaming:
                raise ValueError(
                    f"backend {self.backend.name!r} does not support streaming "
                    "admission; compile onto 'device'"
                )
            if policy != "sorted-kernel":
                raise ValueError(
                    "streaming admission replaces the sorting policy; drop "
                    f"policy={policy!r} when serving with streaming=True"
                )
            return StreamingServer(
                self.fitted.model, window=window, max_wait=max_wait, **common, **server_kw
            )
        if window is not None or max_wait is not None:
            raise ValueError("window/max_wait require serve(streaming=True)")
        return QWYCServer(self.fitted.model, backend=policy, **common, **server_kw)
