"""Batched-request QWYC serving engine, the counterpart of
``repro.serving.engine`` (``QWYCServer`` and ``StreamingServer``, with
guarded serving; the mesh is a later slice, ROADMAP A15).

Requests (feature vectors) arrive one at a time; the server micro-batches
them and runs the cascade through an execution backend:

  * ``exec_backend="device"`` (what ``"auto"`` resolves to): the whole
    stage loop on the device with no host sync
    (``kernels/device_executor.py``), scoring with ``scorer=`` (a
    ``StageScorer`` template) or, eagerly, from ``score_fn``'s matrix.
  * ``exec_backend="host"`` (only when named): the per-stage host loop
    over ``chunk_score_fn`` or ``score_fn``, the semantics oracle.

Three policies differ in batching/sorting and the decide:

  * "cascade-scan":   reference numpy decide per stage on the host loop
                      (on the device loop it runs as "kernel").
  * "kernel":         the chunk-decide kernel per stage.
  * "sorted-kernel":  rows sorted by the first cascade model's score before
                      execution, so easy rows cluster into blocks that
                      retire early; results are scattered back to
                      submission order.

Filter-and-Score mode (neg_only): positively classified requests get the
full ensemble score attached — lazily, since a neg_only positive ran the
whole cascade (its ``g_final`` IS the full score).

``StreamingServer`` serves continuously instead of batch at a time: queued
requests wait in an arrival-order queue, and each window of them streams
through the device executor's admission ring (``run_stream``), which
refills freed survivor lanes mid-cascade.  Per-request latency (in stage
steps) and lane occupancy land in ``ServeStats``.

Guarded serving: ``quarantine`` (default on) validates every ``submit``
(float32-convertible, the shape of the first accepted row, all finite) and
answers a rejected row at drain time with ``{"quarantined": True,
"decision": None}`` at its submission position, so one poisoned row never
reaches a device batch.  ``watchdog`` runs the sequential drift test over
the audit stream (``serving/watchdog.py``) and widens the thresholds of
the next flushes on alarm.  A wave that fails with an injected fault is
retried with backoff, then falls device -> host
(``api.backends.DegradationLadder``), recorded in
``ServeStats.degradation_events``; any other error propagates (ROADMAP
C11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.api.backends import RETRYABLE, BackoffPolicy, DegradationLadder
from repro_torch.api.registry import resolve_backend
from repro_torch.api.scorers import StageScorer
from repro_torch.core.executor import CascadePlan, matrix_producer
from repro_torch.core.qwyc import QWYCModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.device_executor import DevicePlan, matrix_stage_scorer
from repro_torch.serving.watchdog import DriftWatchdog, WatchdogConfig, widen_plan

__all__ = ["ServeStats", "QWYCServer", "StreamingServer", "BACKENDS"]

BACKENDS = ("cascade-scan", "kernel", "sorted-kernel")


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0
    n_batches: int = 0
    models_evaluated: int = 0  # sum of exit steps (paper's modeled count)
    full_cost: float = 0.0
    actual_cost: float = 0.0  # modeled cost at the paper's accounting
    diffs_vs_full: int = 0
    wall_s: float = 0.0
    # lazy-execution accounting: what was ACTUALLY computed, vs modeled
    scores_computed: int = 0  # base-model scores produced on the serving path
    scores_possible: int = 0  # N * T — the eager full-matrix bill
    audit_scores: int = 0  # extra scores for diff auditing (not serving work)
    chunk_survivors: list[int] = dataclasses.field(default_factory=list)
    # chunk_survivors[k] = total rows that entered stage k, summed over batches
    # streaming accounting (StreamingServer; all in deterministic stage steps)
    admitted_rows: int = 0  # rows admitted into stream survivor slots
    stream_steps: int = 0  # total streaming loop steps executed
    stream_slot_steps: int = 0  # sum over steps of live slots (occupancy mass)
    stream_cap_steps: int = 0  # sum over steps of slot capacity
    latency_steps: list[int] = dataclasses.field(default_factory=list)
    # latency_steps[i] = enqueue->decision latency of request i, in steps
    # guarded-serving accounting, outside the billing gate's keys
    quarantined: int = 0  # rows rejected at admission (never batched)
    degradation_events: list = dataclasses.field(default_factory=list)
    # DegradationEvent per ladder action: same-rung recovery or rung fall
    watchdog_alarms: int = 0
    watchdog_state: str = "off"  # off | ok | alarmed | recovering
    watchdog_stat: float = 0.0  # current sequential llr
    watchdog_margin: float = 0.0  # threshold widening in force next flush
    watchdog_recovery_step: int | None = None  # flush index of last recovery

    @property
    def mean_models(self) -> float:
        return self.models_evaluated / max(self.n_requests, 1)

    @property
    def speedup(self) -> float:
        return self.full_cost / max(self.actual_cost, 1e-9)

    @property
    def diff_rate(self) -> float:
        return self.diffs_vs_full / max(self.n_requests, 1)

    @property
    def compute_fraction(self) -> float:
        """Scores actually produced / scores the eager path would produce."""
        return self.scores_computed / max(self.scores_possible, 1)

    @property
    def mean_occupancy(self) -> float:
        """Mean live-slot fraction over all streaming loop steps."""
        return self.stream_slot_steps / max(self.stream_cap_steps, 1)

    def latency_pct(self, q: float) -> float:
        """q-th percentile of per-request enqueue->decision latency
        (stage steps)."""
        if not self.latency_steps:
            return 0.0
        return float(np.percentile(np.asarray(self.latency_steps), q))

    @property
    def latency_mean(self) -> float:
        if not self.latency_steps:
            return 0.0
        return float(np.mean(self.latency_steps))

    @property
    def latency_p50(self) -> float:
        return self.latency_pct(50)

    @property
    def latency_p95(self) -> float:
        return self.latency_pct(95)

    @property
    def latency_p99(self) -> float:
        return self.latency_pct(99)


class QWYCServer:
    def __init__(
        self,
        qwyc: QWYCModel,
        score_fn: Callable | None = None,
        batch_size: int = 256,
        backend: str = "sorted-kernel",
        block_n: int = 64,
        chunk_t: int = 8,
        chunk_score_fn: Callable | None = None,
        audit_full_scores: bool = True,
        score_block_n: int = 1,
        scorer: StageScorer | None = None,
        exec_backend="auto",
        backend_opts: dict | None = None,
        device="cuda",
        quarantine: bool = True,
        watchdog: bool | WatchdogConfig | DriftWatchdog | None = None,
        backoff: BackoffPolicy | None = None,
        sleep: Callable[[float], None] | None = None,
    ):
        """At least one of ``score_fn`` (x -> (N, T) scores in ORIGINAL
        model order, eager), ``chunk_score_fn`` (x, rows, t0, t1 -> scores
        of cascade positions [t0, t1) for those rows, lazy) or ``scorer``
        (with the device backend) is required; when several are given the
        laziest serving path wins.  ``x`` reaches the score functions as a
        float32 tensor on ``device``; they may return tensors or arrays.

        ``audit_full_scores`` recomputes early-exited rows' full scores
        for the diff-vs-full accounting (audit work, billed apart).
        ``score_block_n`` is ``chunk_score_fn``'s row-block granularity,
        which the host loop bills at.  ``backend_opts`` forwards options
        (``megakernel=``) to the backend's ``make_executor``.  ``device``
        defaults to the card and raises without one; ``"cpu"`` runs every
        kernel's plain version.

        Guarded serving: ``quarantine`` (default on) validates every
        ``submit``, and rejected rows come back from ``drain`` with an
        explicit ``quarantined`` verdict.  ``watchdog`` (True, a
        ``WatchdogConfig`` or a ``DriftWatchdog``) runs the drift test over
        the audit stream and widens the thresholds on alarm; it needs an
        audited configuration (``score_fn``, or ``chunk_score_fn`` with
        ``audit_full_scores=True``).  ``backoff`` / ``sleep`` tune the
        degradation ladder that retries a wave failed by an injected fault
        and falls device -> host (``sleep`` is injectable so tests never
        wait); its history lands in ``ServeStats.degradation_events``.
        """
        if scorer is not None and not isinstance(scorer, StageScorer):
            raise TypeError(
                f"scorer= must be a repro_torch StageScorer, got {type(scorer).__name__}"
            )
        self.torch_device = resolve_device(device)
        self.exec = resolve_backend(exec_backend, device=self.torch_device)
        on_device = self.exec.capabilities.on_device
        if score_fn is None and chunk_score_fn is None and (not on_device or scorer is None):
            raise ValueError(
                "need score_fn, chunk_score_fn, or the device backend with scorer="
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        if scorer is not None and not on_device:
            raise ValueError("scorer= requires the device backend")
        if on_device and scorer is None and score_fn is None:
            raise ValueError("on-device serving needs scorer= or score_fn")
        self.qwyc = qwyc
        self.score_fn = score_fn
        self.chunk_score_fn = chunk_score_fn
        self.batch_size = batch_size
        self.backend = backend
        self.block_n = block_n
        self.chunk_t = chunk_t
        self.audit_full_scores = audit_full_scores
        self.score_block_n = max(1, int(score_block_n))
        self.on_device = on_device
        self.scorer_template = scorer
        self._exec_opts = dict(backend_opts or {})
        self.flush_size = batch_size
        self.plan = CascadePlan.from_qwyc(qwyc, chunk_t=chunk_t)
        self.stats = ServeStats()
        self._queue: list[np.ndarray] = []
        self._qseqs: list[int] = []  # submission seq of each queued row
        self._results: list[tuple[int, dict]] = []  # (seq, result)
        self._quarantined: list[tuple[int, dict]] = []
        self._seq = 0
        self._dev: tuple | None = None  # the ACTIVE device-executor state
        # executor state per (rung, watchdog margin): a widened plan is
        # another program, and a rung fall another executor
        self._dev_cache: dict[tuple, tuple] = {}
        # the executor result of every flush, in order (per-row g_final,
        # billing); StreamingServer keeps its waves' in stream_results
        self.flush_results: list = []
        self.quarantine = bool(quarantine)
        self._row_shape: tuple | None = None  # admission shape lock
        self.ladder = DegradationLadder(
            backoff=backoff, sleep=sleep, events=self.stats.degradation_events
        )
        if watchdog is True:
            watchdog = WatchdogConfig(p0=float(getattr(qwyc, "alpha", 0.0) or 0.0))
        if isinstance(watchdog, WatchdogConfig):
            watchdog = DriftWatchdog(watchdog)
        self._watchdog: DriftWatchdog | None = watchdog or None
        self._wd_margin = 0.0
        if self._watchdog is not None:
            audited = (chunk_score_fn is not None and audit_full_scores) or (
                score_fn is not None and scorer is None
            )
            if not audited:
                raise ValueError(
                    "watchdog needs the per-flush audit signal: pass score_fn, "
                    "or chunk_score_fn with audit_full_scores=True"
                )
            self.stats.watchdog_state = self._watchdog.state

    def _admit(self, x) -> tuple[int, np.ndarray | None]:
        """Admission guard: (seq, float32 row) for a clean request, or
        (seq, None) after quarantining a poisoned one.

        The guard runs before admission, so one poisoned row never NaNs a
        whole device batch; the row still gets a ``drain`` entry
        (``quarantined: True, decision: None``) at its submission position.
        With ``quarantine=False`` a conversion error raises.
        """
        seq = self._seq
        self._seq += 1
        if not self.quarantine:
            return seq, np.asarray(x, dtype=np.float32)
        reason = None
        row = None
        try:
            row = np.asarray(x, dtype=np.float32)
        except (TypeError, ValueError) as e:
            reason = f"not convertible to float32: {e}"
        if reason is None:
            if self._row_shape is None:
                self._row_shape = row.shape
            elif row.shape != self._row_shape:
                reason = f"shape {row.shape} != locked request shape {self._row_shape}"
        if reason is None and not np.isfinite(row).all():
            reason = "non-finite feature value (NaN/inf)"
        if reason is None:
            return seq, row
        self._quarantined.append(
            (seq, {"quarantined": True, "decision": None,
                   "models_evaluated": 0, "reason": reason})
        )
        self.stats.quarantined += 1
        return seq, None

    def submit(self, x) -> None:
        seq, row = self._admit(x)
        if row is None:
            return
        self._queue.append(row)
        self._qseqs.append(seq)
        if len(self._queue) >= self.flush_size:
            self.flush()

    def _tensor(self, xb: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(xb).to(self.torch_device)

    def _producers(self, xb: np.ndarray):
        """(producer, ordered_matrix|None) for this batch; ``producer``
        doubles as the audit access path."""
        if self.chunk_score_fn is not None:
            xb_t = self._tensor(xb)

            def producer(rows, t0, t1):
                return _numpy(self.chunk_score_fn(xb_t, np.asarray(rows), t0, t1))

            return producer, None
        ordered = _numpy(self.score_fn(self._tensor(xb)))[:, self.qwyc.order]
        return matrix_producer(ordered), ordered

    def _device_state(self):
        """(executor, scorer, eager_matrix, key_fn) of the active rung and
        watchdog margin, built once each: the device plan (with its lead
        stage under ``sorted-kernel``) is fixed per key, and partial final
        flushes are padded up to ``flush_size`` via ``run(capacity=...)``.
        ``self._dev`` holds the active one."""
        key = (self.exec.name, self._wd_margin)
        cached = self._dev_cache.get(key)
        if cached is not None:
            self._dev = cached
            return cached
        plan = widen_plan(self.plan, self._wd_margin)
        if self.backend == "sorted-kernel":
            plan = dataclasses.replace(plan, lead_t=1)
        dplan = DevicePlan.from_plan(plan)
        dev = self.torch_device
        if self.scorer_template is not None:
            scorer = self.scorer_template.bind(dplan, device=dev)
            eager_matrix = False
        else:
            scorer = matrix_stage_scorer(dplan, device=dev)
            eager_matrix = True
        executor = self.exec.make_executor(
            dplan, scorer=scorer, block_n=self.block_n, device=dev, **self._exec_opts
        )
        key_fn = None
        if self.backend == "sorted-kernel" and not eager_matrix:
            if scorer.fn is None:
                raise ValueError(
                    "the sorted-kernel policy needs a stateless scorer for "
                    "its sort key (stage-0 scores standalone); stateful "
                    f"scorers like {type(self.scorer_template).__name__} "
                    "serve under the 'kernel' policy"
                )
            # sort key = first cascade model's scores, computed on the
            # device from the same stage-0 slab the loop body uses
            cap = executor._cap(self.flush_size)
            rows_all = torch.arange(cap, device=dev)

            def key_fn(x, n):
                return scorer.fn(x, rows_all, 0, n)[:, 0]

        self._dev = self._dev_cache[key] = (executor, scorer, eager_matrix, key_fn)
        return self._dev

    def _eager_or_raw(self, xb: np.ndarray, eager_matrix: bool):
        """(batch operand, ordered|None) for an on-device run: the eager
        path scores the whole batch once and puts the columns in cascade
        order (the matrix scorer's operand and the full-score source);
        lazy scorers take the raw features."""
        if not eager_matrix:
            return xb, None
        ordered = _numpy(self.score_fn(self._tensor(xb)))[:, self.qwyc.order]
        return ordered, ordered

    def _run_device(self, xb: np.ndarray, n: int):
        """Device path for one batch -> (result, ordered|None, billed).

        ``billed`` is the serving-work score count: the executor's slab
        billing plus (for ``sorted-kernel`` with a lazy scorer) the
        sort-key slab, which scores stage 0 once more.
        """
        executor, scorer, eager_matrix, key_fn = self._device_state()
        cap = executor._cap(max(n, self.flush_size))
        batch, ordered = self._eager_or_raw(xb, eager_matrix)
        row_order = None
        key_scores = 0
        prepared = False
        if self.backend == "sorted-kernel":
            if eager_matrix:
                row_order = np.argsort(ordered[:, 0], kind="stable")
            else:
                # prepare + pad ONCE; the key and the executor share the
                # operand, and the stable sort stays on the device
                batch = scorer.prepare(batch)
                batch = torch.nn.functional.pad(batch, (0, 0, 0, cap - batch.shape[0]))
                prepared = True
                row_order = torch.argsort(key_fn(batch, n)[:n], stable=True)
                kb = scorer.block_n or self.block_n
                key_scores = -(-n // kb) * kb * scorer.width
        res = executor.run(
            batch, n, row_order=row_order, capacity=self.flush_size, prepared=prepared
        )
        billed = n * self.qwyc.T if eager_matrix else res.scores_computed + key_scores
        return res, ordered, billed

    def _fall_rung(self, error, *, streaming: bool = False) -> None:
        """Fall one rung after a failed wave and drop the executor state;
        re-raises ``error`` when no acceptable rung remains."""

        def accept(b):
            caps = b.capabilities
            if streaming and not caps.streaming:
                return False
            if caps.on_device:
                return self.scorer_template is not None or self.score_fn is not None
            # the host floor needs a host-side score source
            return self.score_fn is not None or self.chunk_score_fn is not None

        nxt = self.ladder.fall("wave", self.exec.name, error, accept=accept)
        self.exec = nxt
        self.on_device = nxt.capabilities.on_device
        if not self.on_device:
            self.scorer_template = None
        self._dev = None
        self._dev_cache.clear()

    def flush(self) -> list[dict]:
        if not self._queue:
            return []
        t_start = time.time()
        xb = np.stack(self._queue)
        seqs = self._qseqs
        self._queue = []
        self._qseqs = []
        n = xb.shape[0]
        # the wave ladder: retry the rung with backoff, then fall one rung
        # and re-run the SAME batch, so no request is lost to a fault
        while True:
            try:
                if self.on_device:
                    res, ordered, device_billed = self.ladder.attempt(
                        "wave", self.exec.name, lambda: self._run_device(xb, n)
                    )
                    # the host chunk producer doubles as the unbilled audit path
                    audit_read = (
                        self._producers(xb)[0] if self.chunk_score_fn is not None else None
                    )
                else:
                    res, ordered, audit_read, device_billed = self.ladder.attempt(
                        "wave", self.exec.name, lambda: self._run_host(xb, n)
                    )
                break
            except RETRYABLE as e:
                self._fall_rung(e)
        self.flush_results.append(res)
        return self._finish_flush(
            t_start, xb, n, res, ordered, audit_read, device_billed, seqs
        )

    def _run_host(self, xb: np.ndarray, n: int):
        """Host stage-loop path for one batch ->
        (result, ordered|None, audit_read, billed=None)."""
        plan = widen_plan(self.plan, self._wd_margin)
        producer, ordered = self._producers(xb)
        audit_read = producer  # unbilled access path for diff auditing
        row_order = None
        if self.backend == "sorted-kernel":
            # the first model is its own leading stage (lead_t=1): its
            # scores double as the sort key and are billed once, as that
            # stage, through the memo below
            plan = dataclasses.replace(plan, lead_t=1)
            col0 = producer(np.arange(n), 0, 1)
            row_order = np.argsort(col0[:, 0], kind="stable")
            inner = producer

            def producer(rows, t0, t1, _col0=col0, _inner=inner):
                if t0 == 0 and t1 == 1:
                    return _col0[np.asarray(rows)]
                return _inner(rows, t0, t1)

        decide_fn = (
            ops.kernel_decide_fn(block_n=self.block_n, device=self.torch_device)
            if self.backend in ("kernel", "sorted-kernel")
            else None
        )
        res = self.exec.make_executor(
            plan,
            producer=producer,
            decide_fn=decide_fn,
            bill_block=self.score_block_n if ordered is None else 1,
        ).run(n, row_order=row_order)
        return res, ordered, audit_read, None

    def _finish_flush(
        self, t_start, xb, n, res, ordered, audit_read, device_billed, seqs
    ) -> list[dict]:
        """Audit, result assembly and stats — shared by host & device paths.
        ``device_billed`` is None on the host path."""
        m = self.qwyc
        T = m.T
        dec, exit_step = res.decisions, res.exit_step

        # full-ensemble score: free for rows that ran the whole cascade;
        # early-exited rows need an audit read (accounted separately)
        audit_scores = 0
        if ordered is not None:
            full_score = ordered.sum(axis=1)
        elif self.audit_full_scores and audit_read is not None:
            full_score = res.g_final.astype(np.float64, copy=True)
            exited = np.nonzero(exit_step < T)[0]
            if exited.size:
                full_score[exited] = audit_read(exited, 0, T).sum(axis=1)
                audit_scores = int(exited.size) * T
        else:
            full_score = None

        cum_cost = self.plan.cum_costs()
        out = []
        for i in range(n):
            r = {"decision": bool(dec[i]), "models_evaluated": int(exit_step[i])}
            if m.mode == "neg_only" and dec[i]:
                # Filter-and-Score: a neg_only positive never exited early,
                # so its carried partial sum is the full ensemble score
                r["full_score"] = float(
                    full_score[i] if full_score is not None else res.g_final[i]
                )
            out.append(r)
        self._results.extend(zip(seqs, out))

        st = self.stats
        st.n_requests += n
        st.n_batches += 1
        st.models_evaluated += int(exit_step.sum())
        st.full_cost += float(cum_cost[-1]) * n
        st.actual_cost += float(cum_cost[exit_step - 1].sum())
        if device_billed is not None:
            st.scores_computed += device_billed
        else:
            st.scores_computed += n * T if ordered is not None else res.scores_computed
        st.scores_possible += n * T
        st.audit_scores += audit_scores
        for k, s in enumerate(res.chunk_stats):
            if k >= len(st.chunk_survivors):
                st.chunk_survivors.append(0)
            st.chunk_survivors[k] += s.n_in
        if full_score is not None:
            diffs = int((dec != (full_score >= m.beta)).sum())
            st.diffs_vs_full += diffs
            if self._watchdog is not None:
                # fold this flush into the sequential drift statistic; the
                # returned margin widens the NEXT flush's thresholds
                self._wd_margin = self._watchdog.observe(n, diffs)
                st.watchdog_alarms = self._watchdog.alarms
                st.watchdog_state = self._watchdog.state
                st.watchdog_stat = self._watchdog.llr
                st.watchdog_margin = self._wd_margin
                st.watchdog_recovery_step = self._watchdog.recovery_step
        st.wall_s += time.time() - t_start
        return out

    def _merge_results(self) -> list[dict]:
        """Every result not drained yet, the flushed and the quarantined,
        in submission order."""
        merged = sorted(self._results + self._quarantined, key=lambda t: t[0])
        self._results = []
        self._quarantined = []
        return [d for _, d in merged]

    def drain(self) -> list[dict]:
        self.flush()
        return self._merge_results()


class StreamingServer(QWYCServer):
    """Continuous-batching server: admit queued requests into freed
    survivor lanes mid-cascade.

    The flush server (``QWYCServer``) serves batch at a time: a flush's
    fixed-capacity survivor buffers drain as rows exit, and the mostly idle
    tail of the cascade holds the NEXT batch's requests hostage.  This
    server keeps an arrival-order queue, stamps every request with an
    arrival step, and hands windows of pending requests to the executor's
    admission ring (``run_stream``): freed lanes are refilled mid-cascade,
    admitted rows start at stage 0 next to mid-cascade ones, and the
    decisions stay equal per row to the batch path's.

    * ``batch_size`` is the survivor-lane CAPACITY (the in-flight
      concurrency), the "equal capacity" knob the flush server compares at.
    * ``window`` is the admission-ring size: how many queued requests one
      device wave streams through (default ``4 x`` the capacity).
    * ``max_wait`` (stage steps) is the admission deadline: a submit that
      finds the oldest queued request waiting ``>= max_wait`` launches a
      PARTIAL wave instead of holding out for a full window.
    * latency is accounted end to end in stage steps: queue wait before the
      wave + ring wait + service (``ServeStats.latency_steps``).

    Streaming admission replaces the sorting policy (the ring is the
    arrival order), so only the ``kernel`` policy is accepted, and the
    execution backend needs the ``streaming`` capability (the device
    backend; the host loop has no lanes to refill), so a wave failed by an
    injected fault retries on its rung and has no rung to fall to.
    Quarantine keeps submission order.
    """

    def __init__(
        self,
        qwyc: QWYCModel,
        *,
        window: int | None = None,
        max_wait: float | None = None,
        backend: str = "kernel",
        exec_backend="auto",
        **kw,
    ):
        if backend != "kernel":
            raise ValueError(
                "StreamingServer: streaming admission replaces the sorting "
                f"policy; only backend='kernel' is supported (got {backend!r})"
            )
        super().__init__(qwyc, backend=backend, exec_backend=exec_backend, **kw)
        if not self.exec.capabilities.streaming:
            raise ValueError(
                f"exec_backend {self.exec.name!r} does not support streaming "
                "admission (needs an on-device executor with run_stream)"
            )
        self.window = int(window) if window else 4 * self.flush_size
        if self.window < self.flush_size:
            raise ValueError(
                f"window ({self.window}) must be >= the slot capacity "
                f"({self.flush_size}); a smaller ring can never fill the slots"
            )
        self.max_wait = None if max_wait is None else float(max_wait)
        self._squeue: list[tuple[np.ndarray, float, int]] = []
        self._clock = 0.0
        # per-wave StreamResults: the timeline of every wave
        self.stream_results: list = []

    def submit(self, x, arrival: float | None = None) -> None:
        """Enqueue a request at ``arrival`` (stage-step units, nondecreasing
        across submits; default: the last stamp seen).  A full window, or a
        ``max_wait`` deadline breach, launches a device wave."""
        a = self._clock if arrival is None else float(arrival)
        if a < self._clock:
            raise ValueError(
                f"arrivals must be nondecreasing (got {a} after {self._clock})"
            )
        self._clock = a
        seq, row = self._admit(x)
        if row is None:
            return
        self._squeue.append((row, a, seq))
        if len(self._squeue) >= self.window:
            self.flush()
        elif self.max_wait is not None and a - self._squeue[0][1] >= self.max_wait:
            self.flush()

    def flush(self) -> list[dict]:
        """Stream one window (possibly partial) of queued requests."""
        if not self._squeue:
            return []
        t_start = time.time()
        wave, self._squeue = self._squeue[: self.window], self._squeue[self.window :]
        xb = np.stack([e[0] for e in wave])
        seqs = [e[2] for e in wave]
        n = xb.shape[0]
        base = wave[0][1]
        arr_steps = np.floor(np.array([e[1] for e in wave]) - base).astype(np.int32)
        # the wave ladder, streaming edition: only rungs with the streaming
        # capability are acceptable (the host loop has no admission ring)
        while True:
            try:
                executor, _, eager_matrix, _ = self._device_state()
                batch, ordered = self._eager_or_raw(xb, eager_matrix)
                res = self.ladder.attempt(
                    "wave", self.exec.name,
                    lambda: executor.run_stream(
                        batch, n, arrivals=arr_steps, capacity=self.flush_size,
                        ring_capacity=self.window,
                    ),
                )
                break
            except RETRYABLE as e:
                self._fall_rung(e, streaming=True)
        billed = n * self.qwyc.T if eager_matrix else res.scores_computed
        audit_read = (
            self._producers(xb)[0] if self.chunk_score_fn is not None else None
        )
        out = self._finish_flush(t_start, xb, n, res, ordered, audit_read, billed, seqs)
        self.stream_results.append(res)
        st = self.stats
        st.admitted_rows += n
        st.stream_steps += res.steps_run
        st.stream_slot_steps += int(res.occupancy.sum())
        st.stream_cap_steps += res.steps_run * res.capacity
        # end-to-end latency: steps queued BEFORE the wave launched (launch
        # = the wave's first arrival) + ring wait + service
        st.latency_steps.extend((res.done_step - arr_steps + 1).astype(int).tolist())
        return out

    def drain(self) -> list[dict]:
        while self._squeue:
            self.flush()
        return self._merge_results()
