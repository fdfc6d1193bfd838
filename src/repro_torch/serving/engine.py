"""Batched-request QWYC serving engine, the counterpart of
``repro.serving.engine`` (``QWYCServer``; the streaming server, the
admission quarantine, the drift watchdog, the mesh and the degradation
ladder are later slices, ROADMAP.md).

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.api.registry import resolve_backend
from repro_torch.api.scorers import StageScorer
from repro_torch.core.executor import CascadePlan, matrix_producer
from repro_torch.core.qwyc import QWYCModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.device_executor import DevicePlan, matrix_stage_scorer

__all__ = ["ServeStats", "QWYCServer", "BACKENDS"]

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
        self._seq = 0
        self._dev: tuple | None = None

    def submit(self, x) -> None:
        self._queue.append(np.asarray(x, dtype=np.float32))
        self._qseqs.append(self._seq)
        self._seq += 1
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
        """(executor, scorer, eager_matrix, key_fn), built once per server:
        the device plan (with its lead stage under ``sorted-kernel``) is
        fixed at construction, and partial final flushes are padded up to
        ``flush_size`` via ``run(capacity=...)``."""
        if self._dev is not None:
            return self._dev
        plan = self.plan
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
            # sort key = first cascade model's scores, computed on the
            # device from the same stage-0 slab the loop body uses
            cap = executor._cap(self.flush_size)
            rows_all = torch.arange(cap, device=dev)

            def key_fn(x, n):
                return scorer.fn(x, rows_all, 0, n)[:, 0]

        self._dev = (executor, scorer, eager_matrix, key_fn)
        return self._dev

    def _run_device(self, xb: np.ndarray, n: int):
        """Device path for one batch -> (result, ordered|None, billed).

        ``billed`` is the serving-work score count: the executor's slab
        billing plus (for ``sorted-kernel`` with a lazy scorer) the
        sort-key slab, which scores stage 0 once more.
        """
        executor, scorer, eager_matrix, key_fn = self._device_state()
        cap = executor._cap(max(n, self.flush_size))
        ordered = None
        if eager_matrix:
            ordered = _numpy(self.score_fn(self._tensor(xb)))[:, self.qwyc.order]
            batch = ordered
        else:
            batch = xb
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

    def flush(self) -> list[dict]:
        if not self._queue:
            return []
        t_start = time.time()
        xb = np.stack(self._queue)
        seqs = self._qseqs
        self._queue = []
        self._qseqs = []
        n = xb.shape[0]
        if self.on_device:
            res, ordered, device_billed = self._run_device(xb, n)
            # the host chunk producer doubles as the unbilled audit path
            audit_read = (
                self._producers(xb)[0] if self.chunk_score_fn is not None else None
            )
        else:
            res, ordered, audit_read, device_billed = self._run_host(xb, n)
        return self._finish_flush(
            t_start, xb, n, res, ordered, audit_read, device_billed, seqs
        )

    def _run_host(self, xb: np.ndarray, n: int):
        """Host stage-loop path for one batch ->
        (result, ordered|None, audit_read, billed=None)."""
        plan = self.plan
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
            st.diffs_vs_full += int((dec != (full_score >= m.beta)).sum())
        st.wall_s += time.time() - t_start
        return out

    def drain(self) -> list[dict]:
        self.flush()
        merged = sorted(self._results, key=lambda t: t[0])
        self._results = []
        return [d for _, d in merged]
