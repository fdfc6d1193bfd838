"""Bucketed ranking server: ragged query groups in, ranked verdicts out
(the counterpart of ``repro.ranking.serving``).

Queries (one ragged document list each) queue up; ``flush`` scores the
queued documents once, packs the groups into rectangular per-bucket
layouts (``ranking.bucketing``) and runs ONE grouped device wave per
bucket shape (``DeviceExecutor.run_grouped``), or the host oracle
(``run_grouped_host``) when there is no executor.  An empty queue
launches nothing.  In streaming mode freed group slots refill
mid-cascade through the executor's grouped admission ring
(``run_stream_grouped``), with the host-side ``AdmissionQueue`` deciding
what enters a wave when the queue head does not fit the wave's bucket
width: ``skip-ahead`` admits the first fitting group (occupancy over
order), ``wait`` keeps strict arrival order (head-of-line blocking).

Verdicts come back per query in submission order as LOCAL document
positions (0-based within the submitted group), mapped from the flat row
ids the executors emit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ranking.bucketing import (
    AdmissionQueue,
    bucket_layout,
    bucket_widths_for,
    group_offsets,
    pack_by_bucket,
)
from repro_torch.ranking.host import run_grouped_host
from repro_torch.ranking.plan import GroupedPlan

__all__ = ["GroupedRankServer", "RankStats"]


@dataclasses.dataclass
class RankStats:
    n_queries: int = 0
    n_docs: int = 0
    n_waves: int = 0  # grouped runs (one per bucket shape per flush, or per wave)
    scores_computed: int = 0  # group-quantized serving bill
    scores_possible: int = 0  # real docs x T
    stages_run: int = 0  # sum of per-query exit stages

    @property
    def compute_fraction(self) -> float:
        return self.scores_computed / max(self.scores_possible, 1)

    @property
    def mean_exit_stage(self) -> float:
        return self.stages_run / max(self.n_queries, 1)


class GroupedRankServer:
    """Serve ranked top-k verdicts for ragged query groups.

    ``score_fn(docs) -> (m, T)`` produces per-document base-model scores
    in ORIGINAL model order; it receives the flush's documents as one
    float32 tensor on ``device`` and may return a tensor or an array
    (None = ``submit`` receives score matrices directly).  ``executor`` is
    a ``DeviceExecutor`` bound to the matrix stage scorer, or None for the
    host oracle path.  ``capacity_groups`` pins the group-slot capacity
    per bucket, ``capacity_docs`` the document rows of a flush's operand
    (``run_grouped``'s ``capacity_rows``; a flush with more docs pads
    further); ``batch_groups`` is the flush threshold.  ``device``
    defaults to the executor's device, else to the card (an error without
    one); ``"cpu"`` is used only when named.  ``streaming=True`` drives
    the grouped admission ring (``run_stream_grouped``) wave by wave
    through an ``AdmissionQueue`` with ``policy`` instead of
    batch-at-a-time flushes; each wave's ring is pinned to the slot
    capacity, so waves of one bucket width share a program (the reference
    keys its ring on each wave's group count).  Each wave's
    ``GroupedStreamResult`` is kept in ``stream_results``.
    """

    def __init__(
        self,
        gplan: GroupedPlan,
        score_fn=None,
        *,
        executor=None,
        batch_groups: int = 32,
        capacity_groups: int | None = None,
        capacity_docs: int | None = None,
        buckets=None,
        streaming: bool = False,
        policy: str = "skip-ahead",
        margin_inf: bool = False,
        device=None,
    ):
        if policy not in ("skip-ahead", "wait"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if executor is not None:
            if device is not None and resolve_device(device) != executor.device:
                raise ValueError(
                    f"device {device!r} differs from the executor's {executor.device}"
                )
            self.device = executor.device
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.gplan = gplan.with_margin_inf() if margin_inf else gplan
        self.score_fn = score_fn
        self.executor = executor
        self.batch_groups = int(batch_groups)
        self.capacity_groups = int(capacity_groups or batch_groups)
        self.capacity_docs = capacity_docs
        self.buckets = tuple(buckets) if buckets is not None else gplan.buckets
        self.streaming = bool(streaming)
        self.policy = policy
        self.stats = RankStats()
        self.stream_results: list = []
        self._queue: list[tuple[int, object, float]] = []  # (seq, docs, arrival)
        self._results: list[tuple[int, dict]] = []
        self._seq = 0
        self._clock = 0.0
        self._order = None

    def submit(self, docs, arrival: float | None = None) -> None:
        """Enqueue one query's ragged document list (``(m, ...)`` features
        for ``score_fn``, or an ``(m, T)`` score matrix without one) at
        ``arrival`` (stage-step units, nondecreasing across submits;
        default: the last stamp seen).  A tensor is kept as it is, so
        scores already on the device stay there."""
        if not isinstance(docs, torch.Tensor):
            docs = np.asarray(docs)
        if docs.ndim < 2 or docs.shape[0] < 1:
            raise ValueError(
                f"a query needs a (m >= 1, ...) document array, got {docs.shape}"
            )
        a = self._clock if arrival is None else float(arrival)
        if a < self._clock:
            raise ValueError(f"arrivals must be nondecreasing (got {a} after {self._clock})")
        self._clock = a
        self._queue.append((self._seq, docs, a))
        self._seq += 1
        if len(self._queue) >= self.batch_groups:
            self.flush()

    def _scores(self, pending):
        """The flush's (n_docs, T) original-order scores, in one call of
        ``score_fn`` (a tensor on the device stays there), and sizes."""
        sizes = np.array([d.shape[0] for _, d, _ in pending], dtype=np.int64)
        docs = [d for _, d, _ in pending]
        if any(isinstance(d, torch.Tensor) for d in docs):
            X = torch.cat([torch.as_tensor(d, device=self.device) for d in docs])
        else:
            X = np.concatenate(docs, axis=0)
        if self.score_fn is not None:
            if not isinstance(X, torch.Tensor):
                X = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
            F = self.score_fn(X.to(self.device, torch.float32).contiguous())
        else:
            F = X
        if F.ndim != 2 or tuple(F.shape) != (int(sizes.sum()), self.gplan.T):
            raise ValueError(
                f"score matrix must be (m, T={self.gplan.T}), got {tuple(F.shape)}"
            )
        return F, sizes

    def _record(self, pending, gidx, verdicts, exit_stage, margin, offsets):
        """Map global flat doc ids back to LOCAL positions and file the
        verdicts under each query's submission seq."""
        for j, gi in enumerate(gidx):
            local = verdicts[j].astype(np.int64)
            local = np.where(local >= 0, local - offsets[gi], -1)
            self._results.append(
                (
                    pending[gi][0],
                    {
                        "ranking": [int(v) for v in local if v >= 0],
                        "exit_stage": int(exit_stage[j]),
                        "margin": float(margin[j]),
                    },
                )
            )
            self.stats.stages_run += int(exit_stage[j])

    def _run_host(self, pending, F, sizes, offsets, gidx) -> None:
        """One bucket through the host oracle, on the bucket's contiguous
        sub-matrix; its verdicts are rebased to the flush's flat rows."""
        sub = np.concatenate([F[offsets[g] : offsets[g + 1]] for g in gidx], axis=0)
        res = run_grouped_host(self.gplan, sub, sizes[gidx])
        shift = (offsets[gidx] - group_offsets(sizes[gidx])[:-1])[:, None]
        verd = np.where(res.verdicts >= 0, res.verdicts + shift, -1)
        self.stats.scores_computed += res.scores_computed
        self._record(pending, gidx, verd, res.exit_stage, res.margin, offsets)

    def _waves(self, sizes) -> list[tuple[int, np.ndarray]]:
        """Streaming admission: (bucket, group indices) per wave.  Each
        wave serves ONE bucket width, the covering bucket of the current
        queue head, and draws groups through the ``AdmissionQueue`` until
        none fit: ``skip-ahead`` scans past misfits (later small groups
        ride along), ``wait`` stops at the first misfit."""
        widths = bucket_widths_for(sizes, self.buckets)
        q = AdmissionQueue(self.policy)
        for gi, sz in enumerate(sizes):
            q.push(gi, int(sz))
        waves = []
        while len(q):
            head_size = q.pending[0][1]
            b = next(w for w in widths if head_size <= w)
            gids = []
            while (g := q.pop_for(b)) is not None:
                gids.append(g)
            waves.append((b, np.asarray(gids, dtype=np.int64)))
        return waves

    def flush(self) -> None:
        """Serve everything queued: one grouped run per bucket shape, or in
        streaming mode one admission-ring run per wave.  An empty queue
        launches nothing."""
        if not self._queue:
            return
        pending, self._queue = self._queue, []
        gp = self.gplan
        F, sizes = self._scores(pending)
        offsets = group_offsets(sizes)
        self.stats.n_queries += len(pending)
        self.stats.n_docs += int(sizes.sum())
        self.stats.scores_possible += int(sizes.sum()) * gp.T
        packs = sorted(pack_by_bucket(sizes, self.buckets).items())
        if self.executor is None:
            F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
            for _, gidx in packs:
                self._run_host(pending, F, sizes, offsets, gidx)
                self.stats.n_waves += 1
            return
        # the flush's documents in cascade order, prepared once for every
        # bucket's run (a score kernel's output stays on the device)
        if isinstance(F, torch.Tensor):
            if self._order is None:
                self._order = torch.as_tensor(gp.plan.order, device=F.device)
            ordered = F[:, self._order]
        else:
            ordered = np.asarray(F, dtype=np.float32)[:, gp.plan.order]
        x = self.executor.scorer.prepare(ordered)
        if self.streaming:
            # arrival steps from the flush's first stamp; admission may
            # reorder (skip-ahead) and the ring wants a nondecreasing clock,
            # so a wave's later-arrived picks keep their stamp and earlier
            # ones saturate up to it
            steps = np.floor(np.array([a for _, _, a in pending]) - pending[0][2])
            runs = [(b, gidx, np.maximum.accumulate(steps[gidx]).astype(np.int32))
                    for b, gidx in self._waves(sizes)]
        else:
            runs = [(b, gidx, None) for b, gidx in packs]
        for b, gidx, arr in runs:
            rows, valid = bucket_layout(sizes[gidx], b, offsets=offsets[gidx])
            cap = max(self.capacity_groups, len(gidx))
            if self.streaming:
                # the ring pinned to the slot capacity: one program a
                # bucket width (ROADMAP C10, ``DeviceExecutor.traces``)
                res = self.executor.run_stream_grouped(
                    x, rows, valid, len(gidx), gp.eps_g, gp.k, arrivals=arr,
                    capacity_groups=cap, ring_capacity=cap, prepared=True,
                    capacity_rows=self.capacity_docs,
                )
                self.stream_results.append(res)
            else:
                res = self.executor.run_grouped(
                    x, rows, valid, len(gidx), gp.eps_g, gp.k, capacity_groups=cap,
                    prepared=True, capacity_rows=self.capacity_docs,
                )
            self.stats.scores_computed += res.scores_computed
            self._record(pending, gidx, res.verdicts, res.exit_stage, res.margin, offsets)
            self.stats.n_waves += 1

    def drain(self) -> list[dict]:
        """Flush the queue and return every verdict in submission order."""
        self.flush()
        out = [d for _, d in sorted(self._results, key=lambda t: t[0])]
        self._results = []
        return out
