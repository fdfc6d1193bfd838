"""Bucketed ranking server: ragged query groups in, ranked verdicts out
(the counterpart of ``repro.ranking.serving``, batch mode).

Queries (one ragged document list each) queue up; ``flush`` scores the
queued documents once, packs the groups into rectangular per-bucket
layouts (``ranking.bucketing``) and runs ONE grouped device wave per
bucket shape (``DeviceExecutor.run_grouped``), or the host oracle
(``run_grouped_host``) when there is no executor.  An empty queue
launches nothing.  The reference's streaming mode (a grouped admission
ring fed by an admission queue with a skip-ahead or wait policy) is
ROADMAP A12's open item and raises here.

Verdicts come back per query in submission order as LOCAL document
positions (0-based within the submitted group), mapped from the flat row
ids the executors emit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ranking.bucketing import bucket_layout, group_offsets, pack_by_bucket
from repro_torch.ranking.host import run_grouped_host
from repro_torch.ranking.plan import GroupedPlan

__all__ = ["GROUPED_STREAMING_TODO", "GroupedRankServer", "RankStats"]

#: what a request for grouped streaming raises with
GROUPED_STREAMING_TODO = (
    "grouped streaming admission (run_stream_grouped, the grouped admission "
    "ring and its skip-ahead/wait policies) is not ported yet: ROADMAP A12, "
    "grouped streaming; serve ranking queries batch at a time"
)


@dataclasses.dataclass
class RankStats:
    n_queries: int = 0
    n_docs: int = 0
    n_waves: int = 0  # grouped runs (one per bucket shape per flush)
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
    one); ``"cpu"`` is used only when named.  ``streaming=True`` raises:
    the grouped admission ring is not ported (ROADMAP A12).
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
        margin_inf: bool = False,
        device=None,
    ):
        if streaming:
            raise NotImplementedError(GROUPED_STREAMING_TODO)
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
        self.stats = RankStats()
        self._queue: list[tuple[int, np.ndarray]] = []  # (seq, docs)
        self._results: list[tuple[int, dict]] = []
        self._seq = 0
        self._order = None

    def submit(self, docs) -> None:
        """Enqueue one query's ragged document list (``(m, ...)`` features
        for ``score_fn``, or an ``(m, T)`` score matrix without one).  A
        tensor is kept as it is, so scores already on the device stay
        there."""
        if not isinstance(docs, torch.Tensor):
            docs = np.asarray(docs)
        if docs.ndim < 2 or docs.shape[0] < 1:
            raise ValueError(
                f"a query needs a (m >= 1, ...) document array, got {docs.shape}"
            )
        self._queue.append((self._seq, docs))
        self._seq += 1
        if len(self._queue) >= self.batch_groups:
            self.flush()

    def _scores(self, pending):
        """The flush's (n_docs, T) original-order scores, in one call of
        ``score_fn`` (a tensor on the device stays there), and sizes."""
        sizes = np.array([d.shape[0] for _, d in pending], dtype=np.int64)
        docs = [d for _, d in pending]
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

    def flush(self) -> None:
        """Serve everything queued, one grouped run per bucket shape.  An
        empty queue launches nothing."""
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
        for b, gidx in packs:
            rows, valid = bucket_layout(sizes[gidx], b, offsets=offsets[gidx])
            res = self.executor.run_grouped(
                x, rows, valid, len(gidx), gp.eps_g, gp.k,
                capacity_groups=max(self.capacity_groups, len(gidx)), prepared=True,
                capacity_rows=self.capacity_docs,
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
