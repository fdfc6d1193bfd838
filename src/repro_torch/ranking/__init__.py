"""Ranking: query-level early exit over ragged document groups, the
counterpart of ``repro.ranking`` (batch and streaming serving).

QWYC's decide step is per row, but learning-to-rank traffic exits per
QUERY: a ragged group of candidate documents stops scoring when its top-k
ORDER is stable (Lucchese et al., "Query-level Early Exit for Additive
Learning-to-Rank Ensembles"; Busolin et al., "Learning Early Exit
Strategies for Additive Ranking Ensembles").

* ``plan``      — ``GroupedPlan`` (per-stage top-k stability-margin
  thresholds + bucket layout) and ``fit_grouped`` (the greedy QWYC order
  reused; thresholds calibrated on the margin stream).
* ``host``      — the host oracle: the sequential grouped stage loop the
  device path is held against, plus the full-cascade top-k oracle (the
  margin-infinity reference).
* ``bucketing`` — host-side length-bucketed admission for ragged group
  sizes: the pad-to-bucket layout and the streaming ring's
  ``AdmissionQueue`` (skip-ahead / wait).
* ``metrics``   — NDCG@k.
* ``serving``   — the bucketed flush server and its streaming mode.

The group decide kernel (B8) lives in ``kernels/cascade_kernel.py`` and the
grouped loops on ``DeviceExecutor.run_grouped`` / ``run_stream_grouped``;
this package stays a layer above the kernels.
"""

from repro_torch.ranking.bucketing import (
    DEFAULT_BUCKETS,
    AdmissionQueue,
    bucket_layout,
    bucket_widths_for,
    group_offsets,
    pack_by_bucket,
)
from repro_torch.ranking.host import (
    full_cascade_topk,
    run_grouped_host,
)
from repro_torch.ranking.metrics import ndcg_at_k
from repro_torch.ranking.plan import (
    MARGIN_INF,
    GroupedPlan,
    fit_grouped,
    topk_margin,
)
from repro_torch.ranking.serving import GroupedRankServer

__all__ = [
    "DEFAULT_BUCKETS",
    "AdmissionQueue",
    "MARGIN_INF",
    "GroupedPlan",
    "GroupedRankServer",
    "bucket_layout",
    "bucket_widths_for",
    "fit_grouped",
    "full_cascade_topk",
    "group_offsets",
    "ndcg_at_k",
    "pack_by_bucket",
    "run_grouped_host",
    "topk_margin",
]
