"""QWYC core: calibration (host numpy) and the host stage-loop executor."""

from repro_torch.core.executor import (
    CascadePlan,
    ChunkedExecutor,
    ChunkStat,
    ExecutorResult,
    decide_chunk_reference,
    matrix_producer,
)
from repro_torch.core.qwyc import (
    QWYCModel,
    evaluate_cascade,
    fit_qwyc,
    fit_thresholds_for_order,
)

__all__ = [
    "CascadePlan",
    "ChunkStat",
    "ChunkedExecutor",
    "ExecutorResult",
    "QWYCModel",
    "decide_chunk_reference",
    "evaluate_cascade",
    "fit_qwyc",
    "fit_thresholds_for_order",
    "matrix_producer",
]
