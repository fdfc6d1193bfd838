"""QWYC core: calibration (host numpy), the host stage-loop executor, the
masked-walk cascade, and the paper's baselines and variants (Fan et al.,
fixed orderings, multi-class, MoE experts, the device candidate sweep)."""

from repro_torch.core.cascade import CascadeOut, cascade_apply, cascade_from_scores, pack_model
from repro_torch.core.executor import (
    CascadePlan,
    ChunkedExecutor,
    ChunkStat,
    ExecutorResult,
    decide_chunk_reference,
    matrix_producer,
)
from repro_torch.core.fan import FanModel, evaluate_fan, fit_fan
from repro_torch.core.moe_qwyc import expert_contributions, fit_moe_qwyc, report_moe_qwyc
from repro_torch.core.multiclass import (
    MulticlassQWYC,
    evaluate_multiclass,
    fit_qwyc_multiclass,
)
from repro_torch.core.orderings import (
    gbt_order,
    greedy_mse_order,
    individual_mse_order,
    random_order,
)
from repro_torch.core.qwyc import (
    QWYCModel,
    evaluate_cascade,
    fit_qwyc,
    fit_thresholds_for_order,
)

__all__ = [
    "CascadeOut",
    "CascadePlan",
    "ChunkStat",
    "ChunkedExecutor",
    "ExecutorResult",
    "decide_chunk_reference",
    "matrix_producer",
    "expert_contributions",
    "fit_moe_qwyc",
    "report_moe_qwyc",
    "MulticlassQWYC",
    "evaluate_multiclass",
    "fit_qwyc_multiclass",
    "FanModel",
    "QWYCModel",
    "cascade_apply",
    "cascade_from_scores",
    "evaluate_cascade",
    "evaluate_fan",
    "fit_fan",
    "fit_qwyc",
    "fit_thresholds_for_order",
    "gbt_order",
    "greedy_mse_order",
    "individual_mse_order",
    "pack_model",
    "random_order",
]
