"""The port's front door, the counterpart of ``repro.api``:
``fit -> compile -> evaluate / rank / serve`` (``pipeline``), the backend
registry (``registry``, ``backends``) and the ``StageScorer`` templates
with their registry (``scorers``)."""

from repro_torch.api.backends import BackendCapabilities, DeviceBackend, HostBackend
from repro_torch.api.pipeline import CompiledCascade, FitConfig, FittedCascade, fit
from repro_torch.api.registry import (
    AUTO,
    NEGOTIATION_ORDER,
    backend_names,
    get_backend,
    negotiate,
    register_backend,
    resolve_backend,
)
from repro_torch.api.scorers import (
    FunctionScorer,
    LatticeScorer,
    MatrixScorer,
    NeuralScorer,
    StageScorer,
    TreeScorer,
    get_scorer,
    register_scorer,
    scorer_names,
)

__all__ = [
    "fit",
    "FitConfig",
    "FittedCascade",
    "CompiledCascade",
    "BackendCapabilities",
    "HostBackend",
    "DeviceBackend",
    "AUTO",
    "NEGOTIATION_ORDER",
    "register_backend",
    "get_backend",
    "backend_names",
    "negotiate",
    "resolve_backend",
    "StageScorer",
    "MatrixScorer",
    "TreeScorer",
    "LatticeScorer",
    "NeuralScorer",
    "FunctionScorer",
    "register_scorer",
    "get_scorer",
    "scorer_names",
]
