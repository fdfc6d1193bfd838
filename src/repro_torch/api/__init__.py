"""The port's front door, the counterpart of ``repro.api``:
``fit -> compile -> evaluate / rank / serve`` (``pipeline``), the backend
registry (``registry``, ``backends``) and the ``StageScorer`` templates
(``scorers``)."""

from repro_torch.api.pipeline import CompiledCascade, FitConfig, FittedCascade, fit

__all__ = ["CompiledCascade", "FitConfig", "FittedCascade", "fit"]
