"""Test-support harnesses that ship with the port.

``repro_torch.testing.faults`` is the deterministic fault-injection layer
the chaos tests use: production code carries injection points that a
``FaultPlan`` context manager arms from a seed.
"""

from repro_torch.testing.faults import FaultInjected, FaultPlan, active

__all__ = ["FaultInjected", "FaultPlan", "active"]
