"""Execution backends, the counterpart of ``repro.api.backends`` for the
ported slice.

Each backend declares its capabilities, says whether it can run here, and
constructs its executor.  ``host`` is the per-stage host loop
(``ChunkedExecutor``, numpy control flow); ``device`` is the stage loop on
the device with no host sync (``DeviceExecutor``).  There is no
degradation ladder in the port: a failure raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.executor import CascadePlan, ChunkedExecutor
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    BoundScorer,
    DeviceExecutor,
    DevicePlan,
)

__all__ = ["BackendCapabilities", "HostBackend", "DeviceBackend"]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """``on_device``: the whole stage loop (scoring, decide, compaction)
    is enqueued on the device with no per-stage host round trip; False
    means the host stage loop with per-stage producer calls.
    ``streaming``: the executor has ``run_stream`` (fixed-capacity lanes
    that an admission ring refills mid-cascade), which ``StreamingServer``
    needs.  ``grouped``: the backend can rank ragged query groups (the
    host oracle ``run_grouped_host``, or the executor's ``run_grouped``),
    which ``fit(groups=)`` needs."""

    on_device: bool
    streaming: bool = False
    grouped: bool = False


def _as_cascade_plan(plan: CascadePlan | DevicePlan) -> CascadePlan:
    return plan.plan if isinstance(plan, DevicePlan) else plan


class HostBackend:
    """Host stage loop (``ChunkedExecutor``): the semantics oracle and the
    escape hatch for host-side score producers.  Runs only when named."""

    name = "host"
    capabilities = BackendCapabilities(on_device=False, grouped=True)

    def available(self) -> tuple[bool, str]:
        return True, "host stage loop runs anywhere (numpy control flow)"

    def make_executor(
        self,
        plan: CascadePlan | DevicePlan,
        *,
        producer,
        decide_fn=None,
        bill_block: int = 1,
    ) -> ChunkedExecutor:
        return ChunkedExecutor(
            _as_cascade_plan(plan), producer, decide_fn=decide_fn, bill_block=bill_block
        )

    def billing_key(self, decide: str | None = None, block_n: int | None = None) -> str:
        """The perf gate's counter-key fragment: ``kernel<block>`` for the
        host loop with the chunk-decide kernel (B2), ``host`` with the
        reference decide (the reference's names)."""
        if decide == "kernel":
            return f"kernel{block_n or 256}"
        return self.name


class DeviceBackend:
    """The device stage loop (``DeviceExecutor``)."""

    name = "device"
    capabilities = BackendCapabilities(on_device=True, streaming=True, grouped=True)

    def available(self) -> tuple[bool, str]:
        if torch.cuda.is_available():
            return True, f"{torch.cuda.device_count()} CUDA device(s)"
        return False, "no CUDA device (torch.cuda.is_available() is False)"

    def make_executor(
        self,
        plan: CascadePlan | DevicePlan,
        *,
        scorer: BoundScorer,
        block_n: int = DEFAULT_BLOCK_N,
        megakernel: bool | None = None,
        device="cuda",
        capture: bool = True,
    ) -> DeviceExecutor:
        return DeviceExecutor(
            plan, scorer, block_n=block_n, megakernel=megakernel, device=device,
            capture=capture,
        )

    def billing_key(self) -> str:
        """The perf gate's counter-key fragment."""
        return self.name
