"""Execution backends, the counterpart of ``repro.api.backends`` for the
ported slice.

Each backend declares its capabilities, says whether it can run here, and
constructs its executor.  ``host`` is the per-stage host loop
(``ChunkedExecutor``, numpy control flow); ``device`` is the stage loop on
the device with no host sync (``DeviceExecutor``).

The runtime degradation ladder (``DegradationLadder``): when a rung's
executor construction or a device wave fails with an injected fault
(``testing.faults``), the caller retries with capped exponential backoff,
then falls one rung (device -> host, ``LADDER_ORDER``) and records a
``DegradationEvent``, logged at warning level.  ``CompiledCascade`` and the
serving engines use it.  Unlike the reference, only injected faults
(``FaultInjected``, ``WaveFailure``) are retried or fallen on (ROADMAP
C11): every other error, a CUDA error above all, propagates, so the ladder
never hides a fault of the card.  ``"auto"`` and ``negotiate`` never land
on the host (``registry.py``): the ladder is the only way down.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

from repro_torch.core.executor import CascadePlan, ChunkedExecutor
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    BoundScorer,
    DeviceExecutor,
    DevicePlan,
    WaveFailure,
)
from repro_torch.testing import faults

__all__ = [
    "BackendCapabilities",
    "HostBackend",
    "DeviceBackend",
    "BackoffPolicy",
    "DegradationEvent",
    "DegradationLadder",
    "LADDER_ORDER",
    "RETRYABLE",
    "fallback_rung",
]

log = logging.getLogger("repro_torch.api")

# the runtime ladder's rungs, top to bottom (the reference's negotiation
# order without its sharded rung, ROADMAP A15)
LADDER_ORDER = ("device", "host")
# the errors the ladder retries and falls on: injected faults only
RETRYABLE = (faults.FaultInjected, WaveFailure)


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
        return faults.on_available(
            self.name, True, "host stage loop runs anywhere (numpy control flow)"
        )

    def make_executor(
        self,
        plan: CascadePlan | DevicePlan,
        *,
        producer,
        decide_fn=None,
        bill_block: int = 1,
    ) -> ChunkedExecutor:
        faults.on_make_executor(self.name)
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
            return faults.on_available(
                self.name, True, f"{torch.cuda.device_count()} CUDA device(s)"
            )
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
        check_finite: bool = False,
    ) -> DeviceExecutor:
        faults.on_make_executor(self.name)
        return DeviceExecutor(
            plan, scorer, block_n=block_n, megakernel=megakernel, device=device,
            capture=capture, check_finite=check_finite,
        )

    def billing_key(self) -> str:
        """The perf gate's counter-key fragment."""
        return self.name


# -- graceful degradation ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One recorded degradation: a same-rung recovery (``to_backend ==
    from_backend``) or a fall to the next rung."""

    kind: str  # "construct" (make_executor failed) | "wave" (run failed)
    from_backend: str
    to_backend: str
    error: str
    retries: int  # failed attempts on from_backend before this resolution


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential backoff: ``retries`` extra attempts after the
    first failure, waiting ``base_delay * factor**i`` (capped at
    ``max_delay``) before attempt i+1.  Delays are data, not clock reads,
    so a test's fake ``sleep`` sees the exact schedule."""

    retries: int = 2
    base_delay: float = 0.05
    factor: float = 2.0
    max_delay: float = 1.0

    def delays(self) -> tuple[float, ...]:
        return tuple(
            min(self.base_delay * self.factor**i, self.max_delay)
            for i in range(max(0, int(self.retries)))
        )


def fallback_rung(name: str, accept: Callable | None = None):
    """The first AVAILABLE backend strictly below ``name`` in
    ``LADDER_ORDER`` (optionally also satisfying ``accept(backend)``), or
    None at the floor.  A backend outside the ladder may fall to any
    rung."""
    from repro_torch.api.registry import get_backend

    start = LADDER_ORDER.index(name) + 1 if name in LADDER_ORDER else 0
    for lower in LADDER_ORDER[start:]:
        b = get_backend(lower)
        ok, _ = b.available()
        if ok and (accept is None or accept(b)):
            return b
    return None


class DegradationLadder:
    """Retry-then-fall loop shared by ``CompiledCascade`` and the
    serving engines.

    ``attempt`` runs one callable with same-rung retries under the
    backoff policy; ``fall`` resolves the next usable rung (recording the
    event) or re-raises when the floor is reached.  Only ``RETRYABLE``
    errors (injected faults) are retried: a CUDA error, a caller bug
    (``ValueError`` / ``TypeError``) and every other error propagate
    untouched, with no event.
    """

    def __init__(
        self,
        backoff: BackoffPolicy | None = None,
        sleep: Callable[[float], None] | None = None,
        events: list | None = None,
    ):
        self.backoff = backoff or BackoffPolicy()
        self.sleep = time.sleep if sleep is None else sleep
        self.events: list[DegradationEvent] = events if events is not None else []

    def _record(self, ev: DegradationEvent) -> None:
        self.events.append(ev)
        what = "recovered on" if ev.from_backend == ev.to_backend else "fell to"
        log.warning(
            "%s %s %r after %d failed attempt(s) on %r: %s",
            ev.kind, what, ev.to_backend, ev.retries, ev.from_backend, ev.error,
        )

    def attempt(self, kind: str, backend_name: str, fn: Callable[[], Any]):
        """``fn()`` with capped-backoff retries on the SAME rung.  A retry
        that succeeds records a same-rung recovery event; exhausted retries
        re-raise the last error for ``fall`` to resolve."""
        delays = self.backoff.delays()
        err: BaseException | None = None
        for i in range(len(delays) + 1):
            try:
                out = fn()
            except RETRYABLE as e:
                err = e
                if i < len(delays):
                    self.sleep(delays[i])
                continue
            if i:
                self._record(DegradationEvent(kind, backend_name, backend_name, str(err), i))
            return out
        raise err

    def fall(self, kind: str, from_name: str, error: BaseException, accept: Callable | None = None):
        """Next usable rung below ``from_name``; records the fall.  At the
        floor the original ``error`` is re-raised: degradation never
        swallows a failure it cannot route around."""
        nxt = fallback_rung(from_name, accept=accept)
        if nxt is None:
            raise error
        self._record(
            DegradationEvent(kind, from_name, nxt.name, str(error), self.backoff.retries)
        )
        return nxt
