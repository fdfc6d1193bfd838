"""Execution backends, the counterpart of ``repro.api.backends`` for the
ported slice.

Each backend declares its capabilities, says whether it can run here, and
constructs its executor.  ``host`` is the per-stage host loop
(``ChunkedExecutor``, numpy control flow); ``device`` is the stage loop on
the device with no host sync (``DeviceExecutor``); ``sharded`` is that loop
data-parallel over D logical shards of one device, and over a model axis
of M column slices of each stage's slab when asked for
(``ShardedDeviceExecutor``).

The runtime degradation ladder (``DegradationLadder``): when a rung's
executor construction or a device wave fails with an injected fault
(``testing.faults``), the caller retries with capped exponential backoff,
then falls one rung (sharded -> device -> host, ``LADDER_ORDER``) and records a
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
from repro_torch.kernels.sharded_executor import ShardedDeviceExecutor
from repro_torch.launch.mesh import MODEL_AXIS, make_serving_mesh
from repro_torch.testing import faults

__all__ = [
    "BackendCapabilities",
    "HostBackend",
    "DeviceBackend",
    "ShardedBackend",
    "BackoffPolicy",
    "DegradationEvent",
    "DegradationLadder",
    "LADDER_ORDER",
    "RETRYABLE",
    "fallback_rung",
]

log = logging.getLogger("repro_torch.api")

# the runtime ladder's rungs, top to bottom (the reference's negotiation
# order)
LADDER_ORDER = ("sharded", "device", "host")
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
    which ``fit(groups=)`` needs.  ``data_parallel``: the executor splits
    the batch over shards, and takes the ``mesh`` / ``shards`` /
    ``rebalance`` options; ``supports_rebalance``: it can repack survivors
    across shards.  ``model_parallel``: it takes a ``model_shards`` option
    and splits each stage's param slab over a ``"model"`` mesh axis (a 2-D
    ``("data", "model")`` mesh) for batch ``run``; its grouped and
    streaming paths stay data-parallel only at ``model_shards > 1``."""

    on_device: bool
    streaming: bool = False
    grouped: bool = False
    data_parallel: bool = False
    supports_rebalance: bool = False
    model_parallel: bool = False


def _as_cascade_plan(plan: CascadePlan | DevicePlan) -> CascadePlan:
    return plan.plan if isinstance(plan, DevicePlan) else plan


class HostBackend:
    """Host stage loop (``ChunkedExecutor``): the semantics oracle and the
    escape hatch for host-side score producers.  Runs only when named."""

    name = "host"
    capabilities = BackendCapabilities(on_device=False, grouped=True)

    def available(self, device=None) -> tuple[bool, str]:
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

    def available(self, device=None) -> tuple[bool, str]:
        """A CUDA device is needed, unless ``device`` (the torch device the
        caller runs on) is the CPU, where the loop takes the kernels' plain
        versions."""
        if device is not None and torch.device(device).type == "cpu":
            return faults.on_available(self.name, True, "the CPU (plain kernel versions)")
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


class ShardedBackend:
    """The data-parallel device stage loop (``ShardedDeviceExecutor``) over
    D logical shards of one device, or D x M with a model axis.  It reports
    itself available from two CUDA devices on, as the reference does from
    two XLA devices, so ``"auto"`` never picks it on one card; named with
    ``shards=`` it runs on any device (ROADMAP C15)."""

    name = "sharded"
    min_devices = 2
    capabilities = BackendCapabilities(
        on_device=True, streaming=True, grouped=True, data_parallel=True,
        supports_rebalance=True, model_parallel=True,
    )

    def available(self, n_devices: int | None = None, device=None) -> tuple[bool, str]:
        """From ``min_devices`` CUDA devices on (``n_devices`` overrides the
        count), whatever the torch ``device``: a shard count is asked for by
        naming the backend."""
        nd = torch.cuda.device_count() if n_devices is None else int(n_devices)
        if nd < self.min_devices:
            return faults.on_available(
                self.name, False,
                f"{nd} CUDA device(s) < {self.min_devices}; name the backend "
                "with shards= to run logical shards on one device",
            )
        return faults.on_available(self.name, True, f"{nd} CUDA device(s)")

    def resolve_mesh(self, mesh=None, shards: int | None = None, model_shards: int = 1,
                     device="cuda"):
        """The mesh the executor will run on: an explicit mesh wins (its
        ``"model"`` width must then equal ``model_shards`` when that is
        above 1), else a ``("data",)`` mesh of ``shards`` logical shards on
        ``device``, or with ``model_shards > 1`` a ``("data", "model")``
        mesh of ``shards x model_shards``.  The default data width is the
        CUDA devices left after the model axis takes its share (at least
        1)."""
        m = max(1, int(model_shards))
        if mesh is not None:
            have = int(mesh.shape.get(MODEL_AXIS, 1))
            if m > 1 and have != m:
                raise ValueError(
                    f"model_shards={m} conflicts with the explicit mesh "
                    f"{tuple(mesh.shape.items())} (its 'model' axis is {have}-wide); "
                    "pass one or the other"
                )
            return mesh
        n = int(shards) if shards else max(1, torch.cuda.device_count() // m)
        return make_serving_mesh(n, m, device=device)

    def make_executor(
        self,
        plan: CascadePlan | DevicePlan,
        *,
        scorer: BoundScorer,
        mesh=None,
        shards: int | None = None,
        model_shards: int = 1,
        block_n: int = DEFAULT_BLOCK_N,
        rebalance: bool = False,
        rebalance_ratio: float = 1.25,
        megakernel: bool | None = None,
        device="cuda",
        capture: bool = True,
        check_finite: bool = False,
    ) -> ShardedDeviceExecutor:
        faults.on_make_executor(self.name)
        return ShardedDeviceExecutor(
            plan, scorer, self.resolve_mesh(mesh, shards, model_shards, device=device),
            block_n=block_n, rebalance=rebalance, rebalance_ratio=rebalance_ratio,
            megakernel=megakernel, capture=capture, check_finite=check_finite,
        )

    def billing_key(self, shards: int, rebalance: bool = False, model_shards: int = 1) -> str:
        """The perf gate's counter-key fragment, ``sharded<D>[r]``, or
        ``sharded<D>x<M>[r]`` on a model axis (the reference's names)."""
        shape = f"{int(shards)}"
        if int(model_shards) > 1:
            shape += f"x{int(model_shards)}"
        return f"{self.name}{shape}{'r' if rebalance else ''}"


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


def fallback_rung(name: str, accept: Callable | None = None, device=None):
    """The first AVAILABLE backend strictly below ``name`` in
    ``LADDER_ORDER`` (optionally also satisfying ``accept(backend)``), or
    None at the floor; ``device`` is the torch device the rungs run on.  A
    backend outside the ladder may fall to any rung."""
    from repro_torch.api.registry import get_backend

    start = LADDER_ORDER.index(name) + 1 if name in LADDER_ORDER else 0
    for lower in LADDER_ORDER[start:]:
        b = get_backend(lower)
        ok, _ = b.available(device=device)
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
    untouched, with no event.  ``device`` is the torch device the rungs
    run on (on the CPU the device rung is a fall target too).
    """

    def __init__(
        self,
        backoff: BackoffPolicy | None = None,
        sleep: Callable[[float], None] | None = None,
        events: list | None = None,
        device=None,
    ):
        self.device = device
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
        nxt = fallback_rung(from_name, accept=accept, device=self.device)
        if nxt is None:
            raise error
        self._record(
            DegradationEvent(kind, from_name, nxt.name, str(error), self.backoff.retries)
        )
        return nxt
