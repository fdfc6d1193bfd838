"""Deterministic fault injection for the serving stack, the counterpart of
``repro.testing.faults``.

A ``FaultPlan`` is a context manager that arms the injection points the
production code carries:

* **Poisoned inputs** — ``plan.poison(X)`` corrupts a seeded fraction of
  batch rows with NaN/inf features (the quarantine guard's adversary).
* **Backend construction faults** — a named backend's ``make_executor``
  raises ``FaultInjected`` starting at the Nth call, and (optionally) its
  ``available()`` reports the backend down, which is how the chaos tests
  force the graceful-degradation ladder to fall a rung.
* **Wave faults** — the first K ``run`` / ``run_stream`` / ``run_grouped``
  / ``run_stream_grouped`` invocations of a named (or any) on-device
  executor raise before the wave is launched, surfaced by the executors
  as ``WaveFailure`` so retry/backoff sees one exception type.  These
  injected faults are the only errors the port's ladder retries or falls
  on (ROADMAP C11): a real CUDA error propagates.
* **Device loss** (``drop_device=True``) is a mesh fault of the sharded
  backend (ROADMAP A15); the port raises when a plan asks for it.

Everything derives from ``seed``, so a chaos run is exactly
reproducible: same plan, same batch, same faults, same recovery.

The injection points (``on_available`` / ``on_make_executor`` /
``on_wave``) are module-level functions that production code calls
unconditionally; with no plan armed they cost one global read and a
``None`` check.  Exactly one plan can be armed at a time — nesting is a
test bug and raises immediately.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FaultInjected",
    "FaultPlan",
    "active",
    "on_available",
    "on_make_executor",
    "on_wave",
]


class FaultInjected(RuntimeError):
    """An injected fault fired.  Subclasses ``RuntimeError`` as the
    reference's does; the port's degradation ladder retries and falls on
    this type (and ``WaveFailure``) alone."""


_ACTIVE: "FaultPlan | None" = None

_DROP_DEVICE_TODO = (
    "drop_device simulates losing a device of the sharded backend's mesh, "
    "which is not ported yet (ROADMAP A15)"
)


def active() -> "FaultPlan | None":
    """The armed plan, or None — injection points branch on this."""
    return _ACTIVE


def on_available(backend_name: str, ok: bool, reason: str) -> tuple[bool, str]:
    """Injection point inside ``Backend.available``: an armed plan may
    flip an available backend to down (never the reverse)."""
    if _ACTIVE is None:
        return ok, reason
    why = _ACTIVE._backend_down(backend_name)
    if why is not None and ok:
        return False, why
    return ok, reason


def on_make_executor(backend_name: str) -> None:
    """Injection point at the top of ``Backend.make_executor``."""
    if _ACTIVE is not None:
        _ACTIVE._on_make_executor(backend_name)


def on_wave(executor_name: str) -> None:
    """Injection point at the top of an executor wave (``launch_wave``:
    one ``run`` / ``run_stream`` / ``run_grouped`` / ``run_stream_grouped``
    call = one device wave)."""
    if _ACTIVE is not None:
        _ACTIVE._on_wave(executor_name)


@dataclasses.dataclass
class FaultPlan:
    """One seeded chaos scenario; arm it with ``with plan: ...``.

    ``fail_on_call`` is 1-indexed over the named backend's
    ``make_executor`` calls *while armed*; ``fail_calls`` bounds how many
    consecutive calls fail (``None`` = every call from ``fail_on_call``
    on — a permanently lost substrate).  ``wave_failures`` fails the
    first K wave launches (of ``wave_fail_backend``, or any executor),
    which with K <= the backoff policy's retries models a transient
    fault the SAME rung recovers from, and with larger K a rung loss.
    """

    seed: int = 0
    # -- input poisoning ------------------------------------------------
    poison_fraction: float = 0.0
    poison_mode: str = "nan"  # "nan" | "inf" | "mix"
    # -- backend construction faults ------------------------------------
    fail_backend: str | None = None
    fail_on_call: int = 1
    fail_calls: int | None = None
    fail_available: bool = False
    drop_device: bool = False  # sharded mesh loses a device (ROADMAP A15)
    # -- wave faults ----------------------------------------------------
    wave_failures: int = 0
    wave_fail_backend: str | None = None
    # -- observability (filled while armed) -----------------------------
    injected: dict = dataclasses.field(default_factory=dict, init=False)

    def __post_init__(self):
        if self.drop_device:
            raise ValueError(_DROP_DEVICE_TODO)
        if self.poison_mode not in ("nan", "inf", "mix"):
            raise ValueError(f"poison_mode must be nan|inf|mix, got {self.poison_mode!r}")
        if not 0.0 <= self.poison_fraction <= 1.0:
            raise ValueError("poison_fraction must be in [0, 1]")
        self.injected = {"make_executor": 0, "waves": 0, "rows_poisoned": 0}
        self._make_calls: dict[str, int] = {}
        self._wave_calls = 0

    # -- context manager -----------------------------------------------

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already armed (no nesting)")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None

    # -- injection logic ------------------------------------------------

    def _backend_down(self, name: str) -> str | None:
        """Reason string when ``name`` should report unavailable."""
        if self.fail_available and name == self.fail_backend:
            return f"injected outage (FaultPlan seed={self.seed})"
        return None

    def _on_make_executor(self, name: str) -> None:
        if name != self.fail_backend:
            return
        cnt = self._make_calls.get(name, 0) + 1
        self._make_calls[name] = cnt
        if cnt < self.fail_on_call:
            return
        if (
            self.fail_calls is not None
            and cnt >= self.fail_on_call + self.fail_calls
        ):
            return
        self.injected["make_executor"] += 1
        raise FaultInjected(
            f"injected construction fault: {name}.make_executor call #{cnt} "
            f"(FaultPlan seed={self.seed})"
        )

    def _on_wave(self, name: str) -> None:
        if self.wave_fail_backend is not None and name != self.wave_fail_backend:
            return
        self._wave_calls += 1
        if self._wave_calls <= self.wave_failures:
            self.injected["waves"] += 1
            raise FaultInjected(
                f"injected wave fault: {name} wave #{self._wave_calls} "
                f"(FaultPlan seed={self.seed})"
            )

    # -- input poisoning ------------------------------------------------

    def poison(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Corrupt a seeded fraction of rows of ``X`` with NaN/inf.

        Returns ``(poisoned_copy, mask)`` where ``mask[i]`` is True for
        rows that received a non-finite feature.  At least one row is
        poisoned whenever ``poison_fraction > 0`` (a fraction that
        rounds to zero rows would silently test nothing).
        """
        X = np.array(X, dtype=np.float64, copy=True)
        n = X.shape[0]
        mask = np.zeros(n, dtype=bool)
        if self.poison_fraction == 0.0 or n == 0:
            return X, mask
        k = max(1, int(round(self.poison_fraction * n)))
        rng = np.random.default_rng(self.seed)
        rows = rng.choice(n, size=k, replace=False)
        cols = rng.integers(0, X.shape[1], size=k) if X.ndim > 1 else None
        vals = {
            "nan": [np.nan],
            "inf": [np.inf, -np.inf],
            "mix": [np.nan, np.inf, -np.inf],
        }[self.poison_mode]
        for i, r in enumerate(rows):
            v = vals[i % len(vals)]
            if cols is None:
                X[r] = v
            else:
                X[r, cols[i]] = v
        mask[rows] = True
        self.injected["rows_poisoned"] += int(k)
        return X, mask
