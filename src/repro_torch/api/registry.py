"""Backend registry: name -> backend, the counterpart of
``repro.api.registry`` for the ported slice.

Every entry point reaches the executors through this table;
``register_backend`` adds a backend.  ``"auto"`` always resolves to
``device``, never to ``host``: the host loop runs only when it is named,
so a missing card is never hidden behind a slower path.  ``negotiate``
walks ``NEGOTIATION_ORDER`` (the device backend alone: the reference's
sharded rung is ROADMAP A15, and its host floor is not a rung here) and
raises with every rung's reason when none is available.  Without a CUDA
device ``"auto"`` raises, unless the caller named the CPU as the torch
device (the device loop then runs the kernels' plain versions, as asked).
"""

from __future__ import annotations

import torch

from repro_torch.api.backends import DeviceBackend, HostBackend

__all__ = [
    "AUTO",
    "NEGOTIATION_ORDER",
    "backend_names",
    "get_backend",
    "negotiate",
    "register_backend",
    "resolve_backend",
]

AUTO = "auto"

# "auto" preference; the host loop is never a rung
NEGOTIATION_ORDER = ("device",)

_BACKENDS: dict = {}


def register_backend(backend, *, overwrite: bool = False):
    """Add a backend to the registry (how another substrate plugs in)."""
    name = backend.name
    if name == AUTO:
        raise ValueError(f"{AUTO!r} is reserved for negotiation")
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered (pass overwrite=True)")
    _BACKENDS[name] = backend
    return backend


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def get_backend(name: str):
    if name not in _BACKENDS:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_BACKENDS)} "
            f"(or {AUTO!r})"
        )
    return _BACKENDS[name]


def negotiate():
    """The first available backend of ``NEGOTIATION_ORDER``; raises
    ``RuntimeError`` with every rung's reason when none is.  It never
    returns ``host``."""
    reasons = []
    for name in NEGOTIATION_ORDER:
        b = get_backend(name)
        ok, why = b.available()
        if ok:
            return b
        reasons.append(f"{name}: {why}")
    raise RuntimeError(
        "backend 'auto' needs a CUDA device; no rung is available: "
        + "; ".join(reasons)
        + ".  Pass device='cpu' to run the device loop on the plain kernel versions, "
        "or name backend 'host' for the host stage loop"
    )


def resolve_backend(spec=AUTO, device=None):
    """A backend instance passes through; any name but ``"auto"`` is looked
    up.  ``"auto"`` is the device backend: ``negotiate()``, unless
    ``device`` (the torch device the caller asked for) is the CPU."""
    if not isinstance(spec, str):
        return spec
    if spec == AUTO:
        if device is not None and torch.device(device).type == "cpu":
            return get_backend("device")
        return negotiate()
    return get_backend(spec)


for _b in (HostBackend(), DeviceBackend()):
    register_backend(_b)
del _b
