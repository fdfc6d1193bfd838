"""Backend registry: name -> backend, the counterpart of
``repro.api.registry`` for the ported slice.

``"auto"`` always resolves to ``device``, never to ``host``: the host loop
runs only when it is named, so a missing card is never hidden behind a
slower path.  Without a CUDA device it raises, unless the caller named the
CPU as the torch device (the device loop then runs the kernels' plain
versions, as asked).
"""

from __future__ import annotations

import torch

from repro_torch.api.backends import DeviceBackend, HostBackend

__all__ = ["AUTO", "backend_names", "get_backend", "resolve_backend"]

AUTO = "auto"

_BACKENDS = {b.name: b for b in (HostBackend(), DeviceBackend())}


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def get_backend(name: str):
    if name not in _BACKENDS:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_BACKENDS)} "
            f"(or {AUTO!r})"
        )
    return _BACKENDS[name]


def resolve_backend(spec=AUTO, device=None):
    """A backend instance passes through; any name but ``"auto"`` is looked
    up.  ``"auto"`` is the device backend; it raises when CUDA is absent,
    unless ``device`` (the torch device the caller asked for) is the CPU."""
    if not isinstance(spec, str):
        return spec
    if spec == AUTO:
        backend = _BACKENDS["device"]
        if device is not None and torch.device(device).type == "cpu":
            return backend
        ok, why = backend.available()
        if not ok:
            raise RuntimeError(
                f"backend 'auto' needs a CUDA device: {why}.  Pass "
                "device='cpu' to run the device loop on the plain kernel "
                "versions, or name backend 'host' for the host stage loop"
            )
        return backend
    return get_backend(spec)
