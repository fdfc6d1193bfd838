"""Public entry points for the kernels, the counterpart of
``repro.kernels.ops`` for the ported slice.

Each op takes tensors on one device: on a CPU tensor the kernel wrapper
runs its plain PyTorch version, on a CUDA tensor it launches the
hand-written kernel.  ``score_and_decide`` is the fused lazy path: the
host stage loop with the chunk decide (B2), or the device stage loop
built through the backend registry.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan, ExecutorResult
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_group_kernel,
    cascade_kernel,
)
from repro_torch.kernels.device_executor import BoundScorer
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.tree_kernel import gbt_scores_kernel

__all__ = [
    "cascade_decide",
    "cascade_chunk",
    "cascade_group",
    "kernel_decide_fn",
    "score_and_decide",
    "lattice_scores",
    "gbt_scores",
    "ref",
]


def cascade_decide(
    scores_ordered, eps_pos, eps_neg, beta, block_n: int = 256, chunk_t: int = 8
):
    """Early-exit cascade over a cascade-ordered (N, T) score matrix (B1)
    -> (decisions int32, exit_step int32)."""
    return cascade_kernel(
        scores_ordered, eps_pos, eps_neg, beta, block_n=block_n, chunk_t=chunk_t
    )


def cascade_chunk(g0, chunk_scores, eps_pos, eps_neg, t0, **kw):
    """One-stage threshold tests -> (g, active, decided_pos, exit_step)."""
    return cascade_chunk_kernel(g0, chunk_scores, eps_pos, eps_neg, t0, **kw)


def cascade_group(g, valid, eps, k, n_live=None):
    """Group decide over a (G, B) bucket layout (B8) -> (margin, exit)."""
    return cascade_group_kernel(g, valid, eps, k, n_live=n_live)


def kernel_decide_fn(block_n: int = 256, device="cuda"):
    """Adapt the chunk-decide kernel (B2) to the ``ChunkedExecutor`` decide
    hook: numpy in, numpy out, the kernel on ``device`` in between.

    The kernel runs at float32, and the executor carries its state at the
    same dtype (``carry_dtype``), so the carried vector is handed over
    without a widening round trip.
    """
    dev = resolve_device(device)

    def decide(g0, chunk, eps_pos, eps_neg, t0):
        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

        g, active, dec, ex = cascade_chunk(
            f32(g0), f32(chunk), f32(eps_pos), f32(eps_neg), int(t0),
            block_n=block_n,
        )
        return (
            g.cpu().numpy(),
            active.cpu().numpy().astype(bool),
            dec.cpu().numpy().astype(bool),
            ex.cpu().numpy().astype(np.int64),
        )

    decide.carry_dtype = np.float32
    return decide


# device executors of score_and_decide, one per (backend, scorer, plan,
# block_n, torch device, opts), the reference's key with the torch device
# in place of its interpret flag.  Strong refs on purpose: repeat calls with
# the same plan and scorer objects reuse one executor (its programs and
# graphs).  Bounded (FIFO), so a process building fresh plans or scorers
# per request cannot grow it without limit.
_DEVICE_EXECUTORS: dict = {}
_DEVICE_EXECUTORS_MAX = 32


def score_and_decide(
    producer,
    plan: CascadePlan,
    n: int,
    block_n: int = 256,
    row_order=None,
    bill_block: int | None = None,
    device=None,
    x=None,
    backend=None,
    backend_opts: dict | None = None,
    torch_device="cuda",
) -> ExecutorResult:
    """Fused lazy path: chunked scoring composed with the threshold kernel.

    ``backend`` names an execution backend of the registry: ``"host"``
    (the default), ``"device"`` or ``"auto"`` (the device backend, never
    the host); a backend instance is accepted as it is, and executors are
    only built through it.

    Host mode: each stage scores only the surviving rows for only that
    stage's models (``producer(rows, t0, t1)``) and runs the chunk-decide
    kernel (B2, ``kernel_decide_fn``) on ``torch_device``; survivors are
    compacted on the host.  ``bill_block`` defaults to ``block_n``.

    Device mode: ``producer`` is a ``BoundScorer`` and ``x`` the batch
    operand its ``prepare`` consumes; the whole stage loop runs on
    ``torch_device`` (``DeviceExecutor``).  Pass the SAME plan, scorer and
    ``backend_opts`` values across calls to reuse the executor (at most
    ``_DEVICE_EXECUTORS_MAX`` are kept, first in first out).

    ``torch_device`` is the port's (the default card raises without one;
    ``"cpu"`` runs the plain versions).  ``device=`` is the reference's
    retired boolean and raises ``TypeError``, as the reference's does.
    """
    from repro_torch.api.registry import resolve_backend

    if device is not None:
        raise TypeError(
            "score_and_decide(device=...) was removed after its deprecation cycle; "
            "pass backend='device' (or 'host'/'auto' — see repro_torch.api) instead"
        )
    dev = resolve_device(torch_device)
    b = resolve_backend("host" if backend is None else backend, device=dev)
    opts = dict(backend_opts or {})
    if b.capabilities.on_device:
        if not isinstance(producer, BoundScorer):
            raise TypeError(f"backend {b.name!r} requires a device_executor.BoundScorer producer")
        if x is None:
            raise ValueError(f"backend {b.name!r} requires the batch operand x")
        # opts values are keyed by identity, and the entry keeps strong refs
        # to them (with the producer and the plan), so the ids stay valid
        key = (
            b.name, id(producer), id(plan), block_n, str(dev),
            tuple(sorted((k, id(v)) for k, v in opts.items())),
        )
        entry = _DEVICE_EXECUTORS.get(key)
        if entry is None:
            while len(_DEVICE_EXECUTORS) >= _DEVICE_EXECUTORS_MAX:
                _DEVICE_EXECUTORS.pop(next(iter(_DEVICE_EXECUTORS)))
            entry = (
                b.make_executor(plan, scorer=producer, block_n=block_n, device=dev, **opts),
                producer, plan, tuple(opts.values()),
            )
            _DEVICE_EXECUTORS[key] = entry
        return entry[0].run(x, n, row_order=row_order)
    ex = b.make_executor(
        plan,
        producer=producer,
        decide_fn=kernel_decide_fn(block_n=block_n, device=dev),
        bill_block=block_n if bill_block is None else bill_block,
        **opts,
    )
    return ex.run(n, row_order=row_order)


def _bucket_rows(rows: torch.Tensor, block_n: int) -> tuple[torch.Tensor, int]:
    """Pad a ``rows`` gather up to a ``block_n`` multiple by repeating a
    valid index, so the kernel's launch covers whole row blocks, as the
    billing (``score_block_n``) counts them.  Returns (padded rows, the
    unpadded count to slice the output back to)."""
    m = rows.shape[0]
    pad = -m % block_n
    if pad and m:
        rows = torch.cat([rows, rows[:1].expand(pad)])
    return rows, m


def _with_rows(kernel, x, block_n: int, kw: dict):
    """``kernel`` with a ``rows`` gather bucketed to whole row blocks (and
    the output sliced back), or without one."""
    rows = kw.pop("rows", None)
    if rows is None:
        return kernel(block_n=block_n, **kw)
    rows, m = _bucket_rows(torch.as_tensor(rows, device=x.device).long(), block_n)
    return kernel(block_n=block_n, rows=rows, **kw)[:m]


def lattice_scores(theta, feats, x, block_n: int = 256, **kw):
    """(N, T) lattice base-model scores (or a t0/t1/rows slab)."""
    return _with_rows(
        lambda **k: lattice_scores_kernel(theta, feats, x, **k), x, block_n, kw
    )


def gbt_scores(feats, thrs, leaves, x, block_n: int = 256, **kw):
    """(N, T) oblivious-tree base-model scores (or a t0/t1/rows slab)."""
    return _with_rows(
        lambda **k: gbt_scores_kernel(feats, thrs, leaves, x, **k), x, block_n, kw
    )
