"""Public entry points for the kernels, the counterpart of
``repro.kernels.ops`` for the ported slice.

Each op takes tensors on one device: on a CPU tensor the kernel wrapper
runs its plain PyTorch version, on a CUDA tensor it launches the
hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_group_kernel,
    cascade_kernel,
)
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.tree_kernel import gbt_scores_kernel

__all__ = [
    "cascade_decide",
    "cascade_chunk",
    "cascade_group",
    "kernel_decide_fn",
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
