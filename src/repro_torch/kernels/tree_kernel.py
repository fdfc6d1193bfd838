"""Kernel B3: oblivious-forest scores (GBT base models).

The counterpart of ``repro.kernels.tree_kernel``.  A tree evaluates as a
``depth``-bit leaf index from (feature > threshold) compares, MSB first,
then a read of that leaf.  ``gbt_scores_kernel`` is the wrapper: a CPU
tensor goes to ``gbt_scores_plain``, a CUDA tensor to the hand-written
kernel ``csrc/tree_scores.cu`` (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.kernels import _build

DEFAULT_BLOCK_N = 256
MAX_DEPTH = 10  # 32 trees' leaf tables must fit the CTA's shared memory

__all__ = ["gbt_scores_kernel", "gbt_scores_plain"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P]


def _model_range(T: int, t0: int, t1: int | None) -> tuple[int, int]:
    t1 = T if t1 is None else t1
    if not 0 <= t0 < t1 <= T:
        raise ValueError(f"tree range [{t0}, {t1}) not within [0, {T})")
    return t0, t1


def gbt_scores_plain(
    feats: torch.Tensor,
    thrs: torch.Tensor,
    leaves: torch.Tensor,
    x: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    t0: int = 0,
    t1: int | None = None,
    rows: torch.Tensor | None = None,
    n_valid=None,
) -> torch.Tensor:
    """Plain version of B3 (any device): ``apply_gbt_scores`` of trees
    [t0, t1) on the rows ``x[rows]`` (indices clamped into range, as
    ``jnp.take`` clamps) -> (n, t1 - t0) scores.  Row blocks of ``block_n``
    starting at or past ``n_valid`` are 0."""
    t0, t1 = _model_range(feats.shape[0], t0, t1)
    if rows is not None:
        x = x[torch.clamp(rows.long(), 0, x.shape[0] - 1)]
    params = {"feats": feats[t0:t1], "thrs": thrs[t0:t1], "leaves": leaves[t0:t1]}
    out = apply_gbt_scores(params, x)
    if n_valid is None:
        return out
    n = x.shape[0]
    block_start = torch.arange(n, device=x.device) // block_n * block_n
    live = block_start < torch.as_tensor(n_valid, device=x.device)
    return torch.where(live[:, None], out, 0.0)


def gbt_scores_kernel(
    feats: torch.Tensor,
    thrs: torch.Tensor,
    leaves: torch.Tensor,
    x: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    t0: int = 0,
    t1: int | None = None,
    rows: torch.Tensor | None = None,
    n_valid=None,
) -> torch.Tensor:
    """Evaluate trees [t0, t1) on N examples -> (N, t1 - t0) scores (B3).

    ``t0``/``t1`` restrict the model axis to one cascade stage; ``rows``
    (int64 indices) gathers the surviving examples; ``n_valid`` (None, an
    int, or an int32 scalar tensor on the device) makes row blocks of
    ``block_n`` at or past the live count skip the walk and emit 0, so the
    work tracks the live count at a fixed shape.
    """
    if x.device.type == "cpu":
        return gbt_scores_plain(feats, thrs, leaves, x, block_n, t0, t1, rows, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"gbt_scores: unsupported device {x.device}")
    f32 = torch.float32
    checks = [
        ("x", x, f32), ("feats", feats, torch.int32), ("thrs", thrs, f32),
        ("leaves", leaves, f32),
    ]
    if rows is not None:
        checks.append(("rows", rows, torch.int64))
    _build.check_cuda("gbt_scores", *checks)
    T, depth = feats.shape
    if thrs.shape != (T, depth) or leaves.shape != (T, 1 << depth):
        raise ValueError(
            f"gbt_scores: feats {tuple(feats.shape)}, thrs {tuple(thrs.shape)}, "
            f"leaves {tuple(leaves.shape)} are not one stacked forest"
        )
    if depth > MAX_DEPTH:
        raise ValueError(f"gbt_scores: depth {depth} > {MAX_DEPTH} is not supported")
    if x.ndim != 2 or (rows is not None and rows.ndim != 1):
        raise ValueError("gbt_scores: x must be (N, D) and rows (n,)")
    t0, t1 = _model_range(T, t0, t1)
    n = x.shape[0] if rows is None else rows.shape[0]
    tk = t1 - t0
    out = torch.empty(n, tk, dtype=f32, device=x.device)
    if n == 0:
        return out
    nv_ptr, nv_host = _build.n_valid_args(n_valid, n, x.device)
    fn = _build.function("tree_scores", "gbt_scores_launch", _ARGTYPES)
    err = fn(
        feats[t0].data_ptr(), thrs[t0].data_ptr(), leaves[t0].data_ptr(),
        x.data_ptr(), _build.ptr(rows), x.shape[0], nv_ptr, nv_host, n,
        x.shape[1], tk, depth, int(block_n), out.data_ptr(),
        _build.stream(x.device),
    )
    _build.check("tree_scores", err, "gbt_scores")
    _build.LAUNCHES["gbt_scores"] += 1
    return out
