"""Kernel B3: oblivious-forest scores (GBT base models).

The counterpart of ``repro.kernels.tree_kernel``.  A tree evaluates as a
``depth``-bit leaf index from (feature > threshold) compares, MSB first,
then a read of that leaf.  ``gbt_scores_kernel`` is the wrapper: a CPU
tensor goes to ``gbt_scores_plain``, a CUDA tensor to the hand-written
kernel ``csrc/tree_scores.cu`` (or the wrapper raises).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.kernels import _build

DEFAULT_BLOCK_N = 256
# the kernel's leaf index is an int and deep tables are read in place
MAX_DEPTH = 30
# launch geometry (tree_geometry): most threads a CTA, trees a tile, and
# the shared memory a CTA stages its tile in
THREADS = 256
TILE = 32
STAGE_SMEM = 48 * 1024

__all__ = [
    "TreeGeometry", "check_tree_depth", "gbt_scores_kernel", "gbt_scores_plain",
    "tree_geometry",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _P] + [_I] * 13 + [_P, _P]
_RESIDENT_ARGTYPES = [_I] * 4 + [_P]


@dataclasses.dataclass(frozen=True)
class TreeGeometry:
    """B3's launch for (n rows, tk trees, depth): CTA (x, y) scores trees
    [y tile, (y + 1) tile) on rows [x rows passes, (x + 1) rows passes);
    its thread j takes tree j % tile at rows j // tile + p rows, p <
    passes."""

    tile: int  # trees a CTA
    rows: int  # rows a pass
    passes: int  # passes a CTA
    grid: tuple[int, int]  # (row runs, tree tiles)
    staged: bool  # leaf tables in shared memory (else read in place)
    smem: int  # shared memory bytes a CTA: ids, thresholds (and leaves)

    @property
    def threads(self) -> int:
        return self.tile * self.rows


def check_tree_depth(depth: int) -> None:
    """Raise unless the kernel takes trees of ``depth``: 0 to
    ``MAX_DEPTH`` (the plain version takes any depth)."""
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"gbt_scores: tree depth {depth} not in [0, {MAX_DEPTH}]")


def tree_geometry(n: int, tk: int, depth: int, n_sms: int, resident) -> TreeGeometry:
    """B3's launch geometry, a pure function of the shapes, the card's SM
    count and ``resident(staged, threads, smem)``, the CTAs of that kernel
    an SM holds at once (the occupancy API's answer on the card).
    tk is split into near-equal tiles of at most ``TILE`` trees, a pass is
    ``THREADS // tile`` rows, and each tile's passes are spread over as
    many CTAs as one wave of the card holds (fewer only when there are
    fewer passes), so a CTA stages its tile once for all its passes and no
    CTA waits for a second wave.  The leaf tables are staged beside the ids
    and thresholds while the tile's fit ``STAGE_SMEM``."""
    check_tree_depth(depth)
    if n < 1 or tk < 1:
        raise ValueError(f"tree_geometry: n {n}, tk {tk}")
    n_tiles = -(-tk // TILE)
    tile = -(-tk // n_tiles)
    rp = THREADS // tile
    params = 8 * depth * tile  # ids and thresholds
    leaves = 4 * tile * ((1 << depth) + 1)  # a table padded by a word
    staged = params + leaves <= STAGE_SMEM
    smem = params + (leaves if staged else 0)
    row_passes = -(-n // rp)
    slots = n_sms * resident(staged, tile * rp, smem)
    runs = max(1, min(row_passes, slots // n_tiles))
    passes = -(-row_passes // runs)
    return TreeGeometry(
        tile=tile, rows=rp, passes=passes, grid=(-(-row_passes // passes), n_tiles),
        staged=staged, smem=smem,
    )


_RESIDENT: dict[tuple, int] = {}


def _resident(device: torch.device, depth: int):
    """``tree_geometry``'s ``resident`` on the card: the occupancy API for
    the kernel instantiation, cached."""

    def resident(staged: bool, threads: int, smem: int) -> int:
        key = (device.index, depth, staged, threads, smem)
        if key not in _RESIDENT:
            fn = _build.function("tree_scores", "gbt_scores_resident", _RESIDENT_ARGTYPES)
            ctas = ctypes.c_int(0)
            err = fn(depth, int(staged), threads, smem, ctypes.addressof(ctas))
            _build.check("tree_scores", err, "gbt_scores occupancy")
            _RESIDENT[key] = max(1, ctas.value)
        return _RESIDENT[key]

    return resident


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

    Precondition on the card: every feature id of trees [t0, t1) lies in
    [0, x.shape[1]).  The kernel reads ``x[r, f]`` unchecked (checking
    would cost a sync a launch); the plain version raises instead.  Callers
    check the width once, on the host (``tree_stage_scorer``'s
    ``prepare``).  Depth: 0 to ``MAX_DEPTH`` on the card, any in the plain
    version.
    """
    if x.device.type == "cpu":
        return gbt_scores_plain(feats, thrs, leaves, x, block_n, t0, t1, rows, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"gbt_scores: unsupported device {x.device}")
    check_tree_depth(feats.shape[1])
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
    if x.ndim != 2 or (rows is not None and rows.ndim != 1):
        raise ValueError("gbt_scores: x must be (N, D) and rows (n,)")
    if x.shape[0] == 0 and rows is not None and rows.shape[0]:
        raise ValueError("gbt_scores: rows given but x has no rows")
    if block_n < 1:
        raise ValueError(f"gbt_scores: block_n {block_n} < 1")
    t0, t1 = _model_range(T, t0, t1)
    n = x.shape[0] if rows is None else rows.shape[0]
    tk = t1 - t0
    out = torch.empty(n, tk, dtype=f32, device=x.device)
    if n == 0:
        return out
    nv_ptr, nv_host = _build.n_valid_args(n_valid, n, x.device)
    geo = tree_geometry(n, tk, depth, _build.sm_count(x.device), _resident(x.device, depth))
    fn = _build.function("tree_scores", "gbt_scores_launch", _ARGTYPES)
    err = fn(
        feats[t0].data_ptr(), thrs[t0].data_ptr(), leaves[t0].data_ptr(),
        x.data_ptr(), _build.ptr(rows), x.shape[0], nv_ptr, nv_host, n,
        x.shape[1], tk, depth, int(block_n), geo.tile, geo.rows, geo.passes,
        *geo.grid, int(geo.staged), geo.smem, out.data_ptr(),
        _build.stream(x.device),
    )
    _build.check("tree_scores", err, "gbt_scores")
    _build.LAUNCHES["gbt_scores"] += 1
    return out
