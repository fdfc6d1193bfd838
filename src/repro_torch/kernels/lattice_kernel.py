"""Kernel B5: multilinear lattice scores.

The counterpart of ``repro.kernels.lattice_kernel``.  A lattice over S
features interpolates its 2^S vertex values at the row's S inputs.
``lattice_scores_kernel`` is the wrapper: a CPU tensor goes to
``lattice_scores_plain``, a CUDA tensor to the hand-written kernel
``csrc/lattice_scores.cu`` (or the wrapper raises).  Both compute in the
dimension order of ``ensembles.lattice.apply_lattice_scores``, so the card's
scores are bit-identical to the plain version's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.ensembles.lattice import apply_lattice_scores
from repro_torch.kernels import _build
from repro_torch.kernels.tree_kernel import _model_range

DEFAULT_BLOCK_N = 256
MAX_DIMS = 8  # the kernels keep 2^(S-1) partial values in registers
# the team regime while a team's threads for every pair fit one wave of the
# card at TEAM_THREADS_PER_SM; its CTAs hold at most TEAM_THREADS threads and
# are cut down (to one warp) until the launch spreads over the SMs
TEAM_THREADS_PER_SM = 2048
TEAM_THREADS = 256
# the thread regime's CTA: 32 rows x 8 lattices (csrc/lattice_scores.cu)
THREAD_TILE = (32, 8)

__all__ = [
    "LatticeRegime", "lattice_regime", "lattice_scores_kernel", "lattice_scores_plain",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _L, _P] + [_I] * 9 + [_P, _P]


@dataclasses.dataclass(frozen=True)
class LatticeRegime:
    """B5's launch for (n rows, tk lattices, S inputs).  Team: CTA b's
    thread j scores pair b (threads / lanes) + j // lanes, the pair p being
    (row p // tk, lattice p % tk), with lanes = min(32, 2^S) threads a pair.
    Thread: a grid of (rows / 32, tk / 8) CTAs of 32 x 8 threads, one a
    pair."""

    team: bool
    lanes: int  # threads a pair
    threads: int  # threads a CTA
    grid: tuple[int, int]


def lattice_regime(n: int, tk: int, S: int, n_sms: int) -> LatticeRegime:
    """B5's regime, a pure function of the shapes and the card's SM count:
    the team form (``lattice_interp_team``, min(32, 2^S) lanes a pair) while
    its threads for all ``n * tk`` pairs fit one wave of the card
    (``n_sms * TEAM_THREADS_PER_SM``), else one thread a pair."""
    if n < 1 or tk < 1 or not 1 <= S <= MAX_DIMS:
        raise ValueError(f"lattice_regime: n {n}, tk {tk}, S {S}")
    lanes = min(32, 1 << S)
    team_threads = n * tk * lanes
    if team_threads > n_sms * TEAM_THREADS_PER_SM:
        rows, lats = THREAD_TILE
        return LatticeRegime(False, 1, rows * lats, (-(-n // rows), -(-tk // lats)))
    threads = TEAM_THREADS
    while threads > 32 and -(-team_threads // threads) < n_sms:
        threads //= 2
    return LatticeRegime(True, lanes, threads, (-(-team_threads // threads), 1))


def lattice_scores_plain(
    theta: torch.Tensor,
    feats: torch.Tensor,
    x: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    t0: int = 0,
    t1: int | None = None,
    rows: torch.Tensor | None = None,
    n_valid=None,
) -> torch.Tensor:
    """Plain version of B5 (any device): ``apply_lattice_scores`` of
    lattices [t0, t1) on the rows ``x[rows]`` (indices clamped into range,
    as ``jnp.take`` clamps) -> (n, t1 - t0) scores.  Row blocks of
    ``block_n`` starting at or past ``n_valid`` are 0."""
    t0, t1 = _model_range(feats.shape[0], t0, t1)
    if rows is not None:
        x = x[torch.clamp(rows.long(), 0, x.shape[0] - 1)]
    out = apply_lattice_scores({"feats": feats[t0:t1], "theta": theta[t0:t1]}, x)
    if n_valid is None:
        return out
    n = x.shape[0]
    block_start = torch.arange(n, device=x.device) // block_n * block_n
    live = block_start < torch.as_tensor(n_valid, device=x.device)
    return torch.where(live[:, None], out, 0.0)


def lattice_scores_kernel(
    theta: torch.Tensor,
    feats: torch.Tensor,
    x: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    t0: int = 0,
    t1: int | None = None,
    rows: torch.Tensor | None = None,
    n_valid=None,
) -> torch.Tensor:
    """Evaluate lattices [t0, t1) on N examples -> (N, t1 - t0) scores (B5).

    theta: (T, 2**S) float32; feats: (T, S) int32; x: (N, D) float32 in
    [0, 1].  ``t0``/``t1`` restrict the model axis to one cascade stage;
    ``rows`` (int64 indices) gathers the surviving examples; ``n_valid``
    (None, an int, or an int32 scalar tensor on the device) makes row
    blocks of ``block_n`` at or past the live count skip the interpolation
    and emit 0, so the work tracks the live count at a fixed shape.
    """
    if x.device.type == "cpu":
        return lattice_scores_plain(theta, feats, x, block_n, t0, t1, rows, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"lattice_scores: unsupported device {x.device}")
    f32 = torch.float32
    checks = [("x", x, f32), ("theta", theta, f32), ("feats", feats, torch.int32)]
    if rows is not None:
        checks.append(("rows", rows, torch.int64))
    _build.check_cuda("lattice_scores", *checks)
    T, dims = feats.shape
    if theta.shape != (T, 1 << dims):
        raise ValueError(
            f"lattice_scores: theta {tuple(theta.shape)} and feats "
            f"{tuple(feats.shape)} are not one stacked ensemble"
        )
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"lattice_scores: S = {dims} not in [1, {MAX_DIMS}]")
    if x.ndim != 2 or (rows is not None and rows.ndim != 1):
        raise ValueError("lattice_scores: x must be (N, D) and rows (n,)")
    if x.shape[0] == 0 and rows is not None and rows.shape[0]:
        raise ValueError("lattice_scores: rows given but x has no rows")
    if block_n < 1:
        raise ValueError(f"lattice_scores: block_n {block_n} < 1")
    t0, t1 = _model_range(T, t0, t1)
    n = x.shape[0] if rows is None else rows.shape[0]
    tk = t1 - t0
    out = torch.empty(n, tk, dtype=f32, device=x.device)
    if n == 0:
        return out
    nv_ptr, nv_host = _build.n_valid_args(n_valid, n, x.device)
    reg = lattice_regime(n, tk, dims, _build.sm_count(x.device))
    fn = _build.function("lattice_scores", "lattice_scores_launch", _ARGTYPES)
    err = fn(
        theta[t0].data_ptr(), feats[t0].data_ptr(), x.data_ptr(),
        _build.ptr(rows), x.shape[0], nv_ptr, nv_host, n, x.shape[1], tk, dims,
        int(block_n), int(reg.team), reg.threads, reg.grid[0], out.data_ptr(),
        _build.stream(x.device),
    )
    _build.check("lattice_scores", err, "lattice_scores")
    _build.LAUNCHES["lattice_scores"] += 1
    return out
