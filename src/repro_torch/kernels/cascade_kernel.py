"""Kernels B1 and B2: the cascade's threshold walks.

The counterpart of ``repro.kernels.cascade_kernel``.  ``threshold_step`` is
the single source of the step semantics on tensors; its CUDA twin is
``csrc/threshold_step.cuh``, shared by this module's kernels
(``csrc/cascade.cu``, ``csrc/cascade_chunk.cu``) and the fused stage step
(``megakernel.py``).

* B1 ``cascade_kernel``: the whole-matrix decide over a cascade-ordered
  (N, T) score matrix (``ops.cascade_decide``, the eager Filter-and-Score
  evaluation of the paper's tables).
* B2 ``cascade_chunk_kernel``: one stage's walk, the serving path's decide.
* B6 ``cascade_lane_kernel``: B2 with a threshold row per lane, the decide
  of the unfused streaming step (``csrc/cascade_lane.cu``).

Each wrapper sends a CPU tensor to its plain version (``cascade_plain``,
``cascade_chunk_plain``, ``cascade_lane_plain``) and a CUDA tensor to the
hand-written kernel (or raises).  The group decide of the reference module
is listed in ROADMAP.md.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_N = 256
DEFAULT_CHUNK_T = 8

__all__ = [
    "threshold_step",
    "cascade_kernel",
    "cascade_plain",
    "cascade_chunk_kernel",
    "cascade_chunk_plain",
    "cascade_lane_kernel",
    "cascade_lane_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_CASCADE_ARGTYPES = [_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P]
_LANE_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]


def threshold_step(g, active, decided_pos, exit_step, f_t, ep, en, step_1b):
    """One cascade threshold test on tensors.  Mirrored bit-identically by
    ``csrc/threshold_step.cuh`` and ``core.executor.decide_chunk_reference``;
    a semantics change here must be replayed there."""
    g = g + torch.where(active, f_t, 0.0)
    out_neg = active & (g < en)  # negative exit priority (matches fit)
    out_pos = active & (g > ep) & ~out_neg
    newly = out_neg | out_pos
    decided_pos = decided_pos | out_pos
    exit_step = torch.where(newly, step_1b, exit_step)
    active = active & ~newly
    return g, active, decided_pos, exit_step


def _live(m: int, n_valid, device) -> torch.Tensor:
    """(m,) bool: rows before ``min(m, n_valid)``."""
    lane = torch.arange(m, device=device)
    if n_valid is None:
        return torch.ones(m, dtype=torch.bool, device=device)
    return lane < torch.clamp(torch.as_tensor(n_valid, device=device), max=m)


def cascade_chunk_plain(
    g0: torch.Tensor,
    chunk_scores: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    t0: int,
    n_valid=None,
):
    """Plain version of B2 (any device, float32).

    Returns (g, active int32, decided_pos int32, exit_step int32) each (m,);
    ``exit_step`` is the absolute 1-based step, 0 where the row survived.
    Rows at or past ``n_valid`` start inactive.
    """
    m, ct = chunk_scores.shape
    dev = chunk_scores.device
    g = g0.clone()
    active = _live(m, n_valid, dev)
    dec = torch.zeros(m, dtype=torch.bool, device=dev)
    ex = torch.zeros(m, dtype=torch.int32, device=dev)
    for j in range(ct):
        g, active, dec, ex = threshold_step(
            g, active, dec, ex, chunk_scores[:, j], eps_pos[j], eps_neg[j],
            t0 + j + 1,
        )
    return g, active.to(torch.int32), dec.to(torch.int32), ex


def cascade_chunk_kernel(
    g0: torch.Tensor,
    chunk_scores: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    t0: int,
    block_n: int = DEFAULT_BLOCK_N,
    n_valid=None,
):
    """Threshold tests for ONE cascade stage (B2), same contract as
    ``cascade_chunk_plain``.

    ``n_valid`` (None, an int, or an int32 scalar tensor on the device)
    marks only the first rows live: the device executor keeps survivors
    front-packed, so the live count is data the kernel reads, not a shape.
    ``block_n`` is the kernel's threads per CTA.
    """
    if chunk_scores.device.type == "cpu":
        return cascade_chunk_plain(g0, chunk_scores, eps_pos, eps_neg, t0, n_valid)
    if chunk_scores.device.type != "cuda":
        raise ValueError(f"cascade_chunk: unsupported device {chunk_scores.device}")
    f32 = torch.float32
    _build.check_cuda(
        "cascade_chunk", ("chunk_scores", chunk_scores, f32), ("g0", g0, f32),
        ("eps_pos", eps_pos, f32), ("eps_neg", eps_neg, f32),
    )
    m, ct = chunk_scores.shape
    if g0.shape != (m,) or eps_pos.shape != (ct,) or eps_neg.shape != (ct,):
        raise ValueError(
            f"cascade_chunk: g0 {tuple(g0.shape)}, eps {tuple(eps_pos.shape)}/"
            f"{tuple(eps_neg.shape)} do not fit scores {(m, ct)}"
        )
    if not 1 <= block_n <= 1024:
        raise ValueError(f"cascade_chunk: block_n {block_n} not in [1, 1024]")
    dev = chunk_scores.device
    g = torch.empty(m, dtype=f32, device=dev)
    active, dec, ex = (torch.empty(m, dtype=torch.int32, device=dev) for _ in range(3))
    if m == 0:
        return g, active, dec, ex
    nv_ptr, nv_host = _build.n_valid_args(n_valid, m, dev)
    fn = _build.function("cascade_chunk", "cascade_chunk_launch", _ARGTYPES)
    err = fn(
        g0.data_ptr(), chunk_scores.data_ptr(), eps_pos.data_ptr(),
        eps_neg.data_ptr(), nv_ptr, nv_host, m, ct, int(t0), int(block_n),
        g.data_ptr(), active.data_ptr(), dec.data_ptr(), ex.data_ptr(),
        _build.stream(dev),
    )
    _build.check("cascade_chunk", err, "cascade_chunk")
    _build.LAUNCHES["cascade_chunk"] += 1
    return g, active, dec, ex


def cascade_lane_plain(
    g0: torch.Tensor,
    chunk_scores: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    n_valid=None,
):
    """Plain version of B6 (any device, float32): ``cascade_chunk_plain``
    with (m, ct) PER-ROW threshold rows, so one buffer mixes rows at
    different stages.  ``exit_step`` is RELATIVE (1-based within the chunk,
    0 where the row survived); the caller rebases by each row's stage
    start.  Rows at or past ``n_valid`` start inactive."""
    m, ct = chunk_scores.shape
    dev = chunk_scores.device
    g = g0.clone()
    active = _live(m, n_valid, dev)
    dec = torch.zeros(m, dtype=torch.bool, device=dev)
    ex = torch.zeros(m, dtype=torch.int32, device=dev)
    for j in range(ct):
        g, active, dec, ex = threshold_step(
            g, active, dec, ex, chunk_scores[:, j], eps_pos[:, j], eps_neg[:, j],
            j + 1,
        )
    return g, active.to(torch.int32), dec.to(torch.int32), ex


def cascade_lane_kernel(
    g0: torch.Tensor,
    chunk_scores: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    n_valid=None,
):
    """Threshold tests for ONE mixed-stage chunk (B6), same contract as
    ``cascade_lane_plain``: ``eps_pos``/``eps_neg`` are (m, ct), each row's
    thresholds gathered at its own stage.  ``n_valid`` and ``block_n`` as
    in ``cascade_chunk_kernel``.
    """
    if chunk_scores.device.type == "cpu":
        return cascade_lane_plain(g0, chunk_scores, eps_pos, eps_neg, n_valid)
    if chunk_scores.device.type != "cuda":
        raise ValueError(f"cascade_lane: unsupported device {chunk_scores.device}")
    f32 = torch.float32
    _build.check_cuda(
        "cascade_lane", ("chunk_scores", chunk_scores, f32), ("g0", g0, f32),
        ("eps_pos", eps_pos, f32), ("eps_neg", eps_neg, f32),
    )
    m, ct = chunk_scores.shape
    if g0.shape != (m,) or eps_pos.shape != (m, ct) or eps_neg.shape != (m, ct):
        raise ValueError(
            f"cascade_lane: g0 {tuple(g0.shape)}, eps {tuple(eps_pos.shape)}/"
            f"{tuple(eps_neg.shape)} do not fit scores {(m, ct)}"
        )
    if not 1 <= block_n <= 1024:
        raise ValueError(f"cascade_lane: block_n {block_n} not in [1, 1024]")
    dev = chunk_scores.device
    g = torch.empty(m, dtype=f32, device=dev)
    active, dec, ex = (torch.empty(m, dtype=torch.int32, device=dev) for _ in range(3))
    if m == 0:
        return g, active, dec, ex
    nv_ptr, nv_host = _build.n_valid_args(n_valid, m, dev)
    fn = _build.function("cascade_lane", "cascade_lane_launch", _LANE_ARGTYPES)
    err = fn(
        g0.data_ptr(), chunk_scores.data_ptr(), eps_pos.data_ptr(),
        eps_neg.data_ptr(), nv_ptr, nv_host, m, ct, int(block_n),
        g.data_ptr(), active.data_ptr(), dec.data_ptr(), ex.data_ptr(),
        _build.stream(dev),
    )
    _build.check("cascade_lane", err, "cascade_lane")
    _build.LAUNCHES["cascade_lane"] += 1
    return g, active, dec, ex


def cascade_plain(
    scores_ordered: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    beta: float,
    chunk_t: int = DEFAULT_CHUNK_T,
):
    """Plain version of B1 (any device) -> (decisions int32, exit_step
    int32), each (N,).

    Every row walks the T thresholds with ``threshold_step`` at the scores'
    dtype (the thresholds and beta are cast to it, as the reference casts
    them); ``exit_step`` is 1-based, T for a row that never exits, and a
    row still active at T is decided by ``g >= beta``.  The walk stops at
    the first chunk boundary where no row is active (it changes no result).
    """
    n, T = scores_ordered.shape
    dev, dt = scores_ordered.device, scores_ordered.dtype
    g = torch.zeros(n, dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    dec = torch.zeros(n, dtype=torch.bool, device=dev)
    ex = torch.full((n,), T, dtype=torch.int32, device=dev)
    ep, en = eps_pos.to(device=dev, dtype=dt), eps_neg.to(device=dev, dtype=dt)
    for c0 in range(0, T, chunk_t):
        if not bool(active.any()):
            break
        for t in range(c0, min(c0 + chunk_t, T)):
            g, active, dec, ex = threshold_step(
                g, active, dec, ex, scores_ordered[:, t], ep[t], en[t], t + 1
            )
    decisions = torch.where(active, g >= torch.tensor(beta, dtype=dt, device=dev), dec)
    return decisions.to(torch.int32), ex


def cascade_kernel(
    scores_ordered: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    beta: float,
    block_n: int = DEFAULT_BLOCK_N,
    chunk_t: int = DEFAULT_CHUNK_T,
):
    """Early-exit cascade over a cascade-ordered (N, T) float32 score matrix
    (B1), same contract as ``cascade_plain``.

    The thresholds and beta are cast to the scores' dtype (float32), as
    the reference casts them.  ``block_n`` is the kernel's rows per CTA,
    ``chunk_t`` the steps between two checks of whether a warp has a row
    left; neither changes a result.
    """
    if scores_ordered.device.type == "cpu":
        return cascade_plain(scores_ordered, eps_pos, eps_neg, beta, chunk_t)
    if scores_ordered.device.type != "cuda":
        raise ValueError(f"cascade: unsupported device {scores_ordered.device}")
    f32 = torch.float32
    dev = scores_ordered.device
    ep = eps_pos.to(device=dev, dtype=f32).contiguous()
    en = eps_neg.to(device=dev, dtype=f32).contiguous()
    _build.check_cuda(
        "cascade", ("scores_ordered", scores_ordered, f32), ("eps_pos", ep, f32),
        ("eps_neg", en, f32),
    )
    if scores_ordered.ndim != 2:
        raise ValueError("cascade: scores_ordered must be (N, T)")
    n, T = scores_ordered.shape
    if ep.shape != (T,) or en.shape != (T,):
        raise ValueError(
            f"cascade: eps {tuple(ep.shape)}/{tuple(en.shape)} do not fit T = {T}"
        )
    if T < 1 or chunk_t < 1:
        raise ValueError(f"cascade: T = {T} and chunk_t = {chunk_t} must be >= 1")
    threads = -(-int(block_n) // 32) * 32  # whole warps for the vote
    if not 32 <= threads <= 1024:
        raise ValueError(f"cascade: block_n {block_n} not in [1, 1024]")
    dec = torch.empty(n, dtype=torch.int32, device=dev)
    ex = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dec, ex
    fn = _build.function("cascade", "cascade_launch", _CASCADE_ARGTYPES)
    err = fn(
        scores_ordered.data_ptr(), ep.data_ptr(), en.data_ptr(), n, T,
        int(chunk_t), float(beta), threads, dec.data_ptr(),
        ex.data_ptr(), _build.stream(dev),
    )
    _build.check("cascade", err, "cascade")
    _build.LAUNCHES["cascade"] += 1
    return dec, ex
