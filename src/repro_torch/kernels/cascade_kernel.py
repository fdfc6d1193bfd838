"""Kernels B1 and B2: the cascade's threshold walks.

The counterpart of ``repro.kernels.cascade_kernel``.  ``threshold_step`` is
the single source of the step semantics on tensors; its CUDA twin is
``csrc/threshold_step.cuh``, shared by this module's kernels
(``csrc/cascade.cu``, ``csrc/cascade_chunk.cu``) and the fused stage step
(``megakernel.py``).

* B1 ``cascade_kernel``: the whole-matrix decide over a cascade-ordered
  (N, T) score matrix (``ops.cascade_decide``, the eager Filter-and-Score
  evaluation of the paper's tables).
* B2 ``cascade_chunk_kernel``: one stage's walk, the host
  ``ChunkedExecutor``'s decide (``ops.kernel_decide_fn``); and B2's step
  form ``cascade_chunk_step``: the unfused batch stage's decide, which
  reads each lane's partial sum through ``rows`` and stage ``s``'s
  threshold rows and column mask in place, and writes the stage's
  compaction ``pack`` / ``n_keep`` (``csrc/cascade_chunk.cu``).
* B6 ``cascade_lane_step``: the decide of the unfused streaming step, each
  lane walking its scores with the threshold rows and column mask of its
  own stage, read in place from the plan's (S, W) tables, and the step's
  compaction ``pack`` / ``n_keep`` (``csrc/cascade_lane.cu``).  The
  JAX-shaped ``cascade_lane_kernel`` (per-row (m, ct) threshold slabs, no
  compaction) runs the same kernel.
* B8 ``cascade_group_kernel``: the group decide of a ranking cascade, a
  query's top-k stability margin and its exit, and with ``rows`` the
  group's top-k picks (``csrc/cascade_group.cu``).

Each wrapper sends a CPU tensor to its plain version (``cascade_plain``,
``cascade_chunk_plain``, ``cascade_chunk_step_plain``,
``cascade_lane_plain``, ``cascade_lane_step_plain``, ``cascade_group_plain``
and ``group_topk_rows``) and a CUDA tensor to the hand-written kernel (or
raises).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_N = 256
DEFAULT_CHUNK_T = 8
# the group-capacity quantum of the grouped stage loop, as the reference's
# block_g
DEFAULT_BLOCK_G = 8
# B8's widest bucket (one CTA a group, its scores staged in shared memory)
# and the most groups a CTA of its warp form takes (one warp each)
MAX_GROUP_WIDTH = 4096
MAX_CTA_GROUPS = 8
# B6's stop stage for a walk that flags no lane
NO_STOP = 2**31 - 1
# B1: rows a CTA of one warp walks, one a lane (``csrc/cascade.cu``'s kRows)
B1_WARP_ROWS = 32

__all__ = [
    "threshold_step",
    "cascade_kernel",
    "cascade_plain",
    "cascade_chunk_kernel",
    "cascade_chunk_plain",
    "cascade_chunk_step",
    "cascade_chunk_step_plain",
    "cascade_geometry",
    "cascade_lane_kernel",
    "cascade_lane_plain",
    "cascade_lane_step",
    "cascade_lane_step_plain",
    "cascade_group_kernel",
    "cascade_group_plain",
    "combine_blocks",
    "group_geometry",
    "group_topk_rows",
    "lane_geometry",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_CASCADE_ARGTYPES = [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P, _P, _P]
_LANE_ARGTYPES = [_P] * 7 + [_I] * 9 + [_P] * 7
_STEP_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P] * 7
_GROUP_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P] * 4


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


def cascade_chunk_step_plain(
    g: torch.Tensor,
    rows: torch.Tensor,
    scores: torch.Tensor,
    s: int,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    col_valid: torch.Tensor,
    n_valid=None,
):
    """Plain version of B2's step form (any device): the unfused batch
    stage's decide as the reference writes it
    (``repro/kernels/device_executor.py:832-849``) -> ``(g_new, active
    i32, decided_pos i32, exit_rel i32, pack i32, n_keep)``.  Each lane's
    partial sum is gathered, ``g[rows]``; the scores are masked by stage
    ``s``'s ``col_valid`` row; the lanes walk them with stage ``s``'s
    threshold rows (``cascade_chunk_plain``, exit steps relative to the
    stage); and the lanes still active are packed to the front by a
    cumsum: ``pack`` is each one's destination, ``cap`` for the others,
    and ``n_keep`` (a 0-d int32 tensor) their count.  The last stage's
    survivors are kept too (the caller decides them by beta)."""
    cap = rows.shape[0]
    i32 = torch.int32
    scores = torch.where(col_valid[s][None, :], scores, 0.0)
    g_new, active, dpos, ex_rel = cascade_chunk_plain(
        g[rows], scores, eps_pos[s], eps_neg[s], 0, n_valid
    )
    keep = active.bool() & _live(cap, n_valid, scores.device)
    pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=i32) - 1, cap)
    return g_new, active, dpos, ex_rel, pack, keep.sum(dtype=i32)


def cascade_chunk_step(
    g: torch.Tensor,
    rows: torch.Tensor,
    scores: torch.Tensor,
    s: int,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    col_valid: torch.Tensor,
    n_valid=None,
    block_n: int = DEFAULT_BLOCK_N,
):
    """One unfused batch stage's decide and compaction (B2's step form),
    same contract as ``cascade_chunk_step_plain``.

    ``g`` (cap + 1,) f32 holds the partial sums by buffer slot (slot
    ``cap`` the trash slot), ``rows`` (cap,) int64 each lane's slot (the
    kernel clamps it into [0, cap]), ``scores`` (cap, W) f32 the stage's
    scores, ``eps_pos``/``eps_neg`` (S, W) f32 and ``col_valid`` (S, W)
    bool the plan's tables, read in place at row ``s``; ``n_valid`` as in
    ``cascade_chunk_kernel``.  Up to 1024 lanes it is one launch; past
    that, one launch and ``combine_blocks`` over CTAs of ``block_n``.
    """
    if scores.device.type == "cpu":
        return cascade_chunk_step_plain(
            g, rows, scores, s, eps_pos, eps_neg, col_valid, n_valid
        )
    if scores.device.type != "cuda":
        raise ValueError(f"cascade_chunk_step: unsupported device {scores.device}")
    f32 = torch.float32
    _build.check_cuda(
        "cascade_chunk_step", ("scores", scores, f32), ("g", g, f32),
        ("rows", rows, torch.int64), ("eps_pos", eps_pos, f32),
        ("eps_neg", eps_neg, f32), ("col_valid", col_valid, torch.bool),
    )
    cap, W = scores.shape
    S = eps_pos.shape[0]
    if (
        g.shape != (cap + 1,) or rows.shape != (cap,)
        or eps_pos.shape != (S, W) or eps_neg.shape != (S, W)
        or col_valid.shape != (S, W) or not 0 <= s < S
    ):
        raise ValueError(
            f"cascade_chunk_step: g {tuple(g.shape)}, rows {tuple(rows.shape)}, eps "
            f"{tuple(eps_pos.shape)}/{tuple(eps_neg.shape)}, col_valid "
            f"{tuple(col_valid.shape)}, stage {s} do not fit scores {(cap, W)}"
        )
    mode, blocks, threads = lane_geometry(cap, block_n, compact=True)
    dev = scores.device
    i32 = torch.int32
    g_new = torch.empty(cap, dtype=f32, device=dev)
    act, dec, ex, pack = (torch.empty(cap, dtype=i32, device=dev) for _ in range(4))
    count = torch.empty(() if mode == 1 else blocks, dtype=i32, device=dev)
    if cap == 0:
        count.zero_()
        return g_new, act, dec, ex, pack, count
    ep, en, cv = eps_pos[s], eps_neg[s], col_valid[s]
    nv_ptr, nv_host = _build.n_valid_args(n_valid, cap, dev)
    fn = _build.function("cascade_chunk", "cascade_chunk_step_launch", _STEP_ARGTYPES)
    err = fn(
        g.data_ptr(), rows.data_ptr(), scores.data_ptr(), ep.data_ptr(), en.data_ptr(),
        cv.data_ptr(), nv_ptr, nv_host, cap, W, int(_vec_rows(W, (scores, ep, en), cv)),
        mode, blocks, threads, g_new.data_ptr(), act.data_ptr(), dec.data_ptr(),
        ex.data_ptr(), pack.data_ptr(), count.data_ptr(), _build.stream(dev),
    )
    _build.check("cascade_chunk", err, "cascade_chunk_step")
    _build.LAUNCHES["cascade_chunk_step"] += 1
    outs = (g_new, act, dec, ex, pack, count)
    if mode == 1:
        return outs
    return combine_blocks(outs, cap, threads)


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


def lane_geometry(cap: int, block_n: int, compact: bool) -> tuple[int, int, int]:
    """B6's launch: ``(mode, blocks, threads)``.  Without compaction (the
    JAX-shaped form) mode 0 over CTAs of ``block_n`` lanes.  With it, up to
    1024 lanes run in one CTA of whole warps that writes the pack positions
    and ``n_keep`` itself (mode 1); past that, CTAs of ``block_n`` rounded up
    to whole warps write block-local prefixes and counts (mode 2), which
    ``combine_blocks`` turns into pack positions."""
    if not 1 <= block_n <= 1024:
        raise ValueError(f"cascade_lane: block_n {block_n} not in [1, 1024]")
    if not compact:
        return 0, -(-cap // block_n), block_n
    if cap <= 1024:
        return 1, 1, max(32, -(-cap // 32) * 32)
    bn = -(-block_n // 32) * 32
    return 2, -(-cap // bn), bn


def combine_blocks(outs, cap: int, bn: int, stop=None):
    """Per-block prefixes + counts -> global pack positions: a (n_blocks,)
    exclusive scan instead of a cap-wide cumsum.  Retired lanes, and lanes
    flagged ``stop`` (B6, B7), aim at ``cap``, the buffers' trash slot.
    ``outs`` is ``(g, active, decided_pos, exit_rel, pfx, cnt)``, ``bn`` the
    lanes a block."""
    g, act, dec, ex, pfx, cnt = outs
    off = torch.cumsum(cnt, dim=0, dtype=torch.int32) - cnt  # exclusive
    lane = torch.arange(cap, device=g.device)
    posg = pfx + off[lane // bn]
    keep = act.bool() if stop is None else act.bool() & ~stop
    pack = torch.where(keep, posg, cap)
    return g, act, dec, ex, pack, cnt.sum(dtype=torch.int32)


def _vec_rows(W: int, floats, col_valid) -> bool:
    """Whether ``common.cuh``'s lane walk may take a lane's (W,) rows in
    16-byte loads (its mask rows in 4-byte ones): W a multiple of 4 and
    every float row, and mask row, aligned."""
    return W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in floats) and (
        col_valid is None or col_valid.data_ptr() % 4 == 0
    )


def _lane_launch(g0, scores, stage, eps_pos, eps_neg, col_valid, n_valid, *,
                 stop_stage: int, mode: int, blocks: int, threads: int):
    """One launch of ``csrc/cascade_lane.cu``: ``(g, active, decided_pos,
    exit_rel, pack, count)`` (pack and count None in mode 0, count a 0-d
    tensor in mode 1, (blocks,) in mode 2)."""
    cap, W = scores.shape
    dev = scores.device
    i32 = torch.int32
    g = torch.empty(cap, dtype=torch.float32, device=dev)
    act, dec, ex = (torch.empty(cap, dtype=i32, device=dev) for _ in range(3))
    pack = count = None
    if mode:
        pack = torch.empty(cap, dtype=i32, device=dev)
        count = torch.empty(() if mode == 1 else blocks, dtype=i32, device=dev)
    if cap == 0:
        if count is not None:
            count.zero_()
        return g, act, dec, ex, pack, count
    nv_ptr, nv_host = _build.n_valid_args(n_valid, cap, dev)
    vec = _vec_rows(W, (scores, eps_pos, eps_neg), col_valid)
    fn = _build.function("cascade_lane", "cascade_lane_launch", _LANE_ARGTYPES)
    err = fn(
        g0.data_ptr(), scores.data_ptr(), _build.ptr(stage), eps_pos.data_ptr(),
        eps_neg.data_ptr(), _build.ptr(col_valid), nv_ptr, nv_host, cap, W,
        eps_pos.shape[0], stop_stage, int(vec), mode, blocks, threads, g.data_ptr(),
        act.data_ptr(), dec.data_ptr(), ex.data_ptr(), _build.ptr(pack),
        _build.ptr(count), _build.stream(dev),
    )
    _build.check("cascade_lane", err, "cascade_lane")
    _build.LAUNCHES["cascade_lane"] += 1
    return g, act, dec, ex, pack, count


def cascade_lane_kernel(
    g0: torch.Tensor,
    chunk_scores: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    block_n: int = DEFAULT_BLOCK_N,
    n_valid=None,
):
    """Threshold tests for ONE mixed-stage chunk (B6 in the reference's
    form), same contract as ``cascade_lane_plain``: ``eps_pos``/``eps_neg``
    are (m, ct), each row's thresholds gathered at its own stage.  It runs
    B6's kernel with lane i at table row i, no column mask, no stop and no
    compaction.  ``n_valid`` and ``block_n`` as in ``cascade_chunk_kernel``.
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
    mode, blocks, threads = lane_geometry(m, block_n, compact=False)
    return _lane_launch(
        g0, chunk_scores, None, eps_pos, eps_neg, None, n_valid,
        stop_stage=NO_STOP, mode=mode, blocks=blocks, threads=threads,
    )[:4]


def cascade_lane_step_plain(
    g0: torch.Tensor,
    scores: torch.Tensor,
    stage: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    col_valid: torch.Tensor,
    n_valid=None,
):
    """Plain version of B6's step form (any device): the unfused streaming
    step's decide as the reference writes it -> ``(g, active i32,
    decided_pos i32, exit_rel i32, pack i32, n_keep)``.  Each lane's scores
    are masked by its stage's ``col_valid`` row, it walks them with its
    stage's threshold rows (``cascade_lane_plain``), and the lanes that stay
    active and are not at the last stage (S - 1) are packed to the front by
    a cumsum: ``pack`` is each one's destination, ``cap`` for the others,
    and ``n_keep`` (a 0-d int32 tensor) their count."""
    S = eps_pos.shape[0]
    cap = g0.shape[0]
    i32 = torch.int32
    scores = torch.where(col_valid[stage], scores, 0.0)
    g, active, dpos, ex_rel = cascade_lane_plain(
        g0, scores, eps_pos[stage], eps_neg[stage], n_valid
    )
    keep = active.bool() & ~(stage >= S - 1)
    pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=i32) - 1, cap)
    return g, active, dpos, ex_rel, pack, keep.sum(dtype=i32)


def cascade_lane_step(
    g0: torch.Tensor,
    scores: torch.Tensor,
    stage: torch.Tensor,
    eps_pos: torch.Tensor,
    eps_neg: torch.Tensor,
    col_valid: torch.Tensor,
    n_valid=None,
    block_n: int = DEFAULT_BLOCK_N,
):
    """One unfused streaming step's decide and compaction (B6), same
    contract as ``cascade_lane_step_plain``.

    ``g0`` (cap,) f32 the lanes' partial sums, ``scores`` (cap, W) f32 the
    lanes' stage scores, ``stage`` (cap,) int32 each lane's stage,
    ``eps_pos``/``eps_neg`` (S, W) f32 and ``col_valid`` (S, W) bool the
    plan's tables, read in place at each lane's stage; ``n_valid`` as in
    ``cascade_chunk_kernel``.  Up to 1024 lanes it is one launch; past
    that, one launch and ``combine_blocks`` over CTAs of ``block_n``.
    """
    if scores.device.type == "cpu":
        return cascade_lane_step_plain(
            g0, scores, stage, eps_pos, eps_neg, col_valid, n_valid
        )
    if scores.device.type != "cuda":
        raise ValueError(f"cascade_lane: unsupported device {scores.device}")
    f32 = torch.float32
    _build.check_cuda(
        "cascade_lane", ("scores", scores, f32), ("g0", g0, f32),
        ("stage", stage, torch.int32), ("eps_pos", eps_pos, f32),
        ("eps_neg", eps_neg, f32), ("col_valid", col_valid, torch.bool),
    )
    cap, W = scores.shape
    S = eps_pos.shape[0]
    if (
        g0.shape != (cap,) or stage.shape != (cap,) or S < 1
        or eps_pos.shape != (S, W) or eps_neg.shape != (S, W)
        or col_valid.shape != (S, W)
    ):
        raise ValueError(
            f"cascade_lane: g0 {tuple(g0.shape)}, stage {tuple(stage.shape)}, eps "
            f"{tuple(eps_pos.shape)}/{tuple(eps_neg.shape)}, col_valid "
            f"{tuple(col_valid.shape)} do not fit scores {(cap, W)}"
        )
    mode, blocks, threads = lane_geometry(cap, block_n, compact=True)
    outs = _lane_launch(
        g0, scores, stage, eps_pos, eps_neg, col_valid, n_valid,
        stop_stage=S - 1, mode=mode, blocks=blocks, threads=threads,
    )
    if mode == 1:
        return outs
    return combine_blocks(outs, cap, threads, stop=stage >= S - 1)


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


def cascade_geometry(n: int, block_n: int) -> tuple[int, int]:
    """B1's launch: ``(blocks, threads)``, one warp of ``B1_WARP_ROWS``
    rows a CTA, whatever ``block_n`` (the reference's row block, which
    must lie in [1, 1024]): a warp's ring of staged tiles takes 34 KB of
    shared memory, and N = 2000 rows spread over 63 SMs.  Neither changes
    a result."""
    if not 1 <= block_n <= 1024:
        raise ValueError(f"cascade: block_n {block_n} not in [1, 1024]")
    return -(-n // B1_WARP_ROWS), B1_WARP_ROWS


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
    the reference casts them.  ``block_n`` is the reference's row block
    (checked; the kernel takes 32 rows a CTA, ``cascade_geometry``);
    ``chunk_t`` is the plain version's steps between two checks of whether
    a row is left, which the kernel makes once a staged tile of 32 columns.
    Neither changes a result.
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
    blocks, threads = cascade_geometry(n, int(block_n))
    dec = torch.empty(n, dtype=torch.int32, device=dev)
    ex = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dec, ex
    # tensor-map (TMA) tiles where the rows are 16-byte aligned, else
    # 4-byte copies
    tma = T % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (scores_ordered, ep, en))
    fn = _build.function("cascade", "cascade_launch", _CASCADE_ARGTYPES)
    err = fn(
        scores_ordered.data_ptr(), ep.data_ptr(), en.data_ptr(), n, T, float(beta), int(tma),
        blocks, threads, dec.data_ptr(), ex.data_ptr(), _build.stream(dev),
    )
    _build.check("cascade", err, "cascade")
    _build.LAUNCHES["cascade"] += 1
    return dec, ex


def cascade_group_plain(
    g: torch.Tensor, valid: torch.Tensor, eps: torch.Tensor, k: int, n_live=None
):
    """Plain version of B8 (any device, float32) -> (margin (G,) f32,
    exit (G,) int32).

    The reference's form: k + 1 masked-max passes over each group's valid
    lanes, each consuming its first (lowest-lane) hit; the margin is the
    k-th minus the (k+1)-th best score, +inf for a group of at most k
    documents.  Only the first ``n_live`` groups (None: all) may exit, and
    strictly when ``margin > eps``.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    G, _ = g.shape
    dev = g.device
    ninf = torch.tensor(float("-inf"), dtype=g.dtype, device=dev)
    valid = valid != 0
    work = torch.where(valid, g, ninf)
    avail = valid
    vk = vk1 = None
    for i in range(k + 1):
        masked = torch.where(avail, work, ninf)
        cur = masked.amax(dim=1)
        if i == k - 1:
            vk = cur
        elif i == k:
            vk1 = cur
        if i < k:
            hit = avail & (masked == cur[:, None])
            first = hit & (torch.cumsum(hit, dim=1, dtype=torch.int32) == 1)
            avail = avail & ~first
    size = valid.sum(dim=1)
    margin = torch.where(size <= k, float("inf"), vk - vk1)
    exit_g = _live(G, n_live, dev) & (margin > eps)
    return margin, exit_g.to(torch.int32)


def group_topk_rows(g, valid, rows, k: int) -> torch.Tensor:
    """Per-group top-k GLOBAL document ids over a (G, B) bucket layout: the
    picks of B8's plain version (``cascade_group_kernel`` with ``rows``).

    The reference takes k segment-max passes, each consuming its first
    (lowest-lane) hit; its picks are a group's valid lanes in the order
    (score descending, lane ascending).  Here that order comes from one
    stable descending sort of an exact int64 key per lane: the score's f32
    bits mapped to an order-preserving integer (-0.0 taken as +0.0, as
    ``==`` takes them), times two, plus the valid bit, so a valid lane
    precedes an invalid one of equal score (-inf) and equal keys keep lane
    order.  A NaN on a valid lane makes every one of the reference's passes
    NaN, so no lane is consumed: such a group gets no picks.  Returns (G,
    k) int32 ids, -1 past the group's size and in a group with a valid NaN.
    """
    G, B = g.shape
    dev = g.device
    ok = valid != 0
    w = torch.where(ok, g, float("-inf"))
    w = torch.where(w == 0, 0.0, w)
    bits = w.view(torch.int32).long()
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) * 2 + ok.long()
    lanes = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    picked = torch.gather(rows, 1, lanes).to(torch.int32)
    pos = torch.arange(lanes.shape[1], device=dev)
    live = pos[None, :] < ok.sum(dim=1, keepdim=True)
    live = live & ~(ok & torch.isnan(g)).any(dim=1, keepdim=True)
    picked = torch.where(live, picked, -1)
    if lanes.shape[1] < k:  # k > B: the tail is always past the group's size
        picked = torch.nn.functional.pad(picked, (0, k - lanes.shape[1]), value=-1)
    return picked


def group_geometry(G: int, B: int, sm_count: int) -> tuple[int, int, int]:
    """B8's launch: ``(blocks, threads, shared memory bytes)``.  Up to 32
    lanes a group is one warp, with as many groups a CTA (at most
    ``MAX_CTA_GROUPS``) as spread G groups over about one CTA an SM; a
    wider group is one CTA of up to 1024 threads, its B scores staged in
    shared memory.  Raises past ``MAX_GROUP_WIDTH``."""
    if not 1 <= B <= MAX_GROUP_WIDTH:
        raise ValueError(
            f"cascade_group: bucket width B = {B} not in [1, MAX_GROUP_WIDTH = "
            f"{MAX_GROUP_WIDTH}]"
        )
    if B <= 32:
        per = max(1, min(MAX_CTA_GROUPS, -(-G // sm_count)))
        return -(-G // per), 32 * per, 0
    return G, min(1024, -(-B // 32) * 32), 4 * B


def cascade_group_kernel(
    g: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    k: int,
    n_live=None,
    rows=None,
):
    """Group decide over one (G, B) bucket layout (B8) -> ``(margin (G,)
    f32, exit (G,) int32)``, and with ``rows`` also ``picks``: the contract
    of ``cascade_group_plain``, followed by ``group_topk_rows`` when
    ``rows`` is given.

    ``g`` (G, B) float32 carries each group's partial document scores,
    ``valid`` (G, B) int32 marks real lanes, ``eps`` (G,) float32 is each
    group's margin threshold.  ``n_live`` (None, an int, or an int32 scalar
    tensor on the device) marks only the first groups live: the grouped
    stage loop keeps live groups front-packed and the count on the card.
    Margins are reported for every group, exits only for live ones.
    ``rows`` (G, B) int64 holds the lanes' global row ids; ``picks`` (G, k)
    int32 are those of each group's first k valid lanes in the order (score
    descending, lane ascending), -1 past the group's size and in a group
    with a valid NaN.
    """
    if g.device.type == "cpu":
        margin, exit_g = cascade_group_plain(g, valid, eps, k, n_live)
        if rows is None:
            return margin, exit_g
        return margin, exit_g, group_topk_rows(g, valid, rows, k)
    if g.device.type != "cuda":
        raise ValueError(f"cascade_group: unsupported device {g.device}")
    checks = [("g", g, torch.float32), ("valid", valid, torch.int32),
              ("eps", eps, torch.float32)]
    if rows is not None:
        checks.append(("rows", rows, torch.int64))
    _build.check_cuda("cascade_group", *checks)
    if (
        g.ndim != 2 or valid.shape != g.shape or eps.shape != g.shape[:1]
        or (rows is not None and rows.shape != g.shape)
    ):
        raise ValueError(
            f"cascade_group: g {tuple(g.shape)}, valid {tuple(valid.shape)}, eps "
            f"{tuple(eps.shape)}, rows {None if rows is None else tuple(rows.shape)} "
            f"are not (G, B), (G, B), (G,), (G, B)"
        )
    G, B = g.shape
    if k < 1:
        raise ValueError(f"cascade_group: k = {k} must be >= 1")
    dev = g.device
    blocks, threads, smem = group_geometry(G, B, _build.sm_count(dev))
    margin = torch.empty(G, dtype=torch.float32, device=dev)
    exit_g = torch.empty(G, dtype=torch.int32, device=dev)
    picks = None if rows is None else torch.empty(G, k, dtype=torch.int32, device=dev)
    if G:
        nl_ptr, nl_host = _build.n_valid_args(n_live, G, dev)
        fn = _build.function("cascade_group", "cascade_group_launch", _GROUP_ARGTYPES)
        err = fn(
            g.data_ptr(), valid.data_ptr(), eps.data_ptr(), _build.ptr(rows), nl_ptr,
            nl_host, G, B, int(k), blocks, threads, smem, margin.data_ptr(),
            exit_g.data_ptr(), _build.ptr(picks), _build.stream(dev),
        )
        _build.check("cascade_group", err, "cascade_group")
        _build.LAUNCHES["cascade_group"] += 1
    if rows is None:
        return margin, exit_g
    return margin, exit_g, picks
