"""Kernels B4 and B7: the fused cascade stage step, with f32 parameter slabs.

The counterpart of ``repro.kernels.megakernel`` (tree, matrix and lattice
variants; B4 for the batch path, B7 for streaming admission).  One stage step of the device executor is otherwise
three passes over the survivor buffer: the score kernel (B3 or B5) writes a
(cap, W) score buffer, the chunk decide (B2) reads it back, and a cap-wide
cumsum packs the survivors.  ``csrc/mega_stage.cu`` fuses them into one
kernel per row block: select the stage's slab, score its W models, walk
``threshold_step`` W times, and emit the block-local compaction prefix and
the block's survivor count; ``_combine_blocks`` turns those into pack
positions with a (n_blocks,) exclusive scan.  The lattice variant scores
with the arithmetic of ``csrc/lattice.cuh``, shared with B5, and its plain
version calls ``apply_lattice_scores``, so fused and unfused lattice
scores agree bit for bit.

B7 (``mega_lane``) is the same step for a buffer whose lanes sit at
different stages: each lane scores the W models of its own stage with its
own threshold row, and lanes running their last stage (``stop``) are left
out of the compaction prefix.  The kernel reads each lane's stage row of
the stacked slabs in place; its plain version keeps the reference's form,
``gather_lane_slabs`` and then the per-lane math of ``lane_scores``, which
the scorers' ``lane_fn`` share.

``ParamSlabs`` holds the cascade-ordered, stage-stacked parameters.  Only
``quant="f32"`` is ported: the bf16/int8 storage of the reference (and its
tolerance oracle) is ROADMAP A9.  Blocks past the live count write inert
outputs and compute nothing, the same block-guard billing as the
multi-kernel path, so the fused and unfused paths are bit-identical in
results and in billing.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.ensembles.lattice import apply_lattice_scores, interpolate
from repro_torch.kernels import _build
from repro_torch.kernels.cascade_kernel import threshold_step
from repro_torch.kernels.lattice_kernel import MAX_DIMS

__all__ = [
    "ParamSlabs",
    "QUANTS",
    "build_lattice_slabs",
    "build_matrix_slabs",
    "build_tree_slabs",
    "check_quant",
    "gather_lane_slabs",
    "lane_scores",
    "mega_lane",
    "mega_lane_kernel",
    "mega_lane_plain",
    "mega_stage",
    "mega_stage_kernel",
    "mega_stage_plain",
]

QUANTS = ("f32", "bf16", "int8")

_P, _I = ctypes.c_void_p, ctypes.c_int
_TREE_ARGTYPES = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I] + [_P] * 12
_MATRIX_ARGTYPES = [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I] + [_P] * 10
_LATTICE_ARGTYPES = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I] + [_P] * 11
_LANE_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P] + [_I] * 7 + [_P] * 12


def check_quant(quant: str) -> None:
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if quant != "f32":
        raise NotImplementedError(
            f"quant {quant!r} is not ported yet: quantized slab storage is "
            "ROADMAP A9; only 'f32' runs in repro_torch"
        )


@dataclasses.dataclass(frozen=True)
class ParamSlabs:
    """Cascade-ordered, stage-stacked parameter slabs on one device.

    ``data`` maps slab names to (S, W, ...) tensors, one uniform-width slab
    per stage, zero-padded on the model axis (padded trees and lattices
    score exactly 0.0, which the ±inf threshold padding keeps inert).  For
    the matrix variant the payload is the prepared operand itself, and
    ``data`` holds only the (S,) true stage widths the kernel masks with.
    """

    variant: str  # "matrix" | "tree" | "lattice"
    quant: str  # "f32"
    data: dict
    W: int
    S: int


def _stack_stages(dplan, arr: np.ndarray, dtype) -> np.ndarray:
    """(T, ...) cascade-ordered array -> (S, W, ...) per-stage stack,
    zero-padded past each stage's true width."""
    out = np.zeros((dplan.S, dplan.W) + arr.shape[1:], dtype=dtype)
    for s, (t0, t1) in enumerate(dplan.plan.stages):
        out[s, : t1 - t0] = arr[t0:t1]
    return out


def build_matrix_slabs(dplan, quant: str = "f32", device="cuda") -> ParamSlabs:
    """Matrix-variant slabs: the payload is the prepared (n, T_pad) score
    matrix, so the record carries only the stages' first cascade positions
    and true widths (column t0 + j of a narrow stage is the NEXT stage's
    real score; the kernels mask with the width)."""
    check_quant(quant)
    data = {
        "t0": np.asarray(dplan.stage_t0, dtype=np.int32),
        "widths": np.asarray(dplan.widths, dtype=np.int32),
    }
    return ParamSlabs(
        variant="matrix", quant=quant,
        data={k: torch.from_numpy(v).to(device) for k, v in data.items()},
        W=dplan.W, S=dplan.S,
    )


def build_tree_slabs(
    dplan, feats_ordered, thrs_ordered, leaves_ordered, quant: str = "f32",
    device="cuda",
) -> ParamSlabs:
    """Oblivious-tree slabs: feature ids, thresholds and leaf tables of the
    cascade-ordered forest, stacked per stage."""
    check_quant(quant)
    data = {
        "feats": _stack_stages(dplan, np.asarray(feats_ordered), np.int32),
        "thrs": _stack_stages(dplan, np.asarray(thrs_ordered), np.float32),
        "payload": _stack_stages(dplan, np.asarray(leaves_ordered), np.float32),
    }
    return ParamSlabs(
        variant="tree", quant=quant,
        data={k: torch.from_numpy(v).to(device) for k, v in data.items()},
        W=dplan.W, S=dplan.S,
    )


def build_lattice_slabs(
    dplan, theta_ordered, feats_ordered, quant: str = "f32", device="cuda"
) -> ParamSlabs:
    """Lattice slabs: the vertex values (the payload) and feature ids of the
    cascade-ordered ensemble, stacked per stage.  ``lattice_stage_scorer``
    passes ``dplan.quant``."""
    check_quant(quant)
    data = {
        "feats": _stack_stages(dplan, np.asarray(feats_ordered), np.int32),
        "payload": _stack_stages(dplan, np.asarray(theta_ordered), np.float32),
    }
    return ParamSlabs(
        variant="lattice", quant=quant,
        data={k: torch.from_numpy(v).to(device) for k, v in data.items()},
        W=dplan.W, S=dplan.S,
    )


def _block_geometry(cap: int, block_n: int) -> tuple[int, int]:
    bn = min(block_n, cap) if cap else block_n
    return bn, -(-cap // bn) if cap else 0


def _walk_and_pack(g0, n_valid, *, W, block_n, score_j, ep_j, en_j, stop=None):
    """The plain walk and block prefix of B4 and B7 -> ``(g, active i32,
    decided_pos i32, exit_rel i32, pfx i32, cnt i32)``: W steps of
    ``threshold_step`` with relative exits for the lanes before
    ``n_valid``, then each row block's prefix ``cumsum(keep) - 1`` and
    count of the lanes that stay active (and, for B7, are not flagged
    ``stop``).  Blocks at or past ``n_valid`` return ``g0`` and zeros, as
    the kernels' skipped blocks do."""
    cap = g0.shape[0]
    dev = g0.device
    bn, nb = _block_geometry(cap, block_n)
    lane = torch.arange(cap, device=dev)
    nv = torch.clamp(torch.as_tensor(n_valid, device=dev), max=cap)
    live_block = lane // bn * bn < nv
    g = g0.clone()
    active = lane < nv
    dec = torch.zeros(cap, dtype=torch.bool, device=dev)
    ex = torch.zeros(cap, dtype=torch.int32, device=dev)
    for j in range(W):
        g, active, dec, ex = threshold_step(
            g, active, dec, ex, score_j(j), ep_j(j), en_j(j), j + 1
        )
    keep = torch.zeros(nb * bn, dtype=torch.int32, device=dev)
    keep[:cap] = (active if stop is None else active & ~stop).to(torch.int32)
    keep = keep.reshape(nb, bn)
    pfx = (torch.cumsum(keep, dim=1, dtype=torch.int32) - 1).reshape(-1)[:cap]
    cnt = keep.sum(dim=1, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (
        torch.where(live_block, g, g0),
        active.to(torch.int32),
        dec.to(torch.int32),
        ex,
        torch.where(live_block, pfx, zero),
        cnt,
    )


def mega_stage_plain(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """Plain version of B4 (any device): the raw per-block outputs
    ``(g, active i32, decided_pos i32, exit_rel i32, pfx i32, cnt i32)``,
    the first five (cap,), ``cnt`` (n_blocks,)."""
    cap = g0.shape[0]
    dev = g0.device
    if slabs.variant == "tree":
        feats, thrs = slabs.data["feats"][stage], slabs.data["thrs"][stage]
        leaves = slabs.data["payload"][stage]

        def score_j(j):
            idx = torch.zeros(cap, dtype=torch.int64, device=dev)
            for k in range(feats.shape[1]):
                idx = 2 * idx + (x[:, feats[j, k]] > thrs[j, k]).long()
            return leaves[j][idx]
    elif slabs.variant == "matrix":
        width = slabs.data["widths"][stage]

        def score_j(j):
            return torch.where(j < width, x[:, t0 + j], 0.0)
    elif slabs.variant == "lattice":
        scores = apply_lattice_scores(
            {"feats": slabs.data["feats"][stage], "theta": slabs.data["payload"][stage]},
            x,
        )

        def score_j(j):
            return scores[:, j]
    else:
        raise ValueError(f"mega_stage: unknown variant {slabs.variant!r}")
    return _walk_and_pack(
        g0, n_valid, W=slabs.W, block_n=block_n, score_j=score_j,
        ep_j=lambda j: eps_pos[stage, j], en_j=lambda j: eps_neg[stage, j],
    )


def mega_stage_kernel(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """B4, same contract as ``mega_stage_plain``: a CPU tensor goes to the
    plain version, a CUDA tensor to ``csrc/mega_stage.cu``.

    ``x`` is the gathered operand for the buffer's rows: (cap, d) feature
    rows for the tree and lattice variants, the (cap, T_pad) prepared score
    matrix for the matrix variant.  ``stage``/``t0`` are the stage index
    and its first cascade position; ``n_valid`` (an int or an int32 scalar tensor on the
    device) the live count; ``eps_pos``/``eps_neg`` the full (S, W)
    threshold tables, from which the kernel selects the stage's row.
    """
    if g0.device.type == "cpu":
        return mega_stage_plain(
            slabs, x, g0, stage, t0, n_valid, eps_pos, eps_neg, block_n=block_n
        )
    if g0.device.type != "cuda":
        raise ValueError(f"mega_stage: unsupported device {g0.device}")
    check_quant(slabs.quant)
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("g0", g0, f32), ("x", x, f32), ("eps_pos", eps_pos, f32),
        ("eps_neg", eps_neg, f32),
    ]
    if slabs.variant == "tree":
        checks += [
            ("feats", slabs.data["feats"], i32), ("thrs", slabs.data["thrs"], f32),
            ("leaves", slabs.data["payload"], f32),
        ]
    elif slabs.variant == "matrix":
        checks.append(("widths", slabs.data["widths"], i32))
    elif slabs.variant == "lattice":
        checks += [
            ("feats", slabs.data["feats"], i32), ("theta", slabs.data["payload"], f32),
        ]
    else:
        raise ValueError(f"mega_stage: unknown variant {slabs.variant!r}")
    _build.check_cuda("mega_stage", *checks)
    cap = g0.shape[0]
    S, W = slabs.S, slabs.W
    if x.ndim != 2 or x.shape[0] != cap or eps_pos.shape != (S, W) or eps_neg.shape != (S, W):
        raise ValueError(
            f"mega_stage: x {tuple(x.shape)}, eps {tuple(eps_pos.shape)} do not "
            f"fit cap {cap}, slabs (S={S}, W={W})"
        )
    if not 0 <= stage < S:
        raise ValueError(f"mega_stage: stage {stage} not in [0, {S})")
    bn, nb = _block_geometry(cap, block_n)
    if not 1 <= bn <= 1024:
        raise ValueError(f"mega_stage: block_n {bn} not in [1, 1024]")
    dev = g0.device
    g = torch.empty(cap, dtype=f32, device=dev)
    act, dec, ex, pfx = (torch.empty(cap, dtype=i32, device=dev) for _ in range(4))
    cnt = torch.empty(nb, dtype=i32, device=dev)
    if cap == 0:
        return g, act, dec, ex, pfx, cnt
    nv_ptr, nv_host = _build.n_valid_args(n_valid, cap, dev)
    outs = [t.data_ptr() for t in (g, act, dec, ex, pfx, cnt)]
    if slabs.variant == "tree":
        feats = slabs.data["feats"]
        depth = feats.shape[2]
        fn = _build.function("mega_stage", "mega_stage_tree_launch", _TREE_ARGTYPES)
        err = fn(
            x.data_ptr(), g0.data_ptr(), int(stage), nv_ptr, nv_host, cap,
            x.shape[1], W, depth, bn, feats.data_ptr(),
            slabs.data["thrs"].data_ptr(), slabs.data["payload"].data_ptr(),
            eps_pos.data_ptr(), eps_neg.data_ptr(), *outs, _build.stream(dev),
        )
    elif slabs.variant == "lattice":
        feats = slabs.data["feats"]
        dims = feats.shape[2]
        if not 1 <= dims <= MAX_DIMS:
            raise ValueError(f"mega_stage: lattice S = {dims} not in [1, {MAX_DIMS}]")
        fn = _build.function(
            "mega_stage", "mega_stage_lattice_launch", _LATTICE_ARGTYPES
        )
        err = fn(
            x.data_ptr(), g0.data_ptr(), int(stage), nv_ptr, nv_host, cap,
            x.shape[1], W, dims, bn, feats.data_ptr(),
            slabs.data["payload"].data_ptr(), eps_pos.data_ptr(),
            eps_neg.data_ptr(), *outs, _build.stream(dev),
        )
    else:
        if not 0 <= t0 <= x.shape[1] - W:
            raise ValueError(f"mega_stage: columns [{t0}, {t0 + W}) outside x")
        fn = _build.function(
            "mega_stage", "mega_stage_matrix_launch", _MATRIX_ARGTYPES
        )
        err = fn(
            x.data_ptr(), g0.data_ptr(), int(stage), int(t0), nv_ptr, nv_host,
            cap, x.shape[1], W, bn, slabs.data["widths"].data_ptr(),
            eps_pos.data_ptr(), eps_neg.data_ptr(), *outs, _build.stream(dev),
        )
    _build.check("mega_stage", err, f"mega_stage[{slabs.variant}]")
    _build.LAUNCHES[f"mega_stage_{slabs.variant}"] += 1
    return g, act, dec, ex, pfx, cnt


def _combine_blocks(outs, cap: int, bn: int, stop=None):
    """Per-block prefixes + counts -> global pack positions: a (n_blocks,)
    exclusive scan instead of a cap-wide cumsum.  Retired lanes, and lanes
    flagged ``stop`` (B7), aim at ``cap``, the buffers' trash slot."""
    g, act, dec, ex, pfx, cnt = outs
    off = torch.cumsum(cnt, dim=0, dtype=torch.int32) - cnt  # exclusive
    lane = torch.arange(cap, device=g.device)
    posg = pfx + off[lane // bn]
    keep = act.bool() if stop is None else act.bool() & ~stop
    pack = torch.where(keep, posg, cap)
    return g, act, dec, ex, pack, cnt.sum(dtype=torch.int32)


def mega_stage(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """One fused stage step over a survivor buffer -> ``(g, active i32,
    decided_pos i32, exit_rel i32, pack, n_keep)``: exits are relative
    1-based (the caller rebases by t0), and ``pack`` holds each survivor's
    front-packed destination, or ``cap`` for a retired lane."""
    outs = mega_stage_kernel(
        slabs, x, g0, stage, t0, n_valid, eps_pos, eps_neg, block_n=block_n
    )
    bn, _ = _block_geometry(g0.shape[0], block_n)
    return _combine_blocks(outs, g0.shape[0], bn)


# ---------------------------------------------------------------------------
# B7: the mixed-stage step (streaming admission)
# ---------------------------------------------------------------------------


def gather_lane_slabs(slabs: ParamSlabs, stage: torch.Tensor) -> dict:
    """Per-lane slab gather: each lane's own stage row of every stacked
    slab array -> (cap, W, ...) tensors ((cap,) stage starts and widths for
    the matrix variant).  ``stage`` is clamped into [0, S), as ``jnp.take``
    clamps.  The plain version of B7 reads through it; the kernel indexes
    the stacked slabs in place instead."""
    idx = torch.clamp(stage.long(), 0, slabs.S - 1)
    return {k: v[idx] for k, v in slabs.data.items()}


def lane_scores(variant: str, xr: torch.Tensor, lane: dict, W: int) -> torch.Tensor:
    """(cap, W) scores of each lane's W models from its gathered slab rows
    ``lane`` (``gather_lane_slabs`` keys) on its feature row ``xr[i]`` (the
    matrix variant: its score row, read at columns t0 + j, 0.0 past the
    stage's true width).  Trees are a leaf select, lattices contract
    dimension by dimension (``ensembles.lattice.interpolate``), so the
    scores equal the batch path's bit for bit."""
    if variant == "tree":
        feats, thrs = lane["feats"].long(), lane["thrs"]
        idx = torch.zeros(feats.shape[:2], dtype=torch.int64, device=xr.device)
        for k in range(feats.shape[2]):
            xk = torch.gather(xr, 1, feats[:, :, k])
            idx = 2 * idx + (xk > thrs[:, :, k]).long()
        return torch.gather(lane["payload"], 2, idx[:, :, None])[:, :, 0]
    if variant == "lattice":
        feats = lane["feats"].long()
        cap, w, dims = feats.shape
        xs = torch.gather(xr, 1, feats.reshape(cap, w * dims)).reshape(cap, w, dims)
        return interpolate(lane["payload"], xs)
    if variant == "matrix":
        j = torch.arange(W, device=xr.device)
        cols = torch.gather(xr, 1, lane["t0"].long()[:, None] + j)
        return torch.where(j < lane["widths"][:, None], cols, 0.0)
    raise ValueError(f"mega_lane: unknown variant {variant!r}")


def mega_lane_plain(
    slabs: ParamSlabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """Plain version of B7 (any device): the raw per-block outputs ``(g,
    active i32, decided_pos i32, exit_rel i32, pfx i32, cnt i32)`` of
    ``mega_stage_plain``, for lanes at their own stages.  ``pfx`` and
    ``cnt`` count the lanes that stay active and are not flagged ``stop``."""
    st = torch.clamp(stage.long(), 0, slabs.S - 1)
    xr = x[torch.clamp(rows.long(), 0, x.shape[0] - 1)]
    scores = lane_scores(slabs.variant, xr, gather_lane_slabs(slabs, st), slabs.W)
    ep, en = eps_pos[st], eps_neg[st]
    return _walk_and_pack(
        g0, n_valid, W=slabs.W, block_n=block_n, score_j=lambda j: scores[:, j],
        ep_j=lambda j: ep[:, j], en_j=lambda j: en[:, j], stop=stop.bool(),
    )


def mega_lane_kernel(
    slabs: ParamSlabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """B7, same contract as ``mega_lane_plain``: a CPU tensor goes to the
    plain version, a CUDA tensor to ``csrc/mega_stage.cu``.

    ``x`` is the whole prepared operand, (n_rows, d) feature rows for the
    tree and lattice variants or the (n_rows, T_pad) score matrix for the
    matrix variant; ``rows`` (cap,) int64 the row each lane reads (clamped
    into range); ``g0`` (cap,) the lanes' partial sums; ``stage`` (cap,)
    int32 each lane's stage (clamped into [0, S)); ``stop`` (cap,) bool the
    lanes running their last stage; ``n_valid`` (an int or an int32 scalar
    tensor on the device) the live count; ``eps_pos``/``eps_neg`` the full
    (S, W) threshold tables.
    """
    if g0.device.type == "cpu":
        return mega_lane_plain(
            slabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
            block_n=block_n,
        )
    if g0.device.type != "cuda":
        raise ValueError(f"mega_lane: unsupported device {g0.device}")
    check_quant(slabs.quant)
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("g0", g0, f32), ("x", x, f32), ("rows", rows, torch.int64),
        ("stage", stage, i32), ("stop", stop, torch.bool),
        ("eps_pos", eps_pos, f32), ("eps_neg", eps_neg, f32),
    ]
    if slabs.variant == "tree":
        p0, p1, p2 = (slabs.data[k] for k in ("feats", "thrs", "payload"))
        checks += [("feats", p0, i32), ("thrs", p1, f32), ("leaves", p2, f32)]
        aux = p0.shape[2]
    elif slabs.variant == "matrix":
        p0, p1, p2 = slabs.data["t0"], slabs.data["widths"], None
        checks += [("t0", p0, i32), ("widths", p1, i32)]
        aux = 0
    elif slabs.variant == "lattice":
        p0, p1, p2 = slabs.data["feats"], slabs.data["payload"], None
        checks += [("feats", p0, i32), ("theta", p1, f32)]
        aux = p0.shape[2]
        if not 1 <= aux <= MAX_DIMS:
            raise ValueError(f"mega_lane: lattice S = {aux} not in [1, {MAX_DIMS}]")
    else:
        raise ValueError(f"mega_lane: unknown variant {slabs.variant!r}")
    _build.check_cuda("mega_lane", *checks)
    cap = g0.shape[0]
    S, W = slabs.S, slabs.W
    if (
        x.ndim != 2 or x.shape[0] < 1 or rows.shape != (cap,)
        or stage.shape != (cap,) or stop.shape != (cap,)
        or eps_pos.shape != (S, W) or eps_neg.shape != (S, W)
    ):
        raise ValueError(
            f"mega_lane: x {tuple(x.shape)}, rows {tuple(rows.shape)}, stage "
            f"{tuple(stage.shape)}, stop {tuple(stop.shape)}, eps "
            f"{tuple(eps_pos.shape)} do not fit cap {cap}, slabs (S={S}, W={W})"
        )
    bn, nb = _block_geometry(cap, block_n)
    if not 1 <= bn <= 1024:
        raise ValueError(f"mega_lane: block_n {bn} not in [1, 1024]")
    dev = g0.device
    g = torch.empty(cap, dtype=f32, device=dev)
    act, dec, ex, pfx = (torch.empty(cap, dtype=i32, device=dev) for _ in range(4))
    cnt = torch.empty(nb, dtype=i32, device=dev)
    if cap == 0:
        return g, act, dec, ex, pfx, cnt
    nv_ptr, nv_host = _build.n_valid_args(n_valid, cap, dev)
    fn = _build.function(
        "mega_stage", f"mega_lane_{slabs.variant}_launch", _LANE_ARGTYPES
    )
    err = fn(
        x.data_ptr(), rows.data_ptr(), x.shape[0], g0.data_ptr(),
        stage.data_ptr(), stop.data_ptr(), nv_ptr, nv_host, cap, x.shape[1], W,
        S, bn, aux, p0.data_ptr(), p1.data_ptr(), _build.ptr(p2),
        eps_pos.data_ptr(), eps_neg.data_ptr(),
        *(t.data_ptr() for t in (g, act, dec, ex, pfx, cnt)), _build.stream(dev),
    )
    _build.check("mega_stage", err, f"mega_lane[{slabs.variant}]")
    _build.LAUNCHES[f"mega_lane_{slabs.variant}"] += 1
    return g, act, dec, ex, pfx, cnt


def mega_lane(
    slabs: ParamSlabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """One fused mixed-stage step -> ``(g, active i32, decided_pos i32,
    exit_rel i32, pack, n_keep)``, the contract of ``mega_stage``: exits
    relative 1-based (the caller rebases by each lane's stage start), and
    ``pack`` is each surviving lane's front-packed destination, or ``cap``
    for a retired lane and for a lane flagged ``stop``."""
    outs = mega_lane_kernel(
        slabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
        block_n=block_n,
    )
    bn, _ = _block_geometry(g0.shape[0], block_n)
    return _combine_blocks(outs, g0.shape[0], bn, stop=stop)
