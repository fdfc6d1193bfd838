"""Kernels B4 and B7: the fused cascade stage step, over f32, bf16 or int8
parameter slabs.

The counterpart of ``repro.kernels.megakernel`` (tree, matrix and lattice
variants; B4 for the batch path, B7 for streaming admission).  One stage step of the device executor is otherwise
two passes over the survivor buffer: the score kernel (B3 or B5) writes a
(cap, W) score buffer and B2's step form reads it back, walks it and
packs the survivors.  ``csrc/mega_stage.cu`` fuses them into one
kernel per row block: select the stage's slab, score its W models, walk
``threshold_step`` W times, and emit the block-local compaction prefix and
the block's survivor count; ``combine_blocks`` turns those into pack
positions with a (n_blocks,) exclusive scan.  The lattice variant scores
with the arithmetic of ``csrc/lattice.cuh``, shared with B5, and its plain
version calls ``apply_lattice_scores``, so fused and unfused lattice
scores agree bit for bit.  The matrix variant's B4 reads the prepared
score matrix in place through ``rows=``, as B7 does, so the executor's
stage gathers no rows for it.

B7 (``mega_lane``) is the same step for a buffer whose lanes sit at
different stages: each lane scores the W models of its own stage with its
own threshold row, and lanes running their last stage (``stop``) are left
out of the compaction prefix.  The kernel reads each lane's stage row of
the stacked slabs in place; its plain version keeps the reference's form,
``gather_lane_slabs`` and then the per-lane math of ``lane_scores``, which
the scorers' ``lane_fn`` share.

**Quantised slabs.**  ``ParamSlabs`` holds the cascade-ordered,
stage-stacked parameters at ``f32``, ``bf16`` (round to nearest even) or
``int8`` (one f32 scale per stage, ``max|v| / 127``).  Only the additive
payload is quantised: tree leaves, lattice vertex values, and the matrix
operand (bf16 only; the executor casts the prepared operand once per run).
Feature ids and tree thresholds stay exact, since a quantised threshold
could flip a leaf choice.  Every kernel dequantises (bf16 widened, int8
times its stage's scale, one f32 multiply) and then runs the f32
arithmetic unchanged, so a quantised kernel equals its plain version bit
for bit.  Against f32 serving the error is bounded by the tolerance
oracle: ``eps_position`` is each cascade position's exact payload error
(f64), ``tolerance_bound`` sums it along a row's walk, and
``check_parity`` holds verdicts and exits equal and ``g_final`` within the
bound.  ``megakernel=None`` runs the fused step only for f32 slabs;
quantised slabs run when the caller asks for ``megakernel=True``.

Blocks past the live count write inert outputs and compute nothing, the
same block-guard billing as the multi-kernel path, so the fused and
unfused paths are identical in billing, and at f32 slabs in results.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.ensembles.lattice import apply_lattice_scores, interpolate
from repro_torch.kernels import _build
from repro_torch.kernels.cascade_kernel import combine_blocks, threshold_step
from repro_torch.kernels.lattice_kernel import MAX_DIMS

__all__ = [
    "PAYLOAD_DTYPES",
    "ParamSlabs",
    "QUANTS",
    "build_lattice_slabs",
    "build_matrix_slabs",
    "build_tree_slabs",
    "check_parity",
    "check_quant",
    "check_tree_depth",
    "dequant",
    "gather_lane_slabs",
    "lane_scores",
    "matrix_eps_position",
    "mega_lane",
    "mega_lane_kernel",
    "mega_lane_plain",
    "mega_stage",
    "mega_stage_kernel",
    "mega_stage_plain",
    "tolerance_bound",
]

QUANTS = ("f32", "bf16", "int8")
# numpy has no bf16: each storage dtype as a torch dtype
PAYLOAD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

F32_EPS = float(np.finfo(np.float32).eps)

_P, _I = ctypes.c_void_p, ctypes.c_int
# the B4 launchers take the payload's quant code (0 f32, 1 bf16, 2 int8) and
# the (S,) per-stage scales; the matrix launcher takes the operand's quant
_QUANT_CODE = {"f32": 0, "bf16": 1, "int8": 2}
# the deepest tree each kernel takes (csrc/mega_stage.cu kMaxStagedDepth,
# kMaxLaneDepth): B4 stages a chunk's dequantised leaf tables in shared
# memory, and one 2^15-leaf table (128 KB) is the largest a CTA can hold;
# B7 reads leaves in place through an int leaf index
MAX_TREE_DEPTH = {"mega_stage": 15, "mega_lane": 30}
_TREE_ARGTYPES = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I] + [_P] * 13
_MATRIX_ARGTYPES = [_P, _P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I] + [_P] * 10
_LATTICE_ARGTYPES = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I] + [_P] * 12
_LANE_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P] + [_I] * 8 + [_P] * 13


def check_quant(quant: str) -> None:
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")


def check_tree_depth(name: str, depth: int) -> None:
    """Raise unless kernel ``name`` (``mega_stage`` or ``mega_lane``) takes
    trees of ``depth``: 0 to ``MAX_TREE_DEPTH[name]``.  The plain versions
    take any depth."""
    limit = MAX_TREE_DEPTH[name]
    if not 0 <= depth <= limit:
        raise ValueError(f"{name}: tree depth {depth} not in [0, {limit}]")


@dataclasses.dataclass(frozen=True)
class ParamSlabs:
    """Cascade-ordered, stage-stacked, possibly quantised parameter slabs on
    one device.

    ``data`` maps slab names to (S, W, ...) tensors, one uniform-width slab
    per stage, zero-padded on the model axis (padded trees and lattices
    score exactly 0.0, which the ±inf threshold padding keeps inert);
    ``data["payload"]`` is stored at the ``quant`` dtype.  For the matrix
    variant the payload is the prepared operand itself, and ``data`` holds
    only the (S,) stage starts and true widths the kernels mask with.
    ``scale`` is the (S, 1) f32 per-stage dequantisation scale (ones unless
    ``quant == "int8"``); ``eps_position`` the (T,) f64 exact payload error
    of each cascade position, the tolerance oracle's input; ``x_dtype`` the
    dtype the executor casts the prepared operand to (matrix bf16 only,
    else None).
    """

    variant: str  # "matrix" | "tree" | "lattice"
    quant: str  # "f32" | "bf16" | "int8"
    data: dict
    scale: torch.Tensor  # (S, 1) float32
    eps_position: np.ndarray  # (T,) float64
    W: int
    S: int
    x_dtype: torch.dtype | None = None


def _bf16_round(v32: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), back as f32."""
    return torch.from_numpy(np.ascontiguousarray(v32)).to(torch.bfloat16).float().numpy()


def _quantize_slab(vals, quant: str):
    """One stage's (w, ...) payload -> (stored values, scale, per-model
    max-abs error).  The stored values are a numpy array: f32, or f32 on
    the bf16 grid (exact when cast to bf16), or int8.  The error is exact:
    an f64 round trip through the storage grid."""
    v64 = np.asarray(vals, np.float64)
    v32 = v64.astype(np.float32)
    if quant == "f32":
        q, scale, deq = v32, 1.0, v32.astype(np.float64)
    elif quant == "bf16":
        q, scale = _bf16_round(v32), 1.0
        deq = q.astype(np.float64)
    elif quant == "int8":
        m = float(np.max(np.abs(v32))) if v32.size else 0.0
        scale = m / 127.0 if m > 0.0 else 1.0
        # v32 / scale is an f32 division (NumPy 2 keeps the array's dtype
        # against a Python float), as in the reference
        q = np.clip(np.round(v32 / scale), -127, 127).astype(np.int8)
        deq = q.astype(np.float64) * scale
    else:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    err = np.abs(v64 - deq)
    eps = err.reshape(v64.shape[0], -1).max(axis=1) if v64.size else np.zeros(v64.shape[0])
    return q, scale, eps


def _stack_stages(dplan, arr: np.ndarray, dtype) -> np.ndarray:
    """(T, ...) cascade-ordered array -> (S, W, ...) per-stage stack,
    zero-padded past each stage's true width."""
    out = np.zeros((dplan.S, dplan.W) + arr.shape[1:], dtype=dtype)
    for s, (t0, t1) in enumerate(dplan.plan.stages):
        out[s, : t1 - t0] = arr[t0:t1]
    return out


def _stack_payload(dplan, payload, quant: str, device):
    """Quantise each stage's payload with its own scale and stack it ->
    ((S, W, ...) tensor at the quant dtype, (S, 1) f32 scales, (T,) f64
    per-position errors)."""
    check_quant(quant)
    payload = np.asarray(payload)
    stacked = np.zeros((dplan.S, dplan.W) + payload.shape[1:],
                       dtype=np.int8 if quant == "int8" else np.float32)
    scales = np.ones(dplan.S, np.float32)
    eps_position = np.zeros(dplan.plan.T, np.float64)
    for s, (t0, t1) in enumerate(dplan.plan.stages):
        q, scales[s], eps_position[t0:t1] = _quantize_slab(payload[t0:t1], quant)
        stacked[s, : t1 - t0] = q
    data = torch.from_numpy(stacked).to(PAYLOAD_DTYPES[quant]).to(device)
    return data, torch.from_numpy(scales.reshape(-1, 1)).to(device), eps_position


def build_matrix_slabs(dplan, quant: str = "f32", device="cuda") -> ParamSlabs:
    """Matrix-variant slabs: the payload is the prepared (n, T_pad) score
    matrix, so the record carries only the stages' first cascade positions
    and true widths (column t0 + j of a narrow stage is the NEXT stage's
    real score; the kernels mask with the width), and the dtype the
    executor casts the operand to.  int8 is refused: the payload exists
    only at prepare time, after per-stage scales would have to be frozen."""
    check_quant(quant)
    if quant == "int8":
        raise ValueError(
            "matrix slabs support f32/bf16 only: the payload is the "
            "prepared score matrix, built after per-slab int8 scales "
            "would need to be frozen"
        )
    data = {
        "t0": np.asarray(dplan.stage_t0, dtype=np.int32),
        "widths": np.asarray(dplan.widths, dtype=np.int32),
    }
    return ParamSlabs(
        variant="matrix", quant=quant,
        data={k: torch.from_numpy(v).to(device) for k, v in data.items()},
        scale=torch.ones(dplan.S, 1, dtype=torch.float32, device=device),
        # operand-dependent: matrix_eps_position derives it from the operand
        eps_position=np.zeros(dplan.plan.T, np.float64),
        W=dplan.W, S=dplan.S,
        x_dtype=torch.bfloat16 if quant == "bf16" else None,
    )


def build_tree_slabs(
    dplan, feats_ordered, thrs_ordered, leaves_ordered, quant: str = "f32",
    device="cuda",
) -> ParamSlabs:
    """Oblivious-tree slabs: feature ids, thresholds and leaf tables of the
    cascade-ordered forest, stacked per stage.  The leaves are the
    quantised payload; feature ids and thresholds stay exact."""
    payload, scale, eps_position = _stack_payload(dplan, leaves_ordered, quant, device)
    data = {
        "feats": _stack_stages(dplan, np.asarray(feats_ordered), np.int32),
        "thrs": _stack_stages(dplan, np.asarray(thrs_ordered), np.float32),
    }
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return ParamSlabs(
        variant="tree", quant=quant, data={**data, "payload": payload},
        scale=scale, eps_position=eps_position, W=dplan.W, S=dplan.S,
    )


def build_lattice_slabs(
    dplan, theta_ordered, feats_ordered, quant: str = "f32", device="cuda"
) -> ParamSlabs:
    """Lattice slabs: the vertex values (the quantised payload) and feature
    ids of the cascade-ordered ensemble, stacked per stage.  The vertex
    weights of an input in the unit cube are a convex combination, so a
    lattice's score error is at most its vertex values' (``eps_position``)."""
    payload, scale, eps_position = _stack_payload(dplan, theta_ordered, quant, device)
    feats = _stack_stages(dplan, np.asarray(feats_ordered), np.int32)
    return ParamSlabs(
        variant="lattice", quant=quant,
        data={"feats": torch.from_numpy(feats).to(device), "payload": payload},
        scale=scale, eps_position=eps_position, W=dplan.W, S=dplan.S,
    )


def matrix_eps_position(ordered, quant: str) -> np.ndarray:
    """(T,) per-position payload error of the matrix variant, from the
    cascade-ordered score matrix the executor casts to the storage dtype."""
    v64 = np.asarray(ordered, np.float64)
    v32 = v64.astype(np.float32)
    if quant == "f32":
        deq = v32.astype(np.float64)
    elif quant == "bf16":
        deq = _bf16_round(v32).astype(np.float64)
    else:
        raise ValueError(f"matrix slabs support f32/bf16 only, got {quant!r}")
    return np.abs(v64 - deq).max(axis=0)


def tolerance_bound(eps_position, exit_step, g_scale: float = 1.0) -> np.ndarray:
    """Per-row bound on |g_quantised - g_oracle| after each row's walk:
    the payload error summed over the row's ``exit_step`` positions
    (1-based; never-exited rows report T), plus one f32 ulp of ``g_scale``
    (a magnitude of the partial sums) per position for the accumulation.
    Zero up to the ulp term for f32 slabs and for payloads on the grid."""
    eps = np.asarray(eps_position, np.float64)
    steps = np.clip(np.asarray(exit_step, np.int64), 0, eps.shape[0])
    cum = np.concatenate([[0.0], np.cumsum(eps)])
    return cum[steps] + steps * F32_EPS * float(g_scale)


def check_parity(oracle, result, eps_position, g_scale: float = 1.0) -> dict:
    """The quantised-slab contract against an oracle run: ``decisions`` and
    ``exit_step`` equal, ``g_final`` within ``tolerance_bound``.  Both
    arguments are results with those three fields (``ExecutorResult``,
    ``StreamResult``).  Raises AssertionError naming the first rows that
    break it; returns a small report."""
    dec_a = np.asarray(oracle.decisions).astype(bool)
    dec_b = np.asarray(result.decisions).astype(bool)
    ex_a = np.asarray(oracle.exit_step, np.int64)
    ex_b = np.asarray(result.exit_step, np.int64)
    if dec_a.shape != dec_b.shape:
        raise AssertionError(f"result shape mismatch: {dec_a.shape} vs {dec_b.shape}")
    if not np.array_equal(ex_a, ex_b):
        rows = np.flatnonzero(ex_a != ex_b)[:8]
        raise AssertionError(
            f"exit_step mismatch on {rows.size}+ rows (first {rows.tolist()}): "
            "the quantization error crossed a threshold margin — this "
            "fixture cannot be certified by the tolerance oracle"
        )
    if not np.array_equal(dec_a, dec_b):
        rows = np.flatnonzero(dec_a != dec_b)[:8]
        raise AssertionError(f"decision mismatch on rows {rows.tolist()}")
    g_a = np.asarray(oracle.g_final, np.float64)
    g_b = np.asarray(result.g_final, np.float64)
    bound = tolerance_bound(eps_position, ex_a, g_scale)
    err = np.abs(g_a - g_b)
    bad = err > bound
    if bad.any():
        rows = np.flatnonzero(bad)[:8]
        raise AssertionError(
            f"g_final outside tolerance on rows {rows.tolist()}: "
            f"err {err[rows].tolist()} > bound {bound[rows].tolist()}"
        )
    return {
        "rows": int(err.size),
        "max_err": float(err.max(initial=0.0)),
        "max_bound": float(bound.max(initial=0.0)),
        "exact": bool((err == 0.0).all()),
    }


def dequant(q: torch.Tensor, scale) -> torch.Tensor:
    """A stored payload as f32: bf16 widened (exact), int8 times its scale
    (one f32 multiply, what the kernels do), f32 as it is."""
    if q.dtype == torch.int8:
        return q.float() * scale
    return q.float()


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


def _check_rows(slabs: ParamSlabs, rows) -> None:
    if rows is not None and slabs.variant != "matrix":
        raise ValueError(
            f"mega_stage: rows= reads the matrix variant's operand in place; "
            f"the {slabs.variant} variant takes its rows gathered"
        )


def mega_stage_plain(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int, rows=None,
):
    """Plain version of B4 (any device): the raw per-block outputs
    ``(g, active i32, decided_pos i32, exit_rel i32, pfx i32, cnt i32)``,
    the first five (cap,), ``cnt`` (n_blocks,).  A quantised payload is
    dequantised first (``dequant``); the rest is the f32 arithmetic.  With
    ``rows`` (matrix variant only) lane i reads row ``rows[i]`` of ``x``,
    clamped into range, as B7 does."""
    _check_rows(slabs, rows)
    if rows is not None:
        x = x[torch.clamp(rows.long(), 0, x.shape[0] - 1)]
    cap = g0.shape[0]
    dev = g0.device
    if slabs.variant == "tree":
        feats, thrs = slabs.data["feats"][stage], slabs.data["thrs"][stage]
        leaves = dequant(slabs.data["payload"][stage], slabs.scale[stage])

        def score_j(j):
            idx = torch.zeros(cap, dtype=torch.int64, device=dev)
            for k in range(feats.shape[1]):
                idx = 2 * idx + (x[:, feats[j, k]] > thrs[j, k]).long()
            return leaves[j][idx]
    elif slabs.variant == "matrix":
        width = slabs.data["widths"][stage]

        def score_j(j):
            return torch.where(j < width, x[:, t0 + j].float(), 0.0)
    elif slabs.variant == "lattice":
        theta = dequant(slabs.data["payload"][stage], slabs.scale[stage])
        scores = apply_lattice_scores({"feats": slabs.data["feats"][stage], "theta": theta}, x)

        def score_j(j):
            return scores[:, j]
    else:
        raise ValueError(f"mega_stage: unknown variant {slabs.variant!r}")
    return _walk_and_pack(
        g0, n_valid, W=slabs.W, block_n=block_n, score_j=score_j,
        ep_j=lambda j: eps_pos[stage, j], en_j=lambda j: eps_neg[stage, j],
    )


def _slab_checks(slabs: ParamSlabs, name: str) -> list:
    """(label, tensor, dtype) of every slab array the kernels read: the
    payload at its storage dtype, ids and thresholds exact, the (S, 1) f32
    scales."""
    i32, f32 = torch.int32, torch.float32
    if slabs.scale.shape != (slabs.S, 1):
        raise ValueError(f"{name}: scale has shape {tuple(slabs.scale.shape)}, expected ({slabs.S}, 1)")
    d, pay = slabs.data, PAYLOAD_DTYPES[slabs.quant]
    if slabs.variant == "tree":
        checks = [("feats", d["feats"], i32), ("thrs", d["thrs"], f32), ("leaves", d["payload"], pay)]
    elif slabs.variant == "lattice":
        checks = [("feats", d["feats"], i32), ("theta", d["payload"], pay)]
    elif slabs.variant == "matrix":
        checks = [("t0", d["t0"], i32), ("widths", d["widths"], i32)]
    else:
        raise ValueError(f"{name}: unknown variant {slabs.variant!r}")
    return checks + [("scale", slabs.scale, f32)]


def _launch_key(name: str, slabs: ParamSlabs) -> str:
    """The launch-count key: ``mega_stage_tree``, ``mega_lane_lattice_int8``."""
    key = f"{name}_{slabs.variant}"
    return key if slabs.quant == "f32" else f"{key}_{slabs.quant}"


def mega_stage_kernel(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int, rows=None,
):
    """B4, same contract as ``mega_stage_plain``: a CPU tensor goes to the
    plain version, a CUDA tensor to ``csrc/mega_stage.cu``.

    ``x`` is the gathered operand for the buffer's rows: (cap, d) f32
    feature rows for the tree and lattice variants, the (cap, T_pad)
    prepared score matrix for the matrix variant (at ``slabs.x_dtype``,
    bf16 for matrix bf16 slabs).  With ``rows`` ((cap,) int64, matrix
    variant only) ``x`` is the whole (n_rows, T_pad) operand instead, and
    lane i reads row ``rows[i]`` (clamped into range) in place.
    ``stage``/``t0`` are the stage index and its first cascade position;
    ``n_valid`` (an int or an int32 scalar tensor on the device) the live
    count; ``eps_pos``/``eps_neg`` the full (S, W) threshold tables, from
    which the kernel selects the stage's row.
    """
    if g0.device.type == "cpu":
        return mega_stage_plain(
            slabs, x, g0, stage, t0, n_valid, eps_pos, eps_neg, block_n=block_n,
            rows=rows,
        )
    if g0.device.type != "cuda":
        raise ValueError(f"mega_stage: unsupported device {g0.device}")
    _check_rows(slabs, rows)
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("g0", g0, f32), ("x", x, slabs.x_dtype or f32), ("eps_pos", eps_pos, f32),
        ("eps_neg", eps_neg, f32),
    ] + _slab_checks(slabs, "mega_stage")
    if rows is not None:
        checks.append(("rows", rows, torch.int64))
    _build.check_cuda("mega_stage", *checks)
    cap = g0.shape[0]
    S, W = slabs.S, slabs.W
    n_rows = cap if rows is None else x.shape[0]
    if (
        x.ndim != 2 or x.shape[0] != n_rows or n_rows < 1
        or (rows is not None and rows.shape != (cap,))
        or eps_pos.shape != (S, W) or eps_neg.shape != (S, W)
    ):
        raise ValueError(
            f"mega_stage: x {tuple(x.shape)}, rows "
            f"{None if rows is None else tuple(rows.shape)}, eps {tuple(eps_pos.shape)} "
            f"do not fit cap {cap}, slabs (S={S}, W={W})"
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
    quant = _QUANT_CODE[slabs.quant]
    if slabs.variant == "tree":
        feats = slabs.data["feats"]
        depth = feats.shape[2]
        check_tree_depth("mega_stage", depth)
        fn = _build.function("mega_stage", "mega_stage_tree_launch", _TREE_ARGTYPES)
        err = fn(
            x.data_ptr(), g0.data_ptr(), int(stage), nv_ptr, nv_host, cap,
            x.shape[1], W, depth, bn, quant, feats.data_ptr(),
            slabs.data["thrs"].data_ptr(), slabs.data["payload"].data_ptr(),
            slabs.scale.data_ptr(), eps_pos.data_ptr(), eps_neg.data_ptr(), *outs,
            _build.stream(dev),
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
            x.shape[1], W, dims, bn, quant, feats.data_ptr(),
            slabs.data["payload"].data_ptr(), slabs.scale.data_ptr(),
            eps_pos.data_ptr(), eps_neg.data_ptr(), *outs, _build.stream(dev),
        )
    else:
        if not 0 <= t0 <= x.shape[1] - W:
            raise ValueError(f"mega_stage: columns [{t0}, {t0 + W}) outside x")
        fn = _build.function(
            "mega_stage", "mega_stage_matrix_launch", _MATRIX_ARGTYPES
        )
        err = fn(
            x.data_ptr(), _build.ptr(rows), n_rows, g0.data_ptr(), int(stage),
            int(t0), nv_ptr, nv_host, cap, x.shape[1], W, bn, quant,
            slabs.data["widths"].data_ptr(), eps_pos.data_ptr(), eps_neg.data_ptr(),
            *outs, _build.stream(dev),
        )
    key = _launch_key("mega_stage", slabs)
    _build.check("mega_stage", err, key)
    _build.LAUNCHES[key] += 1
    return g, act, dec, ex, pfx, cnt


def mega_stage(
    slabs: ParamSlabs, x, g0, stage: int, t0: int, n_valid, eps_pos, eps_neg,
    *, block_n: int, rows=None,
):
    """One fused stage step over a survivor buffer -> ``(g, active i32,
    decided_pos i32, exit_rel i32, pack, n_keep)``: exits are relative
    1-based (the caller rebases by t0), and ``pack`` holds each survivor's
    front-packed destination, or ``cap`` for a retired lane.  ``x`` and
    ``rows`` as for ``mega_stage_kernel``."""
    outs = mega_stage_kernel(
        slabs, x, g0, stage, t0, n_valid, eps_pos, eps_neg, block_n=block_n,
        rows=rows,
    )
    bn, _ = _block_geometry(g0.shape[0], block_n)
    return combine_blocks(outs, g0.shape[0], bn)


# ---------------------------------------------------------------------------
# B7: the mixed-stage step (streaming admission)
# ---------------------------------------------------------------------------


def gather_lane_slabs(slabs: ParamSlabs, stage: torch.Tensor) -> dict:
    """Per-lane slab gather: each lane's own stage row of every stacked
    slab array -> (cap, W, ...) tensors ((cap,) stage starts and widths for
    the matrix variant), at the storage dtype, plus the lanes' (cap, 1)
    ``scale``.  ``stage`` is clamped into [0, S), as ``jnp.take`` clamps.
    The plain version of B7 reads through it; the kernel indexes the
    stacked slabs in place instead."""
    idx = torch.clamp(stage.long(), 0, slabs.S - 1)
    out = {k: v[idx] for k, v in slabs.data.items()}
    out["scale"] = slabs.scale[idx]
    return out


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
        cols = torch.gather(xr, 1, lane["t0"].long()[:, None] + j).float()
        return torch.where(j < lane["widths"][:, None], cols, 0.0)
    raise ValueError(f"mega_lane: unknown variant {variant!r}")


def mega_lane_plain(
    slabs: ParamSlabs, x, rows, g0, stage, stop, n_valid, eps_pos, eps_neg,
    *, block_n: int,
):
    """Plain version of B7 (any device): the raw per-block outputs ``(g,
    active i32, decided_pos i32, exit_rel i32, pfx i32, cnt i32)`` of
    ``mega_stage_plain``, for lanes at their own stages.  ``pfx`` and
    ``cnt`` count the lanes that stay active and are not flagged ``stop``.
    Each lane's payload is dequantised with its own stage's scale."""
    st = torch.clamp(stage.long(), 0, slabs.S - 1)
    xr = x[torch.clamp(rows.long(), 0, x.shape[0] - 1)]
    lane = gather_lane_slabs(slabs, st)
    if "payload" in lane:
        lane["payload"] = dequant(lane["payload"], lane["scale"][:, :, None])
    scores = lane_scores(slabs.variant, xr, lane, slabs.W)
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

    ``x`` is the whole prepared operand, (n_rows, d) f32 feature rows for
    the tree and lattice variants or the (n_rows, T_pad) score matrix (at
    ``slabs.x_dtype``) for the matrix variant; ``rows`` (cap,) int64 the row each lane reads (clamped
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
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("g0", g0, f32), ("x", x, slabs.x_dtype or f32), ("rows", rows, torch.int64),
        ("stage", stage, i32), ("stop", stop, torch.bool),
        ("eps_pos", eps_pos, f32), ("eps_neg", eps_neg, f32),
    ] + _slab_checks(slabs, "mega_lane")
    if slabs.variant == "tree":
        p0, p1, p2 = (slabs.data[k] for k in ("feats", "thrs", "payload"))
        aux = p0.shape[2]
        check_tree_depth("mega_lane", aux)
    elif slabs.variant == "matrix":
        p0, p1, p2 = slabs.data["t0"], slabs.data["widths"], None
        aux = 0
    else:
        p0, p1, p2 = slabs.data["feats"], slabs.data["payload"], None
        aux = p0.shape[2]
        if not 1 <= aux <= MAX_DIMS:
            raise ValueError(f"mega_lane: lattice S = {aux} not in [1, {MAX_DIMS}]")
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
        S, bn, aux, _QUANT_CODE[slabs.quant], p0.data_ptr(), p1.data_ptr(),
        _build.ptr(p2), slabs.scale.data_ptr(), eps_pos.data_ptr(), eps_neg.data_ptr(),
        *(t.data_ptr() for t in (g, act, dec, ex, pfx, cnt)), _build.stream(dev),
    )
    key = _launch_key("mega_lane", slabs)
    _build.check("mega_stage", err, key)
    _build.LAUNCHES[key] += 1
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
    return combine_blocks(outs, g0.shape[0], bn, stop=stop)
