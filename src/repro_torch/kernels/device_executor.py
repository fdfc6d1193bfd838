"""On-device cascade executor: the whole stage loop with no host sync.

The counterpart of ``repro.kernels.device_executor`` (batch path).  The
reference runs the ``CascadePlan`` as one jit'd ``lax.while_loop`` that
stops when no row is active.  Here the stage loop is a Python loop that
only enqueues work on the card:

* **Fixed-capacity survivor buffers.**  The active row ids live in a
  (cap,) buffer (``cap`` = batch padded to ``block_n``), survivors packed
  at the front; the live count ``n_active`` is an int32 tensor on the
  device that the kernels read as ``n_valid``.  Nothing in the loop reads a
  value back to the host.
* **One trash slot.**  PyTorch neither clamps an out-of-range gather nor
  drops an out-of-range scatter, so every buffer indexed by a row id (the
  operand ``x``, ``g``, the decisions, the exit steps) has ``cap + 1``
  entries: index ``cap`` is the trash slot that retired lanes read from and
  write to, and it is sliced off at the end.
* **How the loop ends.**  Every one of the plan's S stages is enqueued.
  Once ``n_active`` reaches 0, every kernel of a later stage retires all its
  row blocks at once (blocks at or past ``n_valid``), and the gathers and
  scatters of the stage touch only the trash slot, so a stage past the
  quit costs its launches and no work.  The number of stages that ran
  (``n_in_log > 0``) and the billing are recovered after the loop, with the
  one transfer to the host.  A CUDA graph of the loop is later work.
* **Megakernel.**  With f32 ``ParamSlabs`` the stage is one fused kernel
  (B4, ``megakernel.py``); otherwise (or with ``megakernel=False``) it is
  the scorer's kernel (B3 for trees, B5 for lattices) -> column mask ->
  chunk decide (B2) -> cumsum pack.
  The two are bit-identical in results and in billing.

Stages are uniformized to the plan's maximum width ``W``: padded columns
carry ±inf thresholds and zeroed scores, so they never move a partial sum
or trigger an exit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan, ChunkStat, ExecutorResult
from repro_torch.device import resolve_device
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.cascade_kernel import cascade_chunk_kernel
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.tree_kernel import gbt_scores_kernel

__all__ = [
    "DEFAULT_BLOCK_N",
    "BoundScorer",
    "DeviceExecutor",
    "DevicePlan",
    "lattice_stage_scorer",
    "matrix_stage_scorer",
    "tree_stage_scorer",
]

DEFAULT_BLOCK_N = 64


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """A ``CascadePlan`` lowered to static-shape stage arrays (host numpy;
    the executor uploads them).

    All stages are padded to the maximum stage width ``W``; padded columns
    get ±inf thresholds and a False ``col_valid``.  The thresholds are f64
    in the plan and f32 here, the dtype every decide runs at.
    """

    plan: CascadePlan
    stage_t0: np.ndarray  # (S,) int32 — first cascade position per stage
    widths: np.ndarray  # (S,) int32 — true (unpadded) stage widths
    eps_pos: np.ndarray  # (S, W) float32, +inf on padded columns
    eps_neg: np.ndarray  # (S, W) float32, -inf on padded columns
    col_valid: np.ndarray  # (S, W) bool
    W: int  # uniform stage width
    T_pad: int  # model-axis pad target: every [t0, t0 + W) slab is in range
    quant: str = "f32"

    @property
    def S(self) -> int:
        return int(self.stage_t0.shape[0])

    @classmethod
    def from_plan(cls, plan: CascadePlan, quant: str = "f32") -> "DevicePlan":
        mk.check_quant(quant)
        stages = plan.stages
        S = len(stages)
        W = max(t1 - t0 for t0, t1 in stages)
        stage_t0 = np.array([t0 for t0, _ in stages], dtype=np.int32)
        widths = np.array([t1 - t0 for t0, t1 in stages], dtype=np.int32)
        eps_pos = np.full((S, W), np.inf, dtype=np.float32)
        eps_neg = np.full((S, W), -np.inf, dtype=np.float32)
        col_valid = np.zeros((S, W), dtype=bool)
        for s, (t0, t1) in enumerate(stages):
            w = t1 - t0
            eps_pos[s, :w] = plan.eps_pos[t0:t1].astype(np.float32)
            eps_neg[s, :w] = plan.eps_neg[t0:t1].astype(np.float32)
            col_valid[s, :w] = True
        return cls(
            plan=plan,
            stage_t0=stage_t0,
            widths=widths,
            eps_pos=eps_pos,
            eps_neg=eps_neg,
            col_valid=col_valid,
            W=W,
            T_pad=int(stage_t0.max()) + W,
            quant=quant,
        )


@dataclasses.dataclass(frozen=True)
class BoundScorer:
    """A stage scorer bound to a ``DevicePlan`` and a device.

    ``fn(x, rows, t0, n_valid) -> (cap, W)``: scores of cascade positions
    [t0, t0 + W) for the (front-packed) row buffer ``rows`` of the prepared
    operand ``x``; ``n_valid`` is the live count (an int32 tensor on the
    device), which a blocked kernel may use to skip row blocks past it.
    ``prepare(batch) -> x``: the batch as the operand ``fn`` reads, on the
    device.  ``block_n``: the scorer's own kernel row-block size, the
    granularity its block guard computes at, which billing uses (None = an
    exact producer, billed at the executor's block).  ``slabs``: the
    params as stage-stacked ``ParamSlabs``, the ticket into the fused
    stage step.
    """

    fn: Callable
    prepare: Callable
    width: int
    block_n: int | None = None
    slabs: mk.ParamSlabs | None = None


def matrix_stage_scorer(
    dplan: DevicePlan, quant: str | None = None, device="cuda"
) -> BoundScorer:
    """Scorer over a precomputed cascade-ORDERED (n, T) matrix (the eager
    ``score_fn`` path and the tests' oracle path)."""
    dev = resolve_device(device)
    W, T, T_pad = dplan.W, dplan.plan.T, dplan.T_pad
    slabs = mk.build_matrix_slabs(dplan, quant=quant or dplan.quant, device=dev)

    def prepare(ordered) -> torch.Tensor:
        F = torch.as_tensor(np.asarray(ordered, dtype=np.float32)).to(dev)
        if F.ndim != 2 or F.shape[1] != T:
            raise ValueError(f"expected an (n, {T}) ordered score matrix, got {tuple(F.shape)}")
        return torch.nn.functional.pad(F, (0, T_pad - T))

    def fn(x, rows, t0: int, n_valid) -> torch.Tensor:
        return x[rows, t0 : t0 + W]

    return BoundScorer(fn=fn, prepare=prepare, width=W, slabs=slabs)


def tree_stage_scorer(
    dplan: DevicePlan,
    feats_ordered,
    thrs_ordered,
    leaves_ordered,
    block_n: int = DEFAULT_BLOCK_N,
    quant: str | None = None,
    device="cuda",
) -> BoundScorer:
    """Oblivious-forest scorer: per stage, the (W, ...) slice of the
    cascade-ordered, zero-padded tree params goes to the tree kernel (B3)
    with the survivor rows and the live count."""
    dev = resolve_device(device)
    W, T_pad = dplan.W, dplan.T_pad
    feats_o = np.asarray(feats_ordered, dtype=np.int32)
    T = feats_o.shape[0]
    slabs = mk.build_tree_slabs(
        dplan, feats_o, thrs_ordered, leaves_ordered,
        quant=quant or dplan.quant, device=dev,
    )

    def padded(a, dtype):
        a = np.asarray(a, dtype=dtype)
        return torch.from_numpy(np.pad(a, ((0, T_pad - T), (0, 0)))).to(dev)

    feats_p = padded(feats_o, np.int32)
    thrs_p = padded(thrs_ordered, np.float32)
    leaves_p = padded(leaves_ordered, np.float32)

    def prepare(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dev)

    def fn(x, rows, t0: int, n_valid) -> torch.Tensor:
        return gbt_scores_kernel(
            feats_p, thrs_p, leaves_p, x, block_n=block_n, t0=t0, t1=t0 + W,
            rows=rows, n_valid=n_valid,
        )

    return BoundScorer(fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs)


def lattice_stage_scorer(
    dplan: DevicePlan,
    theta_ordered,
    feats_ordered,
    block_n: int = DEFAULT_BLOCK_N,
    quant: str | None = None,
    device="cuda",
) -> BoundScorer:
    """Lattice scorer: the slab scheme of ``tree_stage_scorer`` over the
    cascade-ordered (theta, feats) stacks, scoring with B5."""
    dev = resolve_device(device)
    W, T_pad = dplan.W, dplan.T_pad
    theta_o = np.asarray(theta_ordered, dtype=np.float32)
    feats_o = np.asarray(feats_ordered, dtype=np.int32)
    T = feats_o.shape[0]
    slabs = mk.build_lattice_slabs(
        dplan, theta_o, feats_o, quant=quant or dplan.quant, device=dev
    )
    theta_p = torch.from_numpy(np.pad(theta_o, ((0, T_pad - T), (0, 0)))).to(dev)
    feats_p = torch.from_numpy(np.pad(feats_o, ((0, T_pad - T), (0, 0)))).to(dev)
    n_feats = int(feats_o.max()) + 1 if feats_o.size else 0

    def prepare(x) -> torch.Tensor:
        x = np.asarray(x, dtype=np.float32)
        # the kernels read x[:, feats] unchecked
        if x.ndim != 2 or x.shape[1] < n_feats:
            raise ValueError(
                f"expected (n, >= {n_feats}) feature rows for the lattices, got {x.shape}"
            )
        return torch.as_tensor(x).to(dev)

    def fn(x, rows, t0: int, n_valid) -> torch.Tensor:
        return lattice_scores_kernel(
            theta_p, feats_p, x, block_n=block_n, t0=t0, t1=t0 + W, rows=rows,
            n_valid=n_valid,
        )

    return BoundScorer(fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs)


class DeviceExecutor:
    """Runs a ``CascadePlan`` on one device with no host sync in the stage
    loop (see the module docstring).

    Billing: a stage that ran computes ``ceil(n_in / bn) * bn`` rows of its
    W-wide slab, ``bn`` being the scorer's kernel block (its block guard
    skips row blocks past the live count), the same accounting as the
    reference.  ``megakernel`` selects the fused stage step: ``None``
    (default) turns it on when the scorer carries f32 ``ParamSlabs``;
    ``False`` forces the multi-kernel path.  ``device`` defaults to the
    card; on ``"cpu"`` every kernel wrapper takes its plain version.
    """

    def __init__(
        self,
        plan: CascadePlan | DevicePlan,
        scorer: BoundScorer,
        block_n: int = DEFAULT_BLOCK_N,
        megakernel: bool | None = None,
        device="cuda",
    ):
        self.dplan = plan if isinstance(plan, DevicePlan) else DevicePlan.from_plan(plan)
        if scorer.width != self.dplan.W:
            raise ValueError(
                f"scorer width {scorer.width} != plan stage width {self.dplan.W}"
            )
        if megakernel is None:
            megakernel = scorer.slabs is not None and scorer.slabs.quant == "f32"
        if megakernel and scorer.slabs is None:
            raise ValueError("megakernel=True needs a scorer with ParamSlabs")
        self.megakernel = bool(megakernel)
        self.scorer = scorer
        self.block_n = max(1, int(block_n))
        self.device = resolve_device(device)
        dp, dev = self.dplan, self.device
        self._eps_pos = torch.from_numpy(dp.eps_pos).to(dev)
        self._eps_neg = torch.from_numpy(dp.eps_neg).to(dev)
        self._col_valid = torch.from_numpy(dp.col_valid).to(dev)
        self._beta = float(np.float32(dp.plan.beta))

    def _bn_bill(self) -> int:
        """The kernel row-block granularity billing runs at; the megakernel
        runs at the same granularity, so its billing is identical."""
        return self.scorer.block_n or self.block_n

    def _cap(self, n: int) -> int:
        b = self.block_n
        return -(-max(n, 1) // b) * b

    def _program(self, x, rows, n0: int):
        """The stage loop.  ``x`` has cap + 1 rows (the last is the trash
        row), ``rows`` (cap,) int64 holds the initial row order, trash =
        cap.  Returns device tensors; nothing here syncs with the host."""
        dp, dev = self.dplan, self.device
        S, W, T = dp.S, dp.W, dp.plan.T
        cap = rows.shape[0]
        i32 = torch.int32
        lane = torch.arange(cap, device=dev)
        n_active = torch.full((), n0, dtype=i32, device=dev)
        g = torch.zeros(cap + 1, dtype=torch.float32, device=dev)
        dec = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        ex = torch.full((cap + 1,), T, dtype=i32, device=dev)
        n_in_log = torch.zeros(S, dtype=i32, device=dev)
        trash = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
        for s in range(S):
            n_in_log[s] = n_active
            t0 = int(dp.stage_t0[s])
            g_rows = g[rows]
            if self.megakernel:
                g_new, active, dpos, ex_rel, pack, n_keep = mk.mega_stage(
                    self.scorer.slabs, x[rows], g_rows, s, t0, n_active,
                    self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
                )
            else:
                scores = self.scorer.fn(x, rows, t0, n_active)
                scores = torch.where(self._col_valid[s][None, :], scores, 0.0)
                g_new, active, dpos, ex_rel = cascade_chunk_kernel(
                    g_rows, scores.contiguous(), self._eps_pos[s], self._eps_neg[s],
                    0, block_n=self.block_n, n_valid=n_active,
                )
                keep = active.bool() & (lane < n_active)
                pos = torch.cumsum(keep, dim=0, dtype=i32) - 1
                pack = torch.where(keep, pos, cap)
                n_keep = keep.sum(dtype=i32)
            lane_valid = lane < n_active
            # exits scatter by absolute row id; retired and padding lanes
            # aim at the trash slot
            scat = torch.where(lane_valid & (ex_rel > 0), rows, cap)
            dec[scat] = dpos.bool()
            ex[scat] = ex_rel + t0
            g[torch.where(lane_valid, rows, cap)] = g_new
            rows = trash.clone().index_copy_(0, pack.long(), rows)[:cap]
            n_active = n_keep
        # rows that never exited: classified by the full ensemble score
        dec[torch.where(lane < n_active, rows, cap)] = g[rows] >= self._beta
        return dec[:cap], ex[:cap], g[:cap], n_active, n_in_log

    def run(
        self,
        batch,
        n: int,
        row_order=None,
        capacity: int | None = None,
        prepared: bool = False,
    ) -> ExecutorResult:
        """Execute the cascade for ``n`` rows of ``batch`` on the device.

        ``batch`` is what the scorer's ``prepare`` consumes, or (with
        ``prepared=True``) its output already.  ``row_order`` (numpy or a
        tensor) is the initial active-set order (the sorted policy's
        permutation); results come back scattered to absolute row indices.
        ``capacity`` pins the buffer size across flushes of varying size.
        """
        plan = self.dplan.plan
        T = plan.T
        if n == 0:
            return ExecutorResult(
                decisions=np.zeros(0, dtype=bool),
                exit_step=np.zeros(0, dtype=np.int64),
                g_final=np.zeros(0, dtype=np.float32),
                chunk_stats=[],
                scores_computed=0,
                scores_possible=0,
            )
        cap = self._cap(max(n, capacity or 0))
        x = batch if prepared else self.scorer.prepare(batch)
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        if x.shape[0] > cap + 1:
            x = x[: cap + 1]
        x = torch.nn.functional.pad(x, (0, 0, 0, cap + 1 - x.shape[0]))
        rows = torch.full((cap,), cap, dtype=torch.int64, device=self.device)
        if row_order is None:
            rows[:n] = torch.arange(n, device=self.device)
        else:
            order = torch.as_tensor(row_order, device=self.device).long()
            if order.shape != (n,):
                raise ValueError(f"row_order has shape {tuple(order.shape)}, expected ({n},)")
            rows[:n] = order
        dec, ex, g, n_f, n_in_log = self._program(x, rows, n)
        # the one transfer back to the host, after the loop: every result
        # as int32 words in one buffer (g_final by its bits)
        words = torch.cat(
            [dec[:n].to(torch.int32), ex[:n], g[:n].view(torch.int32), n_f[None], n_in_log]
        ).cpu().numpy()
        dec, ex = words[:n], words[n : 2 * n].astype(np.int64)
        g = words[2 * n : 3 * n].view(np.float32)
        n_f, n_in_log = int(words[3 * n]), words[3 * n + 1 :]
        s_f = int((n_in_log > 0).sum())
        stages = plan.stages
        bn, W = self._bn_bill(), self.dplan.W
        chunk_stats = []
        for s in range(s_f):
            n_in = int(n_in_log[s])
            n_next = int(n_in_log[s + 1]) if s + 1 < s_f else n_f
            chunk_stats.append(
                ChunkStat(
                    t0=stages[s][0],
                    t1=stages[s][1],
                    n_in=n_in,
                    n_exited=n_in - n_next,
                    scores_computed=-(-n_in // bn) * bn * W,
                )
            )
        return ExecutorResult(
            decisions=dec.astype(bool),
            exit_step=ex,
            g_final=g,
            chunk_stats=chunk_stats,
            scores_computed=sum(c.scores_computed for c in chunk_stats),
            scores_possible=n * T,
        )
