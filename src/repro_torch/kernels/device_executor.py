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

**Streaming admission** (``run_stream``, the reference's
``_stream_program``): the survivor buffer becomes a set of ``cap`` lanes
that a ring of ``R`` pending rows refills as lanes free up, each lane at
its own stage.  A step is the admission refill, one mixed-stage kernel
(B7, ``mega_lane``; or the scorer's ``lane_fn`` and the lane decide B6),
the finished rows' scatters and the repack.  Every buffer indexed by a row
id has ``R + 1`` entries, the trash slot at ``R``.  The number of steps
depends on the data, so the loop is enqueued in bursts: after each burst
the live count and the ring head come back in one two-word transfer, and
the loop stops once no lane is live and the ring is empty.  A step
enqueued past that point is inert (every kernel retires at once, every
scatter lands in the trash slot), and a device counter advances only on
the steps where the reference's loop condition held, so ``steps_run``,
``admit_step``, ``done_step`` and the occupancy equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan, ChunkStat, ExecutorResult
from repro_torch.device import resolve_device
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.cascade_kernel import cascade_chunk_kernel, cascade_lane_kernel
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.tree_kernel import gbt_scores_kernel

__all__ = [
    "DEFAULT_BLOCK_N",
    "STREAM_BURST",
    "BoundScorer",
    "DeviceExecutor",
    "DevicePlan",
    "StreamResult",
    "lattice_stage_scorer",
    "matrix_stage_scorer",
    "stream_occupancy",
    "tree_stage_scorer",
]

DEFAULT_BLOCK_N = 64
# streaming steps enqueued between two reads of the loop's end condition
STREAM_BURST = 8


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
    ``lane_fn(x, rows, t0_lane, n_valid) -> (cap, W)``: the per-lane-stage
    variant for streaming admission, ``t0_lane`` a (cap,) tensor of each
    lane's own cascade start (refilled stage-0 rows sit next to
    mid-cascade ones in one buffer).  A scorer without one streams only
    through the fused step (B7).  Only stateless scorers are ported: the
    reference's state carry comes with the neural scorer (ROADMAP A13).
    """

    fn: Callable
    prepare: Callable
    width: int
    block_n: int | None = None
    slabs: mk.ParamSlabs | None = None
    lane_fn: Callable | None = None

    @property
    def has_lanes(self) -> bool:
        return self.lane_fn is not None

    def lane_stage(self, t0_lane, rows, x, n_valid) -> torch.Tensor:
        """The per-lane-stage protocol: scores of positions
        [t0_lane[i], t0_lane[i] + W) for lane i's row."""
        if self.lane_fn is None:
            raise ValueError("this scorer has no per-lane stage scoring (lane_fn)")
        return self.lane_fn(x, rows, t0_lane, n_valid)


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

    def lane_fn(x, rows, t0_lane, n_valid) -> torch.Tensor:
        # lane i reads columns [t0_lane[i], t0_lane[i] + W), always in range
        # since x is padded to T_pad
        idx = t0_lane.long()[:, None] + torch.arange(W, device=x.device)
        return torch.gather(x[rows], 1, idx)

    return BoundScorer(fn=fn, prepare=prepare, width=W, slabs=slabs, lane_fn=lane_fn)


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

    def lane_fn(x, rows, t0_lane, n_valid) -> torch.Tensor:
        # each lane's own W trees, a pure leaf select: bit-identical to B3
        pos = t0_lane.long()[:, None] + torch.arange(W, device=x.device)
        lane = {"feats": feats_p[pos], "thrs": thrs_p[pos], "payload": leaves_p[pos]}
        return mk.lane_scores("tree", x[rows], lane, W)

    return BoundScorer(
        fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs, lane_fn=lane_fn
    )


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

    def lane_fn(x, rows, t0_lane, n_valid) -> torch.Tensor:
        # each lane's own W lattices, contracted dimension by dimension as
        # apply_lattice_scores and csrc/lattice.cuh do (not the reference's
        # corner-weight sum), so the scores equal B5's bit for bit
        pos = t0_lane.long()[:, None] + torch.arange(W, device=x.device)
        lane = {"feats": feats_p[pos], "payload": theta_p[pos]}
        return mk.lane_scores("lattice", x[rows], lane, W)

    return BoundScorer(
        fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs, lane_fn=lane_fn
    )


@dataclasses.dataclass
class StreamResult:
    """Result of a streaming (continuous-batching) run, as the reference's.

    Per-row results mirror ``ExecutorResult``; the streaming-specific
    fields are the loop-step timeline: ``admit_step[i]`` is the loop step
    at which row i left the admission ring for a survivor slot,
    ``done_step[i]`` the step at which its decision was recorded, and
    ``occupancy[s]`` the live slot count at step s (reconstructed
    host-side from admit/done — a lane is live at every step in
    [admit, done]).  Latency in steps is ``done_step - arrival + 1``.
    ``chunk_stats`` stays empty (stages are mixed per step); billing uses
    the same block-guard accounting as the batch path, applied to the
    per-step live count.  ``steps_enqueued`` and ``syncs`` are the port's
    own loop accounting: the steps put on the device (``steps_run`` plus
    the inert ones of the last burst) and the device -> host transfers the
    run waited for.
    """

    decisions: np.ndarray  # (n,) bool
    exit_step: np.ndarray  # (n,) int64, 1-based; T if never exited
    g_final: np.ndarray  # (n,) float32
    admit_step: np.ndarray  # (n,) int64 — loop step of slot admission
    done_step: np.ndarray  # (n,) int64 — loop step of the decision
    steps_run: int  # total loop steps executed
    occupancy: np.ndarray  # (steps_run,) int64 live slots per step
    capacity: int  # survivor-slot capacity (occupancy denominator)
    scores_computed: int
    scores_possible: int
    chunk_stats: list = dataclasses.field(default_factory=list)
    steps_enqueued: int = 0
    syncs: int = 0

    @property
    def mean_occupancy(self) -> float:
        """Mean live-slot fraction over the run's loop steps."""
        if self.steps_run == 0:
            return 0.0
        return float(self.occupancy.mean()) / max(self.capacity, 1)

    @property
    def latency_steps(self) -> np.ndarray:
        """Admission wait + service, in loop steps (admission-relative:
        callers add their own queue wait before the ring)."""
        return self.done_step - self.admit_step + 1


def stream_occupancy(
    admit_step: np.ndarray, done_step: np.ndarray, steps_run: int
) -> np.ndarray:
    """(steps_run,) live-slot count per loop step from the admit/done
    timeline: a row occupies its slot (and is scored) at every step in
    [admit, done].  Shared by the executors' billing, the streaming
    benchmark and the tests."""
    occ = np.zeros(steps_run + 1, dtype=np.int64)
    if steps_run == 0 or admit_step.size == 0:
        return occ[:steps_run]
    np.add.at(occ, admit_step, 1)
    np.add.at(occ, done_step + 1, -1)
    return np.cumsum(occ[:steps_run])


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
        self._stage_t0 = torch.from_numpy(dp.stage_t0).to(dev)
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

    # -- streaming admission (continuous batching) -----------------------

    def _stream_program(self, x, n: int, cap: int, arr: np.ndarray):
        """The admission-ring loop over ``n`` rows of ``x`` ((R + 1, ...),
        the last row the trash row) with ``cap`` lanes; ``arr`` (n,) the
        nondecreasing arrival steps.  Returns the device result buffers
        and the host's count of steps enqueued and syncs."""
        dp, dev = self.dplan, self.device
        S, T = dp.S, dp.plan.T
        R = x.shape[0] - 1  # ring size == output size; R = trash id
        i32 = torch.int32
        lane = torch.arange(cap, device=dev)
        rows = torch.full((cap,), R, dtype=torch.int64, device=dev)
        stage = torch.zeros(cap, dtype=i32, device=dev)
        g = torch.zeros(cap, dtype=torch.float32, device=dev)
        n_live = torch.zeros((), dtype=i32, device=dev)
        head = torch.zeros((), dtype=i32, device=dev)
        steps_run = torch.zeros((), dtype=i32, device=dev)
        dec = torch.zeros(R + 1, dtype=torch.bool, device=dev)
        ex = torch.full((R + 1,), T, dtype=i32, device=dev)
        gout = torch.zeros(R + 1, dtype=torch.float32, device=dev)
        admit = torch.zeros(R + 1, dtype=i32, device=dev)
        done = torch.zeros(R + 1, dtype=i32, device=dev)
        step, syncs = 0, 0
        # the loop runs at least until the last arrival's step: no sync before
        burst = max(STREAM_BURST, int(arr[-1]) + 1)
        while True:
            for _ in range(burst):
                # the reference's loop condition, on the device: live lanes
                # or a non-empty ring.  Once false it stays false, and the
                # step below is inert.
                steps_run += (n - head + n_live).clamp_(max=1)
                # admission refill: the free lanes at the back of the
                # front-packed buffer take the next rows of the ring whose
                # arrival step has come, at stage 0.  A free lane already
                # holds stage 0 and g 0 (the repack zeroes it), and ring
                # slot j holds row j, so a new lane's row id is head + its
                # offset past the live lanes.
                arrived = int(np.searchsorted(arr, step, side="right"))
                k = torch.minimum(cap - n_live, arrived - head)
                off = lane - n_live
                is_new = (off >= 0) & (off < k)
                rows = torch.where(is_new, off + head, rows)
                admit[torch.where(is_new, rows, R)] = step
                n_live = n_live + k
                head = head + k
                # the mixed-stage step: each lane at its own stage
                stop = stage >= S - 1  # lanes running their last stage
                t0_lane = self._stage_t0[stage]
                if self.megakernel:
                    g_new, active, dpos, ex_rel, pack, n_keep = mk.mega_lane(
                        self.scorer.slabs, x, rows, g, stage, stop, n_live,
                        self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
                    )
                else:
                    scores = self.scorer.lane_stage(t0_lane, rows, x, n_live)
                    scores = torch.where(self._col_valid[stage], scores, 0.0)
                    g_new, active, dpos, ex_rel = cascade_lane_kernel(
                        g, scores.contiguous(), self._eps_pos[stage],
                        self._eps_neg[stage], block_n=self.block_n, n_valid=n_live,
                    )
                    # cumsum-prefix compaction: survivors advance a stage
                    keep = active.bool() & ~stop
                    pos = torch.cumsum(keep, dim=0, dtype=i32) - 1
                    pack = torch.where(keep, pos, cap)
                    n_keep = keep.sum(dtype=i32)
                # B6 and B7 start lanes past n_live inactive, so only live
                # lanes exit (ex_rel > 0) or run out (still active at their
                # last stage: decided by the full score, as the batch path's
                # epilogue does)
                newly = ex_rel > 0
                fin = newly | (active.bool() & stop)
                scat = torch.where(fin, rows, R)
                dec[scat] = torch.where(newly, dpos.bool(), g_new >= self._beta)
                ex[scat] = torch.where(newly, ex_rel + t0_lane, T)
                gout[scat] = g_new
                done[scat] = step
                # repack: survivors to the front, freed lanes to (R, 0, 0.0)
                pack = pack.long()
                rows = torch.full((cap + 1,), R, dtype=torch.int64, device=dev).index_copy_(
                    0, pack, rows
                )[:cap]
                stage = torch.zeros(cap + 1, dtype=i32, device=dev).index_copy_(
                    0, pack, stage + 1
                )[:cap]
                g = torch.zeros(cap + 1, dtype=torch.float32, device=dev).index_copy_(
                    0, pack, g_new
                )[:cap]
                n_live = n_keep
                step += 1
            live, taken = torch.stack([n_live, head]).tolist()
            syncs += 1
            if live == 0 and taken == n:
                break
            burst = STREAM_BURST
        return dec[:n], ex[:n], gout[:n], admit[:n], done[:n], steps_run, step, syncs

    def run_stream(
        self,
        batch,
        n: int,
        arrivals=None,
        capacity: int | None = None,
        ring_capacity: int | None = None,
        prepared: bool = False,
    ) -> StreamResult:
        """Continuously stream ``n`` rows through ``capacity`` survivor lanes.

        ``arrivals`` (optional, (n,) nondecreasing ints) gates admission:
        row i cannot be admitted before loop step ``arrivals[i]`` (None =
        everyone is already waiting).  ``capacity`` pins the lane count
        (block-padded; default all ``n`` rows at once) and
        ``ring_capacity`` the admission-ring size (default ``n``), so a
        server's waves share one buffer geometry.  ``prepared=True`` means
        ``batch`` is already the scorer-prepared operand.
        """
        plan = self.dplan.plan
        T = plan.T
        if not self.scorer.has_lanes and not self.megakernel:
            raise ValueError(
                "run_stream needs a scorer with per-lane stage scoring "
                "(lane_fn) on the multi-kernel path; this scorer only "
                "supports batch stages"
            )
        if n == 0:
            return StreamResult(
                decisions=np.zeros(0, dtype=bool),
                exit_step=np.zeros(0, dtype=np.int64),
                g_final=np.zeros(0, dtype=np.float32),
                admit_step=np.zeros(0, dtype=np.int64),
                done_step=np.zeros(0, dtype=np.int64),
                steps_run=0,
                occupancy=np.zeros(0, dtype=np.int64),
                capacity=self._cap(capacity or 1),
                scores_computed=0,
                scores_possible=0,
            )
        cap = self._cap(capacity or n)
        R = max(n, int(ring_capacity or n))
        arr = (
            np.zeros(n, dtype=np.int64)
            if arrivals is None
            else np.asarray(arrivals, dtype=np.int64)
        )
        if arr.shape != (n,):
            raise ValueError(f"arrivals has shape {arr.shape}, expected ({n},)")
        if (np.diff(arr) < 0).any():
            raise ValueError("arrivals must be nondecreasing")
        x = batch if prepared else self.scorer.prepare(batch)
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        # R ring rows, then the trash row R (zeros) that free lanes read
        x = x[: R + 1]
        x = torch.nn.functional.pad(x, (0, 0, 0, R + 1 - x.shape[0]))
        dec, ex, g, admit, done, steps_run, enqueued, syncs = self._stream_program(
            x.contiguous(), n, cap, arr
        )
        # the one transfer of the results, after the loop
        words = torch.cat(
            [steps_run[None], dec.to(torch.int32), ex, g.view(torch.int32), admit, done]
        ).cpu().numpy()
        steps_run = int(words[0])
        dec, ex, g, admit, done = np.split(words[1:], 5)
        admit, done = admit.astype(np.int64), done.astype(np.int64)
        occ = stream_occupancy(admit, done, steps_run)
        # block-guard billing per loop step, as the batch path: the live
        # lanes are front-packed, so a guarded kernel computes
        # ceil(live / block) blocks of the W-wide slab
        bn, W = self._bn_bill(), self.dplan.W
        return StreamResult(
            decisions=dec.astype(bool),
            exit_step=ex.astype(np.int64),
            g_final=g.view(np.float32),
            admit_step=admit,
            done_step=done,
            steps_run=steps_run,
            occupancy=occ,
            capacity=cap,
            scores_computed=int(((-(-occ // bn)) * bn * W).sum()),
            scores_possible=n * T,
            steps_enqueued=enqueued,
            syncs=syncs + 1,
        )
