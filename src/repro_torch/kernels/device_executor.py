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
  one transfer to the host.
* **Megakernel.**  With f32 ``ParamSlabs`` the stage is one fused kernel
  (B4, ``megakernel.py``); otherwise (or with ``megakernel=False``) it is
  the scorer's kernel (B3 for trees, B5 for lattices) -> B2's step form,
  which reads the partial sums through the row ids and the stage's tables
  in place, masks the padded columns and writes the pack positions.
  The two are bit-identical in results and in billing.  Quantised (bf16,
  int8) slabs run fused only when asked for (``megakernel=True``): their
  results are held to the f32 multi-kernel path by the tolerance oracle
  (``megakernel.check_parity``), their billing exactly.

Stages are uniformized to the plan's maximum width ``W``: padded columns
carry ±inf thresholds and zeroed scores, so they never move a partial sum
or trigger an exit.

**Survivor state** (the reference's state carry): a stateful scorer (the
neural depth cascade, ``api.scorers.NeuralScorer``) declares per-row state
buffers (``BoundScorer.state_spec``) that every loop carries lane for lane
beside the row ids and repacks with the same pack positions
(``repack_state``; in the grouped loops at lane granularity).  In the
batch and grouped loops every row starts at stage 0, where the scorer
builds its state from the operand, so the state lives inside the program.
The streaming loops' lanes span bursts: there the state buffers belong to
the loop state, made with its other buffers (static inputs of its graph
on the card) and zeroed each run.  A stateless scorer declares none, and
its loops make no extra buffer and no extra launch.

**Streaming admission** (``run_stream``, the reference's
``_stream_program``): the survivor buffer becomes a set of ``cap`` lanes
that a ring of ``R`` pending rows refills as lanes free up, each lane at
its own stage.  A step is the admission refill, one mixed-stage kernel
(B7, ``mega_lane``; or the scorer's ``lane_fn`` and the lane decide B6,
which reads the stage tables in place and writes the pack positions), the
finished rows' scatters and the repack.  Every buffer indexed by a row
id has ``R + 1`` entries, the trash slot at ``R``.  The number of steps
depends on the data, so the loop is enqueued in bursts of
``STREAM_BURST`` steps: after each sync the live count and the ring head
come back in one two-word transfer, and the loop stops once no lane is
live and the ring is empty.  The first sync waits for the last arrival
(``ceil(max(STREAM_BURST, arrivals[-1] + 1) / STREAM_BURST)`` bursts),
every later one follows one burst.  The step counter and the arrival steps live on the device (a
lane's ``arrived`` count is a ``searchsorted`` there), so a burst reads
nothing from the host.  A step enqueued past the end is inert (every
kernel retires at once, every scatter lands in the trash slot), and a
device counter advances only on the steps where the reference's loop
condition held, so ``steps_run``, ``admit_step``, ``done_step`` and the
occupancy equal the reference's.

**Compiled programs** (the reference's contract: one trace per program
key, counted by ``DeviceExecutor.traces``).  A program's key is what
``jax.jit`` keys the reference's program on: the shapes and dtypes of the
loop's tensor inputs and its static arguments (``k`` for the grouped
loop; the lane count and the ring size for streaming).  The grouped
loop's operand is padded to a row capacity (``capacity_rows``, else the
next power of two), so flushes with different document counts share a
key.  ``traces`` counts the distinct keys an executor has run.  On the
card (and ``capture=True``, the default) the first run of a key runs the
loop eagerly; the second captures it into a ``torch.cuda.CUDAGraph`` and
replays it, and every later run writes its inputs into the graph's static
buffers and replays it.  A key run once (a one-off size) thus costs its
eager loop and no capture.  The executor keeps the ``MAX_GRAPHS`` graphs
used last (a key whose graph was dropped is captured again when it
returns).  The eager run and the capture execute the same loop body.
Each graph records the kernel launches its capture enqueued, and each
replay adds them to ``_build.LAUNCHES``.  ``capture=False`` (the
counterpart of ``jax.disable_jit``) keeps the eager loop on the card; on
the CPU the loop is always eager.

**Grouped (ranking) loop** (``run_grouped``, the reference's
``_grouped_program``): the batch stage loop at GROUP granularity.  The
buffers are (cap_g, B) bucket-layout rectangles, a query group is B
contiguous lanes, and the decide is the group decide (B8, top-k
stability margin, and the group's top-k picks) instead of the row
threshold test.  Groups exit as a
unit, live groups stay front-packed (whole-group compaction, trash slot
``cap_g``), and ``n_active`` counts live groups on the device, read by
B8 as ``n_live``.  As in the reference it always runs the scorer's stage
function and B8 (the fused stage step has no group semantics), and the
stage's scores are added column by column, the host oracle's f32 add
order, so margins and verdicts equal ``run_grouped_host``'s bit for bit.

**Grouped streaming** (``run_stream_grouped``, the reference's
``_grouped_stream_program``): the streaming loop at GROUP-slot
granularity.  ``cap_g`` slots of B lanes each, every slot at its own
stage; a ring of ``Rg`` pending groups (ring slot j holds group j, trash
id ``Rg``) refills freed slots in arrival order.  A step is the refill,
the scorer's ``lane_fn`` over every lane (each slot's stage repeated over
its B lanes), the column-by-column add, B8 at each slot's own threshold
``eps_g[stage]`` (with the picks), the finished groups' scatters and the
whole-group repack.  It is enqueued in bursts of ``STREAM_BURST`` steps
with the step counter and the arrivals on the device, exactly as
``run_stream``, and its ``steps_run``, timeline and bill equal the
reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan, ChunkStat, ExecutorResult
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.cascade_kernel import (
    DEFAULT_BLOCK_G,
    cascade_chunk_step,
    cascade_group_kernel,
    cascade_lane_step,
    group_topk_rows,
)
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.tree_kernel import gbt_scores_kernel
from repro_torch.launch.shardings import split_columns, stage_column_slices
from repro_torch.testing import faults

__all__ = [
    "DEFAULT_BLOCK_N",
    "STREAM_BURST",
    "BoundScorer",
    "DeviceExecutor",
    "DevicePlan",
    "GroupedResult",
    "GroupedStreamResult",
    "StreamResult",
    "WaveFailure",
    "check_batch_finite",
    "group_topk_rows",
    "launch_wave",
    "lattice_stage_scorer",
    "matrix_stage_scorer",
    "repack_state",
    "stream_occupancy",
    "tree_stage_scorer",
]

DEFAULT_BLOCK_N = 64
# streaming steps enqueued between two reads of the loop's end condition
STREAM_BURST = 8
# CUDA graphs an executor keeps (the ones used last)
MAX_GRAPHS = 16


class WaveFailure(RuntimeError):
    """A device wave (one ``run`` / ``run_stream`` / ``run_grouped`` /
    ``run_stream_grouped`` launch) failed with an injected fault
    (``testing.faults``), the one retryable signal of the degradation
    ladder.  Unlike the reference, the port turns no other error into
    this type (ROADMAP C11): a CUDA launch error, a build or load failure,
    an illegal address or an out-of-memory error propagates untouched,
    since a CUDA error is sticky on the card and a fall to the host would
    hide a kernel fault."""


def launch_wave(executor_name: str, fn):
    """Run one device wave under the wave fault contract: the injection
    point fires first, before ``fn`` writes any input (a captured graph's
    static buffers included), and an injected fault comes out as
    ``WaveFailure``; everything else ``fn`` raises passes through."""
    try:
        faults.on_wave(executor_name)
        return fn()
    except faults.FaultInjected as e:
        raise WaveFailure(str(e)) from e


def check_batch_finite(batch, n: int) -> None:
    """Reject non-finite rows before they reach a device program (the
    executors' ``check_finite=True``; the servers' quarantine normally
    catches them at admission).  ``batch`` is an array or a tensor (one
    transfer of a row mask from the card).  Raises ``ValueError`` (not
    retryable: a poisoned batch does not heal with backoff) naming the
    offending rows."""
    if isinstance(batch, torch.Tensor):
        if not batch.is_floating_point():
            return
        x = batch[:n]
        bad = ~torch.isfinite(x).reshape(x.shape[0], -1).all(1).cpu().numpy()
    else:
        arr = np.asarray(batch)[:n]
        if not np.issubdtype(arr.dtype, np.floating):
            return
        finite = np.isfinite(arr)
        bad = ~(finite if arr.ndim == 1 else finite.all(axis=tuple(range(1, arr.ndim))))
    if bad.any():
        rows = np.flatnonzero(bad)
        head = ", ".join(map(str, rows[:8]))
        more = f", ... ({rows.size} total)" if rows.size > 8 else ""
        raise ValueError(
            f"non-finite values in batch rows [{head}{more}]; quarantine "
            "poisoned rows before submission"
        )


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """A ``CascadePlan`` lowered to static-shape stage arrays (host numpy;
    the executor uploads them).

    All stages are padded to the maximum stage width ``W``; padded columns
    get ±inf thresholds and a False ``col_valid``.  The thresholds are f64
    in the plan and f32 here, the dtype every decide runs at.  ``quant``
    is the storage of the scorers' ``ParamSlabs`` (f32, bf16 or int8).
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

    The protocol, shared by the host ``ChunkedExecutor`` (through
    ``api.scorers.host_producer``), the batch, streaming and grouped loops:

        ``stage(state, t0, t1, rows, x, n_valid) -> (scores, state)``

    ``state`` is a dict of per-lane tensors declared by ``state_spec``
    (``{name: (per-row shape, dtype)}``), each with a leading capacity axis;
    the executors carry it through the survivor buffers and repack it with
    the row ids' own pack positions (``repack_state``).  A row's state at
    its FIRST stage (``t0 == 0``) is undefined: a stateful scorer
    initialises it from the prepared operand there (streaming admission
    drops rookies into recycled lanes).  A stateless scorer declares no
    state (``state_spec`` empty): the threading then adds no buffer and no
    launch, and its programs and billing stay as they were.

    ``fn(x, rows, t0, n_valid) -> (cap, W)``: scores of cascade positions
    [t0, t0 + W) for the (front-packed) row buffer ``rows`` of the prepared
    operand ``x``; ``n_valid`` is the live count (an int32 tensor on the
    device), which a blocked kernel may use to skip row blocks past it.
    ``prepare(batch) -> x``: the batch as the operand ``fn`` reads, on the
    device.  ``block_n``: the scorer's own kernel row-block size, the
    granularity its block guard computes at, which billing uses (None = an
    exact producer, billed at the executor's block).  ``slabs``: the
    params as stage-stacked ``ParamSlabs``, the ticket into the fused
    stage step (a stateful scorer carries none: the fused step has no
    state lane).
    ``lane_fn(x, rows, t0_lane, n_valid) -> (cap, W)``: the per-lane-stage
    variant for streaming admission, ``t0_lane`` a (cap,) tensor of each
    lane's own cascade start (refilled stage-0 rows sit next to
    mid-cascade ones in one buffer).  A scorer without one streams only
    through the fused step (B7).  A stateful scorer gives ``stage_fn`` /
    ``lane_stage_fn`` (the protocol's signatures) instead of ``fn`` /
    ``lane_fn``.
    ``model_partition`` (optional): the ticket onto a 2-D ``("data",
    "model")`` mesh.  ``model_partition(M) -> (mparams, col_fn)``:
    ``mparams`` is a dict of stage-stacked slab slices with a leading
    model-shard axis (``(M, S, w_local, ...)``, from
    ``launch.shardings.stage_column_slices``), and ``col_fn(mp, x, rows, s,
    t0, c0, n_valid) -> (cap, w_local)`` scores only cascade columns [t0 +
    c0, t0 + c0 + w_local) of stage ``s`` from one shard's slice ``mp``
    (``mparams`` without its leading axis).  A scorer without one cannot
    run at ``model_shards > 1``.
    """

    fn: Callable | None
    prepare: Callable
    width: int
    block_n: int | None = None
    slabs: mk.ParamSlabs | None = None
    lane_fn: Callable | None = None
    state_spec: dict = dataclasses.field(default_factory=dict)
    stage_fn: Callable | None = None
    lane_stage_fn: Callable | None = None
    model_partition: Callable | None = None

    @property
    def stateful(self) -> bool:
        return bool(self.state_spec)

    @property
    def has_lanes(self) -> bool:
        return self.lane_fn is not None or self.lane_stage_fn is not None

    def init_state(self, cap: int, device) -> dict:
        """Zero state buffers at capacity ``cap`` on ``device`` (a leading
        axis added to every ``state_spec`` entry); ``{}`` when stateless."""
        return {
            name: torch.zeros((cap, *shape), dtype=dtype, device=device)
            for name, (shape, dtype) in self.state_spec.items()
        }

    def stage(self, state, t0, t1, rows, x, n_valid):
        """The protocol: scores of cascade positions [t0, t1) for the
        buffer's rows, and the carried-forward state."""
        if self.stage_fn is not None:
            return self.stage_fn(state, t0, t1, rows, x, n_valid)
        return self.fn(x, rows, t0, n_valid), state

    def lane_stage(self, state, t0_lane, rows, x, n_valid):
        """The per-lane-stage protocol: scores of positions
        [t0_lane[i], t0_lane[i] + W) for lane i's row, and the state."""
        if self.lane_stage_fn is not None:
            return self.lane_stage_fn(state, t0_lane, rows, x, n_valid)
        if self.lane_fn is None:
            raise ValueError("this scorer has no per-lane stage scoring (lane_fn)")
        return self.lane_fn(x, rows, t0_lane, n_valid), state


def repack_state(state_new: dict, pack: torch.Tensor) -> dict:
    """Front-pack a survivor-state dict with the compaction's ``pack``
    positions (int64; ``len(pack)`` is the trash slot): a surviving lane's
    updated state lands at its packed position, retired lanes drop,
    vacated lanes read zero.  ``{}`` for a stateless scorer, with no
    launch."""
    return {name: _repack(v, pack, 0) for name, v in state_new.items()}


def matrix_stage_scorer(
    dplan: DevicePlan, quant: str | None = None, device="cuda"
) -> BoundScorer:
    """Scorer over a precomputed cascade-ORDERED (n, T) matrix (the eager
    ``score_fn`` path and the tests' oracle path)."""
    dev = resolve_device(device)
    W, T, T_pad = dplan.W, dplan.plan.T, dplan.T_pad
    slabs = mk.build_matrix_slabs(dplan, quant=quant or dplan.quant, device=dev)

    def prepare(ordered) -> torch.Tensor:
        if isinstance(ordered, torch.Tensor):  # e.g. a score kernel's output
            F = ordered.to(device=dev, dtype=torch.float32)
        else:
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

    def model_partition(model_shards: int):
        w_l, w_g = split_columns(W, model_shards)

        def col_fn(mp, x, rows, s, t0, c0, n_valid):
            # x is padded to T_pad = max(t0) + W, and a slice past its end
            # returns fewer columns: the last shard's slice of the last
            # stage may reach w_g - W columns further, which read as zeros
            # (the reference pads x[rows] by w_g - W before its slice)
            cols = x[rows, t0 + c0 : t0 + c0 + w_l]
            return torch.nn.functional.pad(cols, (0, w_l - cols.shape[1]))

        # the slab is the operand itself: each model shard reads its columns
        return {}, col_fn

    return BoundScorer(
        fn=fn, prepare=prepare, width=W, slabs=slabs, lane_fn=lane_fn,
        model_partition=model_partition,
    )


def _slab_partition(dplan: DevicePlan, params: dict, kernel, block_n: int, device):
    """The ``model_partition`` hook of a scorer whose stage slab is
    ``params`` (name -> cascade-ordered array, in ``kernel``'s argument
    order): model shard j's ``(S, w_local, ...)`` column slices, and a
    ``col_fn`` launching ``kernel`` (B3 or B5) on stage s's slice."""

    def model_partition(model_shards: int):
        w_l, w_g = split_columns(dplan.W, model_shards)
        mparams = {
            name: stage_column_slices(a, dplan.stage_t0, w_l, w_g, device=device)
            for name, a in params.items()
        }

        def col_fn(mp, x, rows, s, t0, c0, n_valid):
            # a tree's or lattice's score depends on its own params only, so
            # the kernel over the shard's (w_l, ...) slice gives its columns
            # bit for bit
            return kernel(
                *(mp[name][s] for name in params), x, block_n=block_n, t0=0, t1=w_l,
                rows=rows, n_valid=n_valid,
            )

        return mparams, col_fn

    return model_partition


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
    n_feats = int(feats_o.max()) + 1 if feats_o.size else 0

    def prepare(x) -> torch.Tensor:
        x = np.asarray(x, dtype=np.float32)
        # the kernels read x[:, feats] unchecked
        if x.ndim != 2 or x.shape[1] < n_feats:
            raise ValueError(
                f"expected (n, >= {n_feats}) feature rows for the trees, got {x.shape}"
            )
        return torch.as_tensor(x).to(dev)

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
        fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs, lane_fn=lane_fn,
        model_partition=_slab_partition(
            dplan,
            {
                "feats": feats_o,
                "thrs": np.asarray(thrs_ordered, np.float32),
                "leaves": np.asarray(leaves_ordered, np.float32),
            },
            gbt_scores_kernel, block_n, dev,
        ),
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
        fn=fn, prepare=prepare, width=W, block_n=block_n, slabs=slabs, lane_fn=lane_fn,
        model_partition=_slab_partition(
            dplan, {"theta": theta_o, "feats": feats_o}, lattice_scores_kernel, block_n, dev
        ),
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


def _repack(buf: torch.Tensor, pack: torch.Tensor, fill) -> torch.Tensor:
    """Compaction by pack positions: ``buf[i]`` lands at ``pack[i]``, every
    other slot holds ``fill``; ``pack == len(pack)`` is the trash slot,
    dropped."""
    n = pack.shape[0]
    out = torch.full((n + 1, *buf.shape[1:]), fill, dtype=buf.dtype, device=buf.device)
    return out.index_copy_(0, pack, buf)[:n]


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


@dataclasses.dataclass
class GroupedResult:
    """One ranked verdict per query group, as the reference's.

    ``verdicts`` (G, k) are flat GLOBAL document row ids in rank order,
    -1 past the group's size.  ``exit_stage`` is 1-based; ``S`` for
    groups that ran the full cascade.  ``margin`` is the top-k stability
    margin at decision time.  ``chunk_stats`` counts GROUPS in/exited
    per stage; ``scores_computed`` is group-quantized block billing,
    ``scores_possible`` is real documents x T.
    """

    verdicts: np.ndarray  # (G, k) int32
    exit_stage: np.ndarray  # (G,) int64
    margin: np.ndarray  # (G,) float32
    chunk_stats: list[ChunkStat]
    scores_computed: int
    scores_possible: int


@dataclasses.dataclass
class GroupedStreamResult:
    """Result of a streaming grouped run, as the reference's: the
    ``GroupedResult`` fields per group plus the slot timeline of
    ``StreamResult`` at GROUP granularity (``occupancy`` counts live group
    slots; billing multiplies by the bucket width before it
    block-quantizes).  ``steps_enqueued`` and ``syncs`` are the port's own
    loop accounting, as on ``StreamResult``."""

    verdicts: np.ndarray  # (G, k) int32
    exit_stage: np.ndarray  # (G,) int64
    margin: np.ndarray  # (G,) float32
    admit_step: np.ndarray  # (G,) int64
    done_step: np.ndarray  # (G,) int64
    steps_run: int
    occupancy: np.ndarray  # (steps_run,) int64 live group slots per step
    capacity_groups: int
    scores_computed: int
    scores_possible: int
    steps_enqueued: int = 0
    syncs: int = 0

    @property
    def mean_occupancy(self) -> float:
        if self.steps_run == 0:
            return 0.0
        return float(self.occupancy.mean()) / max(self.capacity_groups, 1)

    @property
    def latency_steps(self) -> np.ndarray:
        return self.done_step - self.admit_step + 1


@dataclasses.dataclass
class _Graph:
    """One captured program: the CUDA graph, the static input tensors a
    replay reads (each run writes its inputs into them first), what a
    replay writes, and the kernel launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: object
    launches: collections.Counter


@dataclasses.dataclass
class _StreamState:
    """The streaming program's inputs and loop state, updated in place by
    each burst: ``x`` (R + 1, ...) the ring's rows (the last the trash
    row), ``arr`` (R,) their nondecreasing arrival steps, ``n`` the rows in
    the ring; ``rows``, ``stage`` and ``g`` (cap,) the lanes; ``n_live``,
    ``head``, ``steps_run`` and ``step`` the loop's counters; ``dec``,
    ``ex``, ``gout``, ``admit`` and ``done`` (R + 1,) the results by row id
    (trash slot R); ``probe`` (2,) the live count and the ring head, which
    the host reads between bursts; ``state`` the scorer's per-lane state
    (cap, ...) buffers (``{}`` for a stateless scorer).  Counters and ids
    are int32 scalars on the device (``rows`` int64)."""

    x: torch.Tensor
    arr: torch.Tensor
    n: torch.Tensor
    rows: torch.Tensor
    stage: torch.Tensor
    g: torch.Tensor
    n_live: torch.Tensor
    head: torch.Tensor
    steps_run: torch.Tensor
    step: torch.Tensor
    dec: torch.Tensor
    ex: torch.Tensor
    gout: torch.Tensor
    admit: torch.Tensor
    done: torch.Tensor
    probe: torch.Tensor
    state: dict


@dataclasses.dataclass
class _GroupedStreamState:
    """The grouped streaming program's inputs and loop state, updated in
    place by each burst: ``x`` the operand (padded rows), ``ring_rows`` /
    ``ring_valid`` (Rg, B) the pending groups' rows and real-lane masks
    (ring slot j holds group j), ``arr`` (Rg,) their nondecreasing arrival
    steps (int32 max past the ``n`` groups), ``eps`` (S,) the margin
    thresholds; ``gids``, ``rows``, ``valid``, ``stage`` and ``g`` the
    (cap_g,) / (cap_g, B) slots; ``n_live``, ``head``, ``steps_run`` and
    ``step`` the loop's counters; ``verd`` (Rg + 1, k), ``exst``, ``marg``,
    ``admit`` and ``done`` (Rg + 1,) the results by group id (trash slot
    Rg); ``probe`` (2,) the live count and the ring head; ``state`` the
    scorer's per-lane state (cap_g * B, ...) buffers (``{}`` for a
    stateless scorer)."""

    x: torch.Tensor
    ring_rows: torch.Tensor
    ring_valid: torch.Tensor
    arr: torch.Tensor
    n: torch.Tensor
    eps: torch.Tensor
    gids: torch.Tensor
    rows: torch.Tensor
    valid: torch.Tensor
    stage: torch.Tensor
    g: torch.Tensor
    n_live: torch.Tensor
    head: torch.Tensor
    steps_run: torch.Tensor
    step: torch.Tensor
    verd: torch.Tensor
    exst: torch.Tensor
    marg: torch.Tensor
    admit: torch.Tensor
    done: torch.Tensor
    probe: torch.Tensor
    state: dict


def _lane_pack(pack: torch.Tensor, B: int) -> torch.Tensor:
    """A whole-group compaction's slot pack positions (cap_g,) expanded to
    its B lanes: lane j of a kept slot lands at ``pack * B + j``, the lanes
    of a dropped slot (pack ``cap_g``) at the lane trash slot ``cap_g * B``."""
    cap_g = pack.shape[0]
    lanes = pack[:, None] * B + torch.arange(B, device=pack.device)
    return torch.where((pack < cap_g)[:, None], lanes, cap_g * B).reshape(cap_g * B)


class _DeviceLoops:
    """What the device executors share (``DeviceExecutor`` here, the
    data-parallel ``ShardedDeviceExecutor``): the plan's tables on the
    device, the megakernel policy, the operand cast, and the compiled
    programs, one per key (a CUDA graph each on the card; see the module
    docstring)."""

    def __init__(
        self,
        plan: CascadePlan | DevicePlan,
        scorer: BoundScorer,
        block_n: int = DEFAULT_BLOCK_N,
        megakernel: bool | None = None,
        device="cuda",
        capture: bool = True,
        check_finite: bool = False,
    ):
        self.dplan = plan if isinstance(plan, DevicePlan) else DevicePlan.from_plan(plan)
        if scorer.width != self.dplan.W:
            raise ValueError(
                f"scorer width {scorer.width} != plan stage width {self.dplan.W}"
            )
        if megakernel is None:
            megakernel = scorer.slabs is not None and scorer.slabs.quant == "f32"
        if megakernel and scorer.stateful:
            raise ValueError(
                "megakernel=True is incompatible with a stateful scorer "
                "(non-empty state_spec): the fused stage step has no "
                "survivor-state carry.  Use the multi-kernel path "
                "(megakernel=False / the auto default)."
            )
        if megakernel and scorer.slabs is None:
            raise ValueError("megakernel=True needs a scorer with ParamSlabs")
        self.megakernel = bool(megakernel)
        self.scorer = scorer
        self.check_finite = bool(check_finite)
        self.block_n = max(1, int(block_n))
        self.device = resolve_device(device)
        self.capture = bool(capture)
        self._keys: set[tuple] = set()
        self._graphs: collections.OrderedDict[tuple, _Graph] = collections.OrderedDict()
        self._pool = None  # the graphs' shared memory pool, made at the first capture
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

    def _cast_operand(self, x):
        """Matrix quantised storage: the payload is the prepared operand,
        so it is cast to the slabs' ``x_dtype`` once per run, when the
        fused step runs.  Every other configuration leaves it as it is."""
        sl = self.scorer.slabs
        if self.megakernel and sl.x_dtype is not None and x.dtype != sl.x_dtype:
            return x.to(sl.x_dtype)
        return x

    # -- compiled programs: one trace per key, a CUDA graph each on the card

    @property
    def traces(self) -> int:
        """The program keys this executor has run (the reference's jit
        trace count).

        One divergence, by design (ROADMAP C10): the streaming
        ``GroupedRankServer`` pins each wave's ring to the slot capacity
        (``ring_capacity=cap``), so its waves of one bucket width share one
        ``run_stream_grouped`` key, where the reference passes no ring
        capacity and keys on each wave's group count.  Over waves of one
        width with different group counts this count is below the
        reference's; verdicts, margins and the bill are the same
        (``tests/test_torch_grouped_stream.py::
        test_streaming_server_traces_two_waves_one_width``)."""
        return len(self._keys)

    def _buffers(self, key: tuple, make: Callable) -> tuple:
        """The input tensors of program ``key``: its graph's static ones
        when it has a graph, else ``make()``'s new ones.  The caller writes
        the run's inputs into them."""
        graph = self._graphs.get(key)
        return graph.inputs if graph is not None else make()

    def _execute(self, key: tuple, body: Callable, inputs: tuple):
        """``body(*inputs)``, the loop of program ``key``.  A key's first
        run is eager and counts a trace.  On the card with ``capture``, its
        second run captures the body into a graph whose static inputs are
        ``inputs`` (the executor's own buffers, never a caller's tensors),
        and that run and every later one replay the graph, ``inputs`` being
        its static tensors."""
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._keys or not (self.capture and self.device.type == "cuda"):
                self._keys.add(key)
                return body(*inputs)
            graph = self._graphs[key] = self._capture(body, inputs)
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        graph.graph.replay()
        _build.LAUNCHES.update(graph.launches)
        return graph.outputs

    def _capture(self, body: Callable, inputs: tuple) -> _Graph:
        """Capture ``body(*inputs)`` into a CUDA graph in the executor's
        pool (recorded, not run).  The key's eager run before it built and
        loaded every kernel; the launchers launch on the current stream,
        the capture stream here."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = collections.Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph, pool=self._pool):
            outputs = body(*inputs)
        launches = _build.LAUNCHES - before
        # the capture recorded these launches; it ran none of them
        _build.LAUNCHES.subtract(launches)
        return _Graph(graph, inputs, outputs, launches)

    @staticmethod
    def _write_rows(buf: torch.Tensor, x: torch.Tensor) -> None:
        """``buf`` = the first ``len(buf)`` rows of ``x``, zero rows past them."""
        m = min(x.shape[0], buf.shape[0])
        buf[:m].copy_(x[:m])
        if m < buf.shape[0]:
            buf[m:].zero_()


class DeviceExecutor(_DeviceLoops):
    """Runs a ``CascadePlan`` on one device with no host sync in the stage
    loop (see the module docstring).

    Billing: a stage that ran computes ``ceil(n_in / bn) * bn`` rows of its
    W-wide slab, ``bn`` being the scorer's kernel block (its block guard
    skips row blocks past the live count), the same accounting as the
    reference.  ``megakernel`` selects the fused stage step: ``None``
    (default) turns it on when the scorer carries f32 ``ParamSlabs``;
    ``True`` also runs quantised slabs fused (their results certified by
    the tolerance oracle, not bit equality); ``False`` forces the
    multi-kernel path, which scores from the f32 params.  ``device`` defaults to the
    card; on ``"cpu"`` every kernel wrapper takes its plain version.
    ``capture`` (default True) replays each program key's loop as a CUDA
    graph on the card; False keeps the eager loop there.  ``traces``
    counts the program keys run (see the module docstring).
    ``check_finite`` rejects a batch holding a non-finite value before its
    wave (``check_batch_finite``).  Every wave goes through
    ``launch_wave`` under the executor name ``"device"``.
    """

    def _cap(self, n: int) -> int:
        b = self.block_n
        return -(-max(n, 1) // b) * b

    # -- the batch stage loop ---------------------------------------------

    def _program(self, x, rows, n0):
        """The stage loop.  ``x`` has cap + 1 rows (the last is the trash
        row), ``rows`` (cap,) int64 holds the initial row order (trash =
        cap), ``n0`` (an int32 scalar on the device) the live count.  A
        stateful scorer's state starts empty (every row's first stage
        builds it from ``x``) and rides the rows' compaction.
        Returns one int32 buffer: the decisions, exit steps and ``g``'s
        bits (cap each), the final live count and the (S,) live counts
        entering each stage.  Nothing here syncs with the host."""
        dp, dev = self.dplan, self.device
        S, W, T = dp.S, dp.W, dp.plan.T
        cap = rows.shape[0]
        i32 = torch.int32
        lane = torch.arange(cap, device=dev)
        n_active = n0
        g = torch.zeros(cap + 1, dtype=torch.float32, device=dev)
        dec = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        ex = torch.full((cap + 1,), T, dtype=i32, device=dev)
        n_in_log = torch.zeros(S, dtype=i32, device=dev)
        trash = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
        state: dict = {}
        for s in range(S):
            n_in_log[s] = n_active
            t0 = int(dp.stage_t0[s])
            if self.megakernel:
                # the matrix variant reads its rows of x in place
                in_place = self.scorer.slabs.variant == "matrix"
                g_new, active, dpos, ex_rel, pack, n_keep = mk.mega_stage(
                    self.scorer.slabs, x if in_place else x[rows], g[rows], s, t0,
                    n_active, self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
                    rows=rows if in_place else None,
                )
            else:
                # B2's step form reads g through rows and the stage's
                # tables in place, masks the padded columns and writes the
                # pack positions and the kept count
                scores, state_new = self.scorer.stage(state, t0, t0 + W, rows, x, n_active)
                g_new, active, dpos, ex_rel, pack, n_keep = cascade_chunk_step(
                    g, rows, scores, s, self._eps_pos, self._eps_neg, self._col_valid,
                    n_valid=n_active, block_n=self.block_n,
                )
            lane_valid = lane < n_active
            # exits scatter by absolute row id; retired and padding lanes
            # aim at the trash slot
            scat = torch.where(lane_valid & (ex_rel > 0), rows, cap)
            dec[scat] = dpos.bool()
            ex[scat] = ex_rel + t0
            g[torch.where(lane_valid, rows, cap)] = g_new
            pack = pack.long()
            rows = trash.clone().index_copy_(0, pack, rows)[:cap]
            if not self.megakernel and state_new:
                # the state rides the rows' own compaction (megakernel
                # scorers are stateless)
                state = repack_state(state_new, pack)
            n_active = n_keep
        # rows that never exited: classified by the full ensemble score
        dec[torch.where(lane < n_active, rows, cap)] = g[rows] >= self._beta
        return torch.cat(
            [dec[:cap].to(i32), ex[:cap], g[:cap].view(i32), n_active[None], n_in_log]
        )

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
        ``capacity`` pins the buffer size across flushes of varying size,
        so they share one program (one graph on the card).
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
        if self.check_finite:
            check_batch_finite(batch, n)
        cap = self._cap(max(n, capacity or 0))
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        dev = self.device
        order = None
        if row_order is not None:
            order = torch.as_tensor(row_order, device=dev).long()
            if order.shape != (n,):
                raise ValueError(f"row_order has shape {tuple(order.shape)}, expected ({n},)")
        key = ("batch", cap, tuple(x.shape[1:]), x.dtype)

        def wave():
            bufs = self._buffers(key, lambda: (
                torch.empty((cap + 1, *x.shape[1:]), dtype=x.dtype, device=dev),
                torch.empty(cap, dtype=torch.int64, device=dev),
                torch.empty((), dtype=torch.int32, device=dev),
            ))
            sx, rows, n0 = bufs
            # the operand padded to cap + 1 rows, written in place
            self._write_rows(sx, x)
            rows.fill_(cap)
            rows[:n] = torch.arange(n, device=dev) if order is None else order
            n0.fill_(n)
            # the one transfer back to the host, after the loop: every
            # result as int32 words in one buffer (g_final by its bits)
            return self._execute(key, self._program, bufs).cpu().numpy()

        words = launch_wave("device", wave)
        dec, ex = words[:n], words[cap : cap + n].astype(np.int64)
        g = words[2 * cap : 2 * cap + n].view(np.float32)
        n_f, n_in_log = int(words[3 * cap]), words[3 * cap + 1 :]
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

    def _stream_state(self, cap: int, R: int, x) -> _StreamState:
        """New buffers of the streaming program for ``cap`` lanes and a
        ring of ``R`` rows of ``x``'s width and dtype."""
        dev, i32 = self.device, torch.int32

        def ints(*shape):
            return torch.empty(shape, dtype=i32, device=dev)

        return _StreamState(
            x=torch.empty((R + 1, *x.shape[1:]), dtype=x.dtype, device=dev),
            arr=ints(R), n=ints(),
            rows=torch.empty(cap, dtype=torch.int64, device=dev), stage=ints(cap),
            g=torch.empty(cap, dtype=torch.float32, device=dev),
            n_live=ints(), head=ints(), steps_run=ints(), step=ints(),
            dec=torch.empty(R + 1, dtype=torch.bool, device=dev), ex=ints(R + 1),
            gout=torch.empty(R + 1, dtype=torch.float32, device=dev),
            admit=ints(R + 1), done=ints(R + 1), probe=ints(2),
            state=self.scorer.init_state(cap, dev),
        )

    def _stream_reset(self, st: _StreamState, x, n: int, arr: np.ndarray) -> None:
        """Write a run's inputs and the loop's initial state into ``st``:
        the ring's rows (then zero rows, the last the trash row), the
        arrival steps (int32 max past the ``n`` rows: never arrived), empty
        lanes, zero counters and result buffers."""
        self._write_rows(st.x, x)
        st.arr[:n].copy_(torch.from_numpy(arr.astype(np.int32)))
        st.arr[n:].fill_(np.iinfo(np.int32).max)
        st.n.fill_(n)
        st.rows.fill_(st.arr.shape[0])
        st.ex.fill_(self.dplan.plan.T)
        for t in (st.stage, st.g, st.n_live, st.head, st.steps_run, st.step, st.dec,
                  st.gout, st.admit, st.done, *st.state.values()):
            t.zero_()

    def _stream_burst(self, st: _StreamState) -> None:
        """``STREAM_BURST`` steps of the admission-ring loop, in place on
        the loop state ``st`` (see ``_StreamState``).  Nothing here syncs
        with the host."""
        x, arr, n, step, steps_run = st.x, st.arr, st.n, st.step, st.steps_run
        dec, ex, gout, admit, done = st.dec, st.ex, st.gout, st.admit, st.done
        dp, dev = self.dplan, self.device
        S, T = dp.S, dp.plan.T
        R = x.shape[0] - 1  # ring size == output size; R = trash id
        cap = st.rows.shape[0]
        lane = torch.arange(cap, device=dev)
        lanes, stages, gl, live, hd = st.rows, st.stage, st.g, st.n_live, st.head
        state = st.state
        for _ in range(STREAM_BURST):
            # the reference's loop condition, on the device: live lanes or
            # a non-empty ring.  Once false it stays false, and the step
            # below is inert.
            steps_run += (n - hd + live).clamp_(max=1)
            # admission refill: the free lanes at the back of the
            # front-packed buffer take the next rows of the ring whose
            # arrival step has come, at stage 0.  A free lane already holds
            # stage 0 and g 0 (the repack zeroes it), and ring slot j holds
            # row j, so a new lane's row id is head + its offset past the
            # live lanes.
            arrived = torch.searchsorted(arr, step.reshape(1), right=True, out_int32=True)[0]
            k = torch.minimum(cap - live, arrived - hd)
            off = lane - live
            is_new = (off >= 0) & (off < k)
            lanes = torch.where(is_new, off + hd, lanes)
            admit[torch.where(is_new, lanes, R)] = step
            live = live + k
            hd = hd + k
            # the mixed-stage step: each lane at its own stage
            stop = stages >= S - 1  # lanes running their last stage
            t0_lane = self._stage_t0[stages]
            if self.megakernel:
                g_new, active, dpos, ex_rel, pack, n_keep = mk.mega_lane(
                    self.scorer.slabs, x, lanes, gl, stages, stop, live,
                    self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
                )
            else:
                # B6 reads each lane's threshold rows and column mask at
                # its stage, and packs the survivors (a stage further on).
                # Rookies sit at stage 0, where a stateful scorer takes
                # their state from the operand, so the zeroed slots the
                # repack leaves are never read as state
                scores, state_new = self.scorer.lane_stage(state, t0_lane, lanes, x, live)
                g_new, active, dpos, ex_rel, pack, n_keep = cascade_lane_step(
                    gl, scores.contiguous(), stages, self._eps_pos, self._eps_neg,
                    self._col_valid, n_valid=live, block_n=self.block_n,
                )
            # B6 and B7 start lanes past n_live inactive, so only live
            # lanes exit (ex_rel > 0) or run out (still active at their
            # last stage: decided by the full score, as the batch path's
            # epilogue does)
            newly = ex_rel > 0
            fin = newly | (active.bool() & stop)
            scat = torch.where(fin, lanes, R)
            dec[scat] = torch.where(newly, dpos.bool(), g_new >= self._beta)
            ex[scat] = torch.where(newly, ex_rel + t0_lane, T)
            gout[scat] = g_new
            done[scat] = step
            # repack: survivors to the front, freed lanes to (R, 0, 0.0)
            pack = pack.long()
            lanes = _repack(lanes, pack, R)
            stages = _repack(stages + 1, pack, 0)
            gl = _repack(g_new, pack, 0.0)
            if state:
                state = repack_state(state_new, pack)
            live = n_keep
            step += 1
        for name, buf in st.state.items():
            buf.copy_(state[name])
        st.rows.copy_(lanes)
        st.stage.copy_(stages)
        st.g.copy_(gl)
        st.n_live.copy_(live)
        st.head.copy_(hd)
        st.probe.copy_(torch.stack([live, hd]))

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
        server's waves share one buffer geometry (one program, one graph on
        the card).  ``prepared=True`` means ``batch`` is already the
        scorer-prepared operand.
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
        if self.check_finite:
            check_batch_finite(batch, n)
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        key = ("stream", cap, R, tuple(x.shape[1:]), x.dtype)

        def wave():
            (st,) = self._buffers(key, lambda: (self._stream_state(cap, R, x),))
            self._stream_reset(st, x, n, arr)
            # the loop runs at least until the last arrival's step: no sync
            # before
            bursts = -(-max(STREAM_BURST, int(arr[-1]) + 1) // STREAM_BURST)
            enqueued = syncs = 0
            while True:
                for _ in range(bursts):
                    self._execute(key, self._stream_burst, (st,))
                enqueued += bursts * STREAM_BURST
                live, taken = st.probe.tolist()
                syncs += 1
                if live == 0 and taken == n:
                    break
                bursts = 1
            # the one transfer of the results, after the loop
            words = torch.cat(
                [st.steps_run[None], st.dec[:n].to(torch.int32), st.ex[:n],
                 st.gout[:n].view(torch.int32), st.admit[:n], st.done[:n]]
            ).cpu().numpy()
            return words, enqueued, syncs

        words, enqueued, syncs = launch_wave("device", wave)
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

    # -- grouped (ranking) decide: one verdict per query group ----------

    def _cap_groups(self, n_groups: int, capacity_groups: int | None) -> int:
        bg = DEFAULT_BLOCK_G
        n = max(n_groups, capacity_groups or 0, 1)
        return -(-n // bg) * bg

    def _grouped_program(self, k: int, x, gids, rows2d, valid2d, n0, eps_g):
        """The grouped stage loop (see the module docstring).  ``gids``
        (cap_g,) are the slots' group ids (trash ``cap_g`` past the
        groups), ``rows2d``/``valid2d`` (cap_g, B) their documents' rows
        into ``x`` and real-lane masks, ``n0`` (an int32 scalar on the
        device) the live group count.  A stateful scorer's state starts
        empty and rides the whole-group compaction at lane granularity.
        Returns one int32 buffer: the
        (cap_g, k) verdicts, the exit stages and the margins' bits (cap_g
        each), the final live count and the (S,) live counts entering each
        stage.  Nothing here syncs with the host."""
        dp, dev = self.dplan, self.device
        S, W = dp.S, dp.W
        cap_g, B = rows2d.shape
        L = cap_g * B
        i32 = torch.int32
        grp = torch.arange(cap_g, device=dev)
        n_active = n0
        g2d = torch.zeros(cap_g, B, dtype=torch.float32, device=dev)
        verd = torch.full((cap_g + 1, k), -1, dtype=i32, device=dev)
        exst = torch.full((cap_g + 1,), S, dtype=i32, device=dev)
        marg = torch.full((cap_g + 1,), float("inf"), dtype=torch.float32, device=dev)
        n_in_log = torch.zeros(S, dtype=i32, device=dev)
        # the stage's scalar threshold for every group slot, one row a stage
        eps_b = eps_g[:, None].expand(S, cap_g).contiguous()
        state: dict = {}

        for s in range(S):
            n_in_log[s] = n_active
            t0 = int(dp.stage_t0[s])
            # live groups are front-packed, so live lanes are the first
            # n_active * B: a blocked scorer skips the rest
            scores, state_new = self.scorer.stage(
                state, t0, t0 + W, rows2d.reshape(L), x, n_active * B
            )
            scores = torch.where(self._col_valid[s][None, :], scores, 0.0)
            scores = torch.where(valid2d.reshape(L, 1) != 0, scores, 0.0)
            # per-column sequential accumulate: the host oracle's f32 adds
            g_flat = g2d.reshape(L)
            for j in range(W):
                g_flat = g_flat + scores[:, j]
            g_new = g_flat.reshape(cap_g, B)
            # B8 decides and picks each group's top k (live-gated exits)
            margin, exit_g, verdict = cascade_group_kernel(
                g_new, valid2d, eps_b[s], k, n_live=n_active, rows=rows2d
            )
            exit_b = exit_g.bool()
            scat = torch.where(exit_b, gids, cap_g)
            verd[scat] = verdict
            exst.index_fill_(0, scat, s + 1)
            marg[scat] = margin
            # whole-group compaction: survivors keep their B-lane rectangle
            keep = (grp < n_active) & ~exit_b
            pack = torch.where(keep, torch.cumsum(keep, dim=0) - 1, cap_g)
            gids = _repack(gids, pack, cap_g)
            rows2d = _repack(rows2d, pack, 0)
            valid2d = _repack(valid2d, pack, 0)
            g2d = _repack(g_new, pack, 0.0)
            if state_new:
                state = repack_state(state_new, _lane_pack(pack, B))
            n_active = keep.sum(dtype=i32)
        # ran-out groups carry the full cascade's ranking; B8 at eps = +inf
        # gives their margins and picks
        inf = torch.full((cap_g,), float("inf"), dtype=torch.float32, device=dev)
        margin_f, _, verdict_f = cascade_group_kernel(
            g2d, valid2d, inf, k, n_live=n_active, rows=rows2d
        )
        scat = torch.where(grp < n_active, gids, cap_g)
        verd[scat] = verdict_f
        exst.index_fill_(0, scat, S)
        marg[scat] = margin_f
        return torch.cat([
            verd[:cap_g].reshape(-1), exst[:cap_g], marg[:cap_g].view(i32),
            n_active[None], n_in_log,
        ])

    def run_grouped(
        self,
        batch,
        group_rows,
        group_valid,
        n_groups: int,
        eps_g,
        k: int,
        capacity_groups: int | None = None,
        prepared: bool = False,
        capacity_rows: int | None = None,
    ) -> GroupedResult:
        """Execute the grouped cascade for ``n_groups`` bucket-laid-out
        query groups on the device.

        ``group_rows`` (G, B) holds each group's flat GLOBAL document rows
        into ``batch`` (padding lanes in range but masked), ``group_valid``
        (G, B) the real-lane mask, ``eps_g`` (S,) the per-stage margin
        thresholds, ``k`` the ranking depth.  One bucket width B per call:
        ragged widths go through the bucketing layer, one run (one program)
        per bucket shape.  ``capacity_groups`` pins the group-slot capacity
        across flushes.  The prepared operand is padded to ``max(rows,
        capacity_rows)`` rows rounded up to a power of two, so flushes with
        other document counts share the program.  ``batch`` is what
        the scorer's ``prepare`` consumes (for the matrix scorer, the
        cascade-ordered score matrix), or with ``prepared=True`` its output
        already.
        """
        T = self.dplan.plan.T
        S = self.dplan.S
        group_rows = np.asarray(group_rows, dtype=np.int64)
        group_valid = np.asarray(group_valid)
        if group_rows.ndim != 2 or group_rows.shape != group_valid.shape:
            raise ValueError(
                f"group_rows/group_valid must be matching (G, B) arrays, "
                f"got {group_rows.shape} / {group_valid.shape}"
            )
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        eps_g = np.asarray(eps_g, dtype=np.float32)
        if eps_g.shape != (S,):
            raise ValueError(f"eps_g has shape {eps_g.shape}, expected ({S},)")
        if n_groups == 0:
            return GroupedResult(
                verdicts=np.zeros((0, k), dtype=np.int32),
                exit_stage=np.zeros(0, dtype=np.int64),
                margin=np.zeros(0, dtype=np.float32),
                chunk_stats=[],
                scores_computed=0,
                scores_possible=0,
            )
        if self.check_finite:
            check_batch_finite(batch, batch.shape[0])
        n_docs = int((group_valid[:n_groups] != 0).sum())
        B = group_rows.shape[1]
        k = int(k)
        cap_g = self._cap_groups(n_groups, capacity_groups)
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        # slots past the groups: trash id, row 0 (in range), no valid lane
        gids = np.full(cap_g, cap_g, dtype=np.int64)
        gids[:n_groups] = np.arange(n_groups)
        rows_init = np.zeros((cap_g, B), dtype=np.int64)
        rows_init[:n_groups] = group_rows[:n_groups]
        valid_init = np.zeros((cap_g, B), dtype=np.int32)
        valid_init[:n_groups] = group_valid[:n_groups] != 0
        dev = self.device
        cap_x = 1 << (max(x.shape[0], capacity_rows or 0, 1) - 1).bit_length()
        key = ("grouped", k, cap_g, B, cap_x, tuple(x.shape[1:]), x.dtype)

        def wave():
            bufs = self._buffers(key, lambda: (
                torch.empty((cap_x, *x.shape[1:]), dtype=x.dtype, device=dev),
                torch.empty(cap_g, dtype=torch.int64, device=dev),
                torch.empty((cap_g, B), dtype=torch.int64, device=dev),
                torch.empty((cap_g, B), dtype=torch.int32, device=dev),
                torch.empty((), dtype=torch.int32, device=dev),
                torch.empty(S, dtype=torch.float32, device=dev),
            ))
            sx, gids_b, rows_b, valid_b, n0, eps_b = bufs
            # the operand padded to cap_x rows, written in place
            self._write_rows(sx, x)
            for buf, host in ((gids_b, gids), (rows_b, rows_init), (valid_b, valid_init),
                              (eps_b, eps_g)):
                buf.copy_(torch.from_numpy(host))
            n0.fill_(n_groups)
            # the one transfer back to the host, after the loop
            return self._execute(
                key, functools.partial(self._grouped_program, k), bufs
            ).cpu().numpy()

        words = launch_wave("device", wave)
        G, Ck = n_groups, cap_g * k
        verd = words[:Ck].reshape(cap_g, k)[:G]
        exst, marg = words[Ck : Ck + G], words[Ck + cap_g : Ck + cap_g + G]
        n_f, n_in_log = int(words[Ck + 2 * cap_g]), words[Ck + 2 * cap_g + 1 :]
        s_f = int((n_in_log > 0).sum())
        stages = self.dplan.plan.stages
        bn, W = self._bn_bill(), self.dplan.W
        chunk_stats = []
        for s in range(s_f):
            n_in = int(n_in_log[s])
            n_next = int(n_in_log[s + 1]) if s + 1 < s_f else n_f
            # group-quantized block billing: a stage scores the full B-lane
            # rectangle of every live group, block-guarded
            chunk_stats.append(
                ChunkStat(
                    t0=stages[s][0],
                    t1=stages[s][1],
                    n_in=n_in,
                    n_exited=n_in - n_next,
                    scores_computed=-(-(n_in * B) // bn) * bn * W,
                )
            )
        return GroupedResult(
            verdicts=verd.astype(np.int32),
            exit_stage=exst.astype(np.int64),
            margin=marg.view(np.float32),
            chunk_stats=chunk_stats,
            scores_computed=sum(c.scores_computed for c in chunk_stats),
            scores_possible=n_docs * T,
        )

    # -- grouped streaming: the admission ring at group-slot granularity --

    def _grouped_stream_state(self, cap_g, Rg, B, k, cap_x, x) -> _GroupedStreamState:
        """New buffers of the grouped streaming program: ``cap_g`` slots
        of ``B`` lanes, a ring of ``Rg`` groups, depth ``k``, ``cap_x``
        operand rows of ``x``'s width and dtype."""
        dev, i32, i64, f32 = self.device, torch.int32, torch.int64, torch.float32

        def ints(*shape, dtype=i32):
            return torch.empty(shape, dtype=dtype, device=dev)

        return _GroupedStreamState(
            x=torch.empty((cap_x, *x.shape[1:]), dtype=x.dtype, device=dev),
            ring_rows=ints(Rg, B, dtype=i64), ring_valid=ints(Rg, B), arr=ints(Rg),
            n=ints(), eps=torch.empty(self.dplan.S, dtype=f32, device=dev),
            gids=ints(cap_g, dtype=i64), rows=ints(cap_g, B, dtype=i64),
            valid=ints(cap_g, B), stage=ints(cap_g),
            g=torch.empty((cap_g, B), dtype=f32, device=dev),
            n_live=ints(), head=ints(), steps_run=ints(), step=ints(),
            verd=ints(Rg + 1, k), exst=ints(Rg + 1),
            marg=torch.empty(Rg + 1, dtype=f32, device=dev),
            admit=ints(Rg + 1), done=ints(Rg + 1), probe=ints(2),
            state=self.scorer.init_state(cap_g * B, dev),
        )

    def _grouped_stream_reset(self, st, x, rows, valid, n, arr, eps_g) -> None:
        """Write a run's inputs and the loop's initial state into ``st``:
        the operand (zero rows past it), the ring's groups (then row 0, no
        valid lane), the arrivals (int32 max past the ``n`` groups: never
        arrived), empty slots (trash id, row 0, stage 0, g 0), zero
        counters, and the reference's initial results (no picks, exit stage
        S, margin +inf)."""
        self._write_rows(st.x, x)
        Rg = st.arr.shape[0]
        ring_rows = np.zeros(st.ring_rows.shape, dtype=np.int64)
        ring_rows[:n] = rows[:n]
        ring_valid = np.zeros(st.ring_valid.shape, dtype=np.int32)
        ring_valid[:n] = valid[:n] != 0
        arr_pad = np.full(Rg, np.iinfo(np.int32).max, dtype=np.int32)
        arr_pad[:n] = arr
        for buf, host in ((st.ring_rows, ring_rows), (st.ring_valid, ring_valid),
                          (st.arr, arr_pad), (st.eps, eps_g)):
            buf.copy_(torch.from_numpy(host))
        st.n.fill_(n)
        st.gids.fill_(Rg)
        st.verd.fill_(-1)
        st.exst.fill_(self.dplan.S)
        st.marg.fill_(float("inf"))
        for t in (st.rows, st.valid, st.stage, st.g, st.n_live, st.head, st.steps_run,
                  st.step, st.admit, st.done, *st.state.values()):
            t.zero_()

    def _grouped_stream_burst(self, k: int, st: _GroupedStreamState) -> None:
        """``STREAM_BURST`` steps of the grouped admission ring, in place on
        ``st`` (see ``_GroupedStreamState``), each the reference's loop body
        (``_grouped_stream_program``) step for step.  Nothing here syncs
        with the host."""
        x, arr, n, step, steps_run = st.x, st.arr, st.n, st.step, st.steps_run
        verd, exst, marg, admit, done = st.verd, st.exst, st.marg, st.admit, st.done
        dp, dev = self.dplan, self.device
        S, W = dp.S, dp.W
        Rg = arr.shape[0]  # ring size == output size; Rg = trash id
        cap_g, B = st.rows.shape
        L = cap_g * B
        i32 = torch.int32
        slot = torch.arange(cap_g, device=dev)
        gids, rows2d, valid2d, stage, g2d = st.gids, st.rows, st.valid, st.stage, st.g
        live, hd = st.n_live, st.head
        state = st.state
        for _ in range(STREAM_BURST):
            # the reference's loop condition, on the device (see
            # _stream_burst): once false it stays false, and the step is inert
            steps_run += (n - hd + live).clamp_(max=1)
            # refill: the free slots at the back take the next groups of the
            # ring whose arrival step has come, at stage 0 with g 0 (a free
            # slot already holds both: the repack zeroes it); ring slot j
            # holds group j, so a new slot's group id is head + its offset
            arrived = torch.searchsorted(arr, step.reshape(1), right=True, out_int32=True)[0]
            kadm = torch.minimum(cap_g - live, arrived - hd)
            off = slot - live
            is_new = (off >= 0) & (off < kadm)
            src = (off + hd).clamp_(0, Rg - 1)
            gids = torch.where(is_new, src, gids)
            rows2d = torch.where(is_new[:, None], st.ring_rows[src], rows2d)
            valid2d = torch.where(is_new[:, None], st.ring_valid[src], valid2d)
            admit[torch.where(is_new, gids, Rg)] = step
            live = live + kadm
            hd = hd + kadm
            # mixed-stage scoring: each slot's stage over its B lanes, the
            # padded columns and the padding lanes masked
            stop = stage >= S - 1
            t0_lane = self._stage_t0[stage][:, None].expand(cap_g, B).reshape(L)
            scores, state_new = self.scorer.lane_stage(
                state, t0_lane, rows2d.reshape(L), x, live * B
            )
            colmask = self._col_valid[stage][:, None, :].expand(cap_g, B, W).reshape(L, W)
            scores = torch.where(colmask, scores, 0.0)
            scores = torch.where(valid2d.reshape(L, 1) != 0, scores, 0.0)
            # per-column sequential accumulate: the host oracle's f32 adds
            g_flat = g2d.reshape(L)
            for j in range(W):
                g_flat = g_flat + scores[:, j]
            g_new = g_flat.reshape(cap_g, B)
            # B8 at each slot's own stage threshold, with the picks
            margin, exit_g, verdict = cascade_group_kernel(
                g_new, valid2d, st.eps[stage], k, n_live=live, rows=rows2d
            )
            exit_b = exit_g.bool()
            slot_live = slot < live
            fin = (slot_live & exit_b) | (slot_live & ~exit_b & stop)
            scat = torch.where(fin, gids, Rg)
            verd[scat] = verdict
            exst[scat] = torch.where(exit_b, stage + 1, S)
            marg[scat] = margin
            done[scat] = step
            # whole-group repack: survivors to the front a stage further
            # on, freed slots to (Rg, row 0, no valid lane, stage 0, g 0)
            keep = slot_live & ~exit_b & ~stop
            pack = torch.where(keep, torch.cumsum(keep, dim=0) - 1, cap_g)
            gids = _repack(gids, pack, Rg)
            rows2d = _repack(rows2d, pack, 0)
            valid2d = _repack(valid2d, pack, 0)
            stage = _repack(stage + 1, pack, 0)
            g2d = _repack(g_new, pack, 0.0)
            if state:
                state = repack_state(state_new, _lane_pack(pack, B))
            live = keep.sum(dtype=i32)
            step += 1
        for name, buf in st.state.items():
            buf.copy_(state[name])
        st.gids.copy_(gids)
        st.rows.copy_(rows2d)
        st.valid.copy_(valid2d)
        st.stage.copy_(stage)
        st.g.copy_(g2d)
        st.n_live.copy_(live)
        st.head.copy_(hd)
        st.probe.copy_(torch.stack([live, hd]))

    def run_stream_grouped(
        self,
        batch,
        group_rows,
        group_valid,
        n_groups: int,
        eps_g,
        k: int,
        arrivals=None,
        capacity_groups: int | None = None,
        ring_capacity: int | None = None,
        prepared: bool = False,
        capacity_rows: int | None = None,
    ) -> GroupedStreamResult:
        """Continuously stream query groups through group-slot buffers.

        The grouped analogue of ``run_stream``: groups wait in an
        arrival-order admission ring and refill freed GROUP slots (B lanes
        each) mid-cascade; per-slot stage indices mix rookies with
        veterans, each decided by its own stage's margin threshold through
        B8, as the batch path's.  One bucket width B per run.
        ``arrivals`` ((n_groups,) nondecreasing ints, None = all waiting)
        gates admission, ``capacity_groups`` pins the slot count
        (default: every group at once) and ``ring_capacity`` the ring size
        (default ``n_groups``), so a server's waves share one program.  As
        in ``run_grouped``, the prepared operand is padded to ``max(rows,
        capacity_rows)`` rows rounded up to a power of two.  The scorer
        needs a ``lane_fn``.
        """
        T, S = self.dplan.plan.T, self.dplan.S
        if not self.scorer.has_lanes:
            raise ValueError(
                "run_stream_grouped needs a scorer with per-lane stage scoring (lane_fn)"
            )
        group_rows = np.asarray(group_rows, dtype=np.int64)
        group_valid = np.asarray(group_valid)
        if group_rows.ndim != 2 or group_rows.shape != group_valid.shape:
            raise ValueError(
                f"group_rows/group_valid must be matching (G, B) arrays, "
                f"got {group_rows.shape} / {group_valid.shape}"
            )
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        eps_g = np.asarray(eps_g, dtype=np.float32)
        if eps_g.shape != (S,):
            raise ValueError(f"eps_g has shape {eps_g.shape}, expected ({S},)")
        if n_groups == 0:
            return GroupedStreamResult(
                verdicts=np.zeros((0, k), dtype=np.int32),
                exit_stage=np.zeros(0, dtype=np.int64),
                margin=np.zeros(0, dtype=np.float32),
                admit_step=np.zeros(0, dtype=np.int64),
                done_step=np.zeros(0, dtype=np.int64),
                steps_run=0,
                occupancy=np.zeros(0, dtype=np.int64),
                capacity_groups=self._cap_groups(1, capacity_groups),
                scores_computed=0,
                scores_possible=0,
            )
        arr = (
            np.zeros(n_groups, dtype=np.int64)
            if arrivals is None
            else np.asarray(arrivals, dtype=np.int64)
        )
        if arr.shape != (n_groups,):
            raise ValueError(f"arrivals has shape {arr.shape}, expected ({n_groups},)")
        if (np.diff(arr) < 0).any():
            raise ValueError("arrivals must be nondecreasing")
        if self.check_finite:
            check_batch_finite(batch, batch.shape[0])
        n_docs = int((group_valid[:n_groups] != 0).sum())
        B = group_rows.shape[1]
        k = int(k)
        # the reference's slot count: the pinned capacity when given (it may
        # be below n_groups: slots then refill mid-cascade), else every group
        cap_g = self._cap_groups(capacity_groups or n_groups, capacity_groups)
        Rg = max(n_groups, int(ring_capacity or n_groups))
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        cap_x = 1 << (max(x.shape[0], capacity_rows or 0, 1) - 1).bit_length()
        key = ("grouped_stream", k, cap_g, Rg, B, cap_x, tuple(x.shape[1:]), x.dtype)
        G = n_groups

        def wave():
            (st,) = self._buffers(
                key, lambda: (self._grouped_stream_state(cap_g, Rg, B, k, cap_x, x),)
            )
            self._grouped_stream_reset(st, x, group_rows, group_valid, n_groups, arr, eps_g)
            burst = functools.partial(self._grouped_stream_burst, k)
            # the loop runs at least until the last arrival's step: no sync
            # before
            bursts = -(-max(STREAM_BURST, int(arr[-1]) + 1) // STREAM_BURST)
            enqueued = syncs = 0
            while True:
                for _ in range(bursts):
                    self._execute(key, burst, (st,))
                enqueued += bursts * STREAM_BURST
                live, taken = st.probe.tolist()
                syncs += 1
                if live == 0 and taken == n_groups:
                    break
                bursts = 1
            # the one transfer of the results, after the loop
            words = torch.cat([
                st.steps_run[None], st.verd[:G].reshape(-1), st.exst[:G],
                st.marg[:G].view(torch.int32), st.admit[:G], st.done[:G],
            ]).cpu().numpy()
            return words, enqueued, syncs

        words, enqueued, syncs = launch_wave("device", wave)
        steps_run = int(words[0])
        verd = words[1 : 1 + G * k].reshape(G, k)
        exst, marg, admit, done = np.split(words[1 + G * k :], 4)
        admit, done = admit.astype(np.int64), done.astype(np.int64)
        occ = stream_occupancy(admit, done, steps_run)
        # group-quantized block billing per loop step: live group slots
        # score their full B-lane rectangles, block-guarded
        bn, W = self._bn_bill(), self.dplan.W
        return GroupedStreamResult(
            verdicts=verd.astype(np.int32),
            exit_stage=exst.astype(np.int64),
            margin=marg.view(np.float32),
            admit_step=admit,
            done_step=done,
            steps_run=steps_run,
            occupancy=occ,
            capacity_groups=cap_g,
            scores_computed=int(((-(-(occ * B) // bn)) * bn * W).sum()),
            scores_possible=n_docs * T,
            steps_enqueued=enqueued,
            syncs=syncs + 1,
        )
