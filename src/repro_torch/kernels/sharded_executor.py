"""Sharded cascade executor: the device stage loops over D x M logical
shards of one card, the counterpart of ``repro.kernels.sharded_executor``.

The reference splits the batch over a mesh's ``"data"`` axis with
``shard_map``: each XLA device runs the single-device loop over its own
survivor buffers, and collectives join them.  Here the D shards are a
leading axis on the executor's buffers, every shard's kernels are launched
on the same card, and the collectives become reductions over that axis:

* **Per-shard survivor buffers.**  The batch is split into D contiguous
  slices of the (possibly sorted) row order.  Shard k holds its rows' ids
  in ``rows[k]`` (cap_l lanes, survivors front-packed) and their partial
  sums lane by lane in ``g[k]``; its live count is ``n_active[k]``, a 0-d
  view into a (D,) int32 tensor that every kernel reads as its
  ``n_valid``.  The operand stays global (cap_g + 1 rows, cap_g = D x cap_l,
  the last the trash row): only ids, partial sums and a stateful scorer's
  state move.  Each stage launches the stage kernel(s) once per shard, on
  views of the buffers; the decide's bookkeeping (exit scatters, the
  repack) runs once over all shards.
* **The census.**  The reference's ``psum`` of the live counts and its
  per-stage ``all_gather`` are the (D,) count tensor itself.  As in
  ``DeviceExecutor`` every stage is enqueued and nothing reads back inside
  a loop, so each loop is captured as one CUDA graph a program key; a
  stage past the quit costs its launches and no work.
* **Survivor rebalancing** (``rebalance=True``): after each stage the
  trigger (live rows left, the fullest shard a whole block over the
  balanced share, and the skew past ``rebalance_ratio``) is computed on the
  device, and the stable shard-major global repack with its even re-split
  (``base + (k < rem)``) is selected with ``torch.where``, where the
  reference branches with ``lax.cond``.  State buffers migrate with their
  rows; ``rebalanced_stages`` logs the stages that fired.
* **Exactly-once results.**  Exits scatter by global row id into shared
  (cap_g + 1,) outputs (trash slot cap_g): a row lives on one shard at a
  time, so, unlike the reference, no sum over shards assembles them.

**The model axis** (a ``("data", "model")`` mesh with M > 1, batch
``run`` only).  Every stage's slab is split into M contiguous column
slices of ``w_local = ceil(W / M)`` columns (the scorer's
``model_partition`` hook, ``launch.shardings``); model shard j of data
shard k scores only columns [t0 + j * w_local, + w_local) of stage s over
shard k's rows, each block is zero-padded to ``w_global = M * w_local``
columns, and the M blocks are summed (the reference's one ``psum`` over
``"model"``) and cut to W.  Downstream of the sum (B2's step form, the
exit scatters, the repack, the census, the rebalance) everything is the
data axis's, run once a data shard where the reference replicates it over
the model shards.  A stage bills ``w_global`` columns.  The fused stage
step, stateful scorers, scorers without the hook and M > W are refused,
as are streaming and grouped runs; with M = 1 the 1-D program runs as it
was (results, bill, launches and ``traces``).

Streaming (``run_stream``) deals the pending rows round robin (request i
waits in shard ``i % D``'s ring, each ring's trash id ``R_g``) and ends when
pending plus live rows, summed over the shards, reach zero, read once a
burst as in ``DeviceExecutor``.  Grouped ranking (``run_grouped``) splits
the groups contiguously over the shards as whole units.  With one shard
every loop gives ``DeviceExecutor``'s results, billing and ``traces``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.executor import CascadePlan, ChunkStat, ExecutorResult
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.cascade_kernel import (
    DEFAULT_BLOCK_G,
    cascade_chunk_step,
    cascade_group_kernel,
    cascade_lane_step,
)
from repro_torch.kernels.device_executor import (
    DEFAULT_BLOCK_N,
    STREAM_BURST,
    BoundScorer,
    DevicePlan,
    GroupedResult,
    StreamResult,
    _DeviceLoops,
    _lane_pack,
    _StreamState,
    check_batch_finite,
    launch_wave,
    repack_state,
    stream_occupancy,
)
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, ServingMesh
from repro_torch.launch.shardings import model_stacked_shards, split_columns

__all__ = ["ShardedDeviceExecutor", "critical_blocks"]


def critical_blocks(per_shard_n_in: np.ndarray, block_n: int) -> int:
    """Sharded latency proxy over a ``last_run_info["per_shard_n_in"]``
    (shards, stages) occupancy log: a stage is as slow as its fullest
    shard, so sum the per-stage max over shards of live kernel row-blocks.
    Shared by the billing gate and the tests."""
    occ = np.asarray(per_shard_n_in)
    if occ.size == 0:
        return 0
    return int(sum((-(-occ[:, s] // block_n)).max() for s in range(occ.shape[1])))


def _repack_shards(buf: torch.Tensor, pack: torch.Tensor, fill) -> torch.Tensor:
    """Per-shard compaction: ``buf`` (D, cap, ...) lanes and ``pack`` (D,
    cap) int64 local destinations (``cap`` for a dropped lane) -> (D, cap +
    1, ...), each shard's survivors at the front of its slice, ``fill``
    past them.  Slot ``cap`` of each shard is its own trash slot, so one
    shard's dropped lanes never land in its neighbour's slice; its content
    is undefined."""
    D, cap = pack.shape
    tail = buf.shape[2:]
    out = torch.full((D, cap + 1, *tail), fill, dtype=buf.dtype, device=buf.device)
    idx = pack.view(D, cap, *(1,) * len(tail)).expand(buf.shape)
    return out.scatter_(1, idx, buf)


def _stack(parts: list) -> torch.Tensor:
    """The shards' (cap, ...) outputs as one (D, cap, ...) tensor (a view
    for one shard)."""
    return parts[0][None] if len(parts) == 1 else torch.stack(parts)


class ShardedDeviceExecutor(_DeviceLoops):
    """Runs a ``CascadePlan`` over ``mesh``'s ``"data"`` shards, and with a
    ``"model"`` axis over its column slices too (see the module docstring):
    ``DeviceExecutor``'s ``run``, ``run_stream`` and ``run_grouped``
    contracts with the batch split over the data shards.

    ``mesh`` is a ``launch.mesh.ServingMesh``; its device is the executor's.
    ``rebalance`` enables the skew-triggered survivor repack and
    ``rebalance_ratio`` is its skew trigger (the fullest shard over ratio x
    the balanced count).  ``megakernel``, ``capture`` and ``check_finite``
    are ``DeviceExecutor``'s; ``megakernel=None`` turns the fused step off
    on a model axis.  After every run the per-shard accounting lands in
    ``last_run_info`` (on a model axis also the per-coordinate counters).
    Every wave goes through ``launch_wave`` under the executor name
    ``"sharded"``.
    """

    def __init__(
        self,
        plan: CascadePlan | DevicePlan,
        scorer: BoundScorer,
        mesh: ServingMesh,
        block_n: int = DEFAULT_BLOCK_N,
        rebalance: bool = False,
        rebalance_ratio: float = 1.25,
        megakernel: bool | None = None,
        capture: bool = True,
        check_finite: bool = False,
    ):
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must carry a {DATA_AXIS!r} axis; got {mesh.axis_names}")
        model_shards = int(mesh.shape.get(MODEL_AXIS, 1))
        if megakernel is None and model_shards > 1:
            # the fused stage step has no model-axis sum, so auto turns it off
            megakernel = False
        super().__init__(
            plan, scorer, block_n=block_n, megakernel=megakernel, device=mesh.device,
            capture=capture, check_finite=check_finite,
        )
        self.mesh = mesh
        self.shards = int(mesh.shape[DATA_AXIS])
        self.model_shards = model_shards
        self.rebalance = bool(rebalance)
        self.rebalance_ratio = float(rebalance_ratio)
        self.last_run_info: dict | None = None
        if model_shards > 1:
            self._check_model_axis()
            self._w_local, self._w_global = split_columns(self.dplan.W, model_shards)
            mparams, self._col_fn = scorer.model_partition(model_shards)
            # one contiguous slab slice a model shard, made once
            self._mparams = model_stacked_shards(mparams, mesh)

    def _mesh_desc(self) -> str:
        return f"{self.shards}x{self.model_shards} ({DATA_AXIS!r}, {MODEL_AXIS!r}) mesh"

    def _check_model_axis(self) -> None:
        """The reference's refusals on a model axis."""
        desc = self._mesh_desc()
        if self.megakernel:
            raise ValueError(
                f"megakernel=True is unavailable on a {desc}: the fused stage step "
                "has no model-axis psum seam.  Use the multi-kernel path "
                "(megakernel=None/False) or model_shards=1."
            )
        if self.scorer.stateful:
            raise ValueError(
                f"a {desc} cannot carry a stateful scorer (non-empty state_spec): "
                "per-row state would need the model-axis collective the 2-D path "
                "reserves for the score psum.  Use model_shards=1."
            )
        if self.scorer.model_partition is None:
            raise ValueError(
                f"a {desc} needs a scorer with a model_partition hook (factory-built "
                "scorers carry one; custom scorers must split their stage slabs into "
                "contiguous column slices, see BoundScorer.model_partition)"
            )
        if self.model_shards > self.dplan.W:
            raise ValueError(
                f"{desc} has more model shards than the plan's stage width "
                f"W={self.dplan.W}: a stage slab splits into at most W contiguous "
                f"column slices (compile with model_shards <= {self.dplan.W})"
            )

    def _cap_local(self, n: int) -> int:
        """Per-shard buffer capacity: the balanced share, block-padded."""
        per = -(-max(n, 1) // self.shards)
        return -(-per // self.block_n) * self.block_n

    def _cap(self, n: int) -> int:
        """Global padded capacity (``shards`` x the per-shard capacity)."""
        return self.shards * self._cap_local(n)

    def _split(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(start, count) of each shard's contiguous slice of ``n`` items,
        the even split ``base + (k < rem)``."""
        base, rem = divmod(n, self.shards)
        cnt = base + (np.arange(self.shards) < rem)
        return np.cumsum(cnt) - cnt, cnt

    # -- the batch stage loop ---------------------------------------------

    def _shard_stage(self, s: int, t0: int, x, rows, g, n_live, state, lane):
        """Shard-local stage ``s`` -> ``(g_new, dpos, ex_rel, pack, n_keep,
        state)``: ``rows`` the shard's (cap_l,) row ids into ``x``, ``g`` its
        (cap_l + 1,) lane partial sums, ``n_live`` its live count (a 0-d view
        into the (D,) counts), ``lane`` the (cap_l,) lane indices."""
        if self.megakernel:
            # the matrix variant reads its rows of x in place
            in_place = self.scorer.slabs.variant == "matrix"
            g_new, _, dpos, ex_rel, pack, n_keep = mk.mega_stage(
                self.scorer.slabs, x if in_place else x[rows], g[:-1], s, t0, n_live,
                self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
                rows=rows if in_place else None,
            )
            return g_new, dpos, ex_rel, pack, n_keep, state
        if self.model_shards > 1:
            scores = self._model_sum(s, t0, x, rows, n_live)
        else:
            scores, state = self.scorer.stage(state, t0, t0 + self.dplan.W, rows, x, n_live)
        # B2's step form reads each lane's partial sum through its slot: the
        # lane's own, since the shard keeps g lane by lane
        g_new, _, dpos, ex_rel, pack, n_keep = cascade_chunk_step(
            g, lane, scores, s, self._eps_pos, self._eps_neg, self._col_valid,
            n_valid=n_live, block_n=self.block_n,
        )
        return g_new, dpos, ex_rel, pack, n_keep, state

    def _model_sum(self, s: int, t0: int, x, rows, n_live) -> torch.Tensor:
        """Stage ``s``'s (cap_l, W) scores for one data shard, over the model
        axis: each model shard j scores its ``w_local`` columns (from
        column ``t0 + j * w_local``) into a zero-padded (cap_l, w_global)
        f32 block, the M blocks are summed (the reference's one ``psum`` over
        ``"model"``, the stage step that ``per_coord_psums`` counts) and cut
        to the stage's W columns.  Columns past W are the next stage's
        models (or zero params past T): scored, then dropped here."""
        w_l, w_g = self._w_local, self._w_global
        blocks = []
        for j, mp in enumerate(self._mparams):
            c0 = j * w_l
            cols = self._col_fn(mp, x, rows, s, t0, c0, n_live).to(torch.float32)
            blocks.append(torch.nn.functional.pad(cols, (c0, w_g - c0 - w_l)))
        # every column is nonzero in at most one block, so the sum is exact;
        # a -0.0 score comes out +0.0, which moves no bit of g: g starts at
        # +0.0, and g + (+0.0) == g + (-0.0) for every g a stage can hold
        return torch.stack(blocks).sum(dim=0)[:, : self.dplan.W].contiguous()

    def _rebalance(self, rows, g, counts, states):
        """The skew-triggered repack, selected on the device -> ``(rows, g,
        n_active, states, fired)``.  The live lanes of every shard are
        packed globally (stable, shard-major) and re-split evenly, state
        buffers with their rows; ``fired`` (0-d int32) says whether the
        trigger held, and where it did not the buffers come back as they
        were."""
        D, cap = rows.shape
        cap_g = D * cap
        dev = rows.device
        lane = torch.arange(cap, device=dev)
        shard = torch.arange(D, device=dev)
        bn = self._bn_bill()
        total = counts.sum(dtype=torch.int32)
        top = counts.max()
        balanced = (total + D - 1) // D
        worth_a_block = (top + bn - 1) // bn > (balanced + bn - 1) // bn
        skewed = top.float() * D > self.rebalance_ratio * total.float()
        fired = (total > 0) & worth_a_block & skewed
        valid = (lane < counts[:, None]).reshape(cap_g)
        dest = torch.where(valid, torch.cumsum(valid, dim=0) - 1, cap_g)
        base, rem = total // D, total % D
        cnt = base + (shard < rem).to(torch.int32)
        start = shard * base + torch.minimum(shard, rem)
        src = torch.where(lane < cnt[:, None], start[:, None] + lane, cap_g)

        def migrate(buf, fill):
            """(D, cap, ...) lanes -> the same lanes repacked and re-split."""
            tail = buf.shape[2:]
            packed = torch.full((cap_g + 1, *tail), fill, dtype=buf.dtype, device=dev)
            packed.index_copy_(0, dest, buf.reshape(cap_g, *tail))
            return torch.where(fired, packed[src], buf)

        rows = migrate(rows, cap_g)
        g = torch.nn.functional.pad(migrate(g[:, :cap], 0.0), (0, 1))
        if states[0]:
            moved = {
                name: migrate(torch.stack([st[name] for st in states]), 0)
                for name in states[0]
            }
            states = [{name: v[k] for name, v in moved.items()} for k in range(D)]
        return rows, g, torch.where(fired, cnt, counts), states, fired.to(torch.int32)

    def _program(self, x, rows, n0):
        """The stage loop over the shards.  ``x`` has cap_g + 1 rows (the
        last is the trash row), ``rows`` (D, cap_l) int64 each shard's
        initial row ids (trash = cap_g), ``n0`` (D,) int32 their live
        counts.  Returns one int32 buffer: the decisions, exit steps and
        ``g``'s bits (cap_g each), the (D,) final live counts, the (D, S)
        live counts entering each stage and the (S,) rebalance log.
        Nothing here syncs with the host."""
        dp, dev = self.dplan, self.device
        S, T = dp.S, dp.plan.T
        D, cap = rows.shape
        cap_g = D * cap
        i32 = torch.int32
        lane = torch.arange(cap, device=dev)
        n_active = n0
        # partial sums lane by lane; slot cap of each shard is a trash slot
        g = torch.zeros(D, cap + 1, dtype=torch.float32, device=dev)
        dec = torch.zeros(cap_g + 1, dtype=torch.bool, device=dev)
        ex = torch.full((cap_g + 1,), T, dtype=i32, device=dev)
        gout = torch.zeros(cap_g + 1, dtype=torch.float32, device=dev)
        n_in_log = torch.zeros(D, S, dtype=i32, device=dev)
        reb_log = torch.zeros(S, dtype=i32, device=dev)
        states: list[dict] = [{} for _ in range(D)]
        for s in range(S):
            n_in_log[:, s] = n_active
            t0 = int(dp.stage_t0[s])
            outs = [
                self._shard_stage(s, t0, x, rows[k], g[k], n_active[k], states[k], lane)
                for k in range(D)
            ]
            g_new, dpos, ex_rel, pack = (_stack([o[i] for o in outs]) for i in range(4))
            # exits scatter once, by global row id; retired and padding
            # lanes aim at the trash slot
            scat = torch.where((lane < n_active[:, None]) & (ex_rel > 0), rows, cap_g)
            dec[scat] = dpos.bool()
            ex[scat] = ex_rel + t0
            gout[scat] = g_new
            pack = pack.long()
            rows = _repack_shards(rows, pack, cap_g)[:, :cap]
            g = _repack_shards(g_new, pack, 0.0)
            if outs[0][5]:
                # the state rides its shard's compaction (megakernel
                # scorers are stateless)
                states = [repack_state(o[5], pack[k]) for k, o in enumerate(outs)]
            n_active = _stack([o[4] for o in outs])
            if self.rebalance:
                rows, g, n_active, states, fired = self._rebalance(rows, g, n_active, states)
                reb_log[s] = fired
        # rows that never exited: classified by the full ensemble score
        scat = torch.where(lane < n_active[:, None], rows, cap_g)
        dec[scat] = g[:, :cap] >= self._beta
        gout[scat] = g[:, :cap]
        return torch.cat([
            dec[:cap_g].to(i32), ex[:cap_g], gout[:cap_g].view(i32), n_active,
            n_in_log.reshape(-1), reb_log,
        ])

    def run(
        self,
        batch,
        n: int,
        row_order=None,
        capacity: int | None = None,
        prepared: bool = False,
    ) -> ExecutorResult:
        """Execute the cascade for ``n`` rows, data-parallel over the shards.

        ``DeviceExecutor.run``'s contract: ``row_order`` is the initial
        order (split contiguously over the shards, so a sorted order keeps
        easy rows together, which is why the rebalance exists), ``capacity``
        pins the GLOBAL buffer size so flushes of other sizes share one
        program, ``prepared=True`` skips ``scorer.prepare``.
        """
        plan = self.dplan.plan
        T, S = plan.T, self.dplan.S
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
        D, M = self.shards, self.model_shards
        if capacity is not None and capacity < n:
            where = self._mesh_desc() if M > 1 else f"{D}-shard {DATA_AXIS!r} mesh"
            raise ValueError(
                f"capacity {capacity} cannot hold n={n} rows on a {where}: the flush "
                f"capacity pins the global buffer, split into {D} data-shard slices "
                f"block-padded to {self.block_n}; pass capacity >= n (or None to size "
                "from the batch)"
            )
        cap = self._cap_local(max(n, capacity or 0))
        cap_g = D * cap
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        dev = self.device
        order = torch.arange(n, device=dev)
        if row_order is not None:
            order = torch.as_tensor(row_order, device=dev).long()
            if order.shape != (n,):
                raise ValueError(
                    f"row_order must be a ({n},)-shaped ordering of the batch rows, "
                    f"got shape {tuple(order.shape)}"
                )
        # balanced contiguous assignment: shard k takes the k-th slice of the
        # ordered rows, lanes past it the trash id (position n of ``pick``)
        start, cnt = self._split(n)
        pos = np.full((D, cap), n, dtype=np.int64)
        for k in range(D):
            pos[k, : cnt[k]] = start[k] + np.arange(cnt[k])
        pick = torch.cat([order, torch.full((1,), cap_g, dtype=torch.int64, device=dev)])
        key = ("batch", cap, tuple(x.shape[1:]), x.dtype)
        if M > 1:
            # a program of its own a (D, M) shape: one graph each
            key += (D, M)

        def wave():
            bufs = self._buffers(key, lambda: (
                torch.empty((cap_g + 1, *x.shape[1:]), dtype=x.dtype, device=dev),
                torch.empty((D, cap), dtype=torch.int64, device=dev),
                torch.empty(D, dtype=torch.int32, device=dev),
            ))
            sx, rows, n0 = bufs
            self._write_rows(sx, x)
            rows.copy_(pick[torch.from_numpy(pos).to(dev)])
            n0.copy_(torch.from_numpy(cnt.astype(np.int32)))
            return self._execute(key, self._program, bufs).cpu().numpy()

        words = launch_wave("sharded", wave)
        dec, ex = words[:n], words[cap_g : cap_g + n].astype(np.int64)
        g = words[2 * cap_g : 2 * cap_g + n].view(np.float32)
        o = 3 * cap_g
        n_f = words[o : o + D]
        n_in_log = words[o + D : o + D + D * S].reshape(D, S)
        reb_log = words[o + D + D * S :]
        s_f = int((n_in_log.sum(axis=0) > 0).sum())
        stages = plan.stages
        bn = self._bn_bill()
        # a model shard bills its w_local columns, so a stage bills w_global
        # = M * ceil(W / M) columns over the model axis (W at M = 1)
        w_bill = self._w_global if M > 1 else self.dplan.W
        chunk_stats = []
        per_shard_scores = np.zeros((D, s_f), dtype=np.int64)
        for s in range(s_f):
            n_in_k = n_in_log[:, s].astype(np.int64)
            n_in = int(n_in_k.sum())
            n_next = int(n_in_log[:, s + 1].sum()) if s + 1 < s_f else int(n_f.sum())
            # each shard bills the live blocks of its slice; an empty shard
            # bills zero (its kernels' block guard skipped the stage)
            per_shard_scores[:, s] = (-(-n_in_k // bn)) * bn * w_bill
            chunk_stats.append(
                ChunkStat(
                    t0=stages[s][0],
                    t1=stages[s][1],
                    n_in=n_in,
                    n_exited=n_in - n_next,
                    scores_computed=int(per_shard_scores[:, s].sum()),
                )
            )
        self.last_run_info = {
            "shards": D,
            "stages_run": s_f,
            "per_shard_n_in": n_in_log[:, :s_f].copy(),
            "per_shard_final_live": n_f.copy(),
            "per_shard_scores": per_shard_scores,
            "rebalanced_stages": np.flatnonzero(reb_log[:s_f]).tolist(),
            "model_shards": M,
        }
        if M > 1:
            # coordinate (k, j) scores ceil(n_in[k] / bn) * bn rows of its
            # w_local columns a stage, and sums over the model axis once a
            # stage step
            coord = (-(-n_in_log[:, :s_f].astype(np.int64) // bn)) * bn * self._w_local
            self.last_run_info.update(
                mesh_shape=(D, M),
                per_coord_scores=np.repeat(coord[:, None, :], M, axis=1),
                per_coord_psums=np.full((D, M), s_f, dtype=np.int64),
                per_coord_stages=np.full((D, M), s_f, dtype=np.int64),
            )
        return ExecutorResult(
            decisions=dec.astype(bool),
            exit_step=ex,
            g_final=g,
            chunk_stats=chunk_stats,
            scores_computed=sum(c.scores_computed for c in chunk_stats),
            scores_possible=n * T,
        )

    # -- streaming admission, one ring a shard ------------------------------

    def _stream_state(self, cap: int, R_l: int, x) -> _StreamState:
        """New buffers of the sharded streaming program: ``_StreamState``
        with a leading shard axis on the rings (``arr`` (D, R_l), ``n``),
        the lanes (``rows``, ``stage``, ``g`` (D, cap)), their counters
        (``n_live``, ``head``) and the scorer's state; ``x`` and the
        results (R_g + 1 rows, R_g = D x R_l) are by request id."""
        dev, i32, D = self.device, torch.int32, self.shards
        R_g = D * R_l

        def ints(*shape):
            return torch.empty(shape, dtype=i32, device=dev)

        return _StreamState(
            x=torch.empty((R_g + 1, *x.shape[1:]), dtype=x.dtype, device=dev),
            arr=ints(D, R_l), n=ints(D),
            rows=torch.empty((D, cap), dtype=torch.int64, device=dev), stage=ints(D, cap),
            g=torch.empty((D, cap), dtype=torch.float32, device=dev),
            n_live=ints(D), head=ints(D), steps_run=ints(), step=ints(),
            dec=torch.empty(R_g + 1, dtype=torch.bool, device=dev), ex=ints(R_g + 1),
            gout=torch.empty(R_g + 1, dtype=torch.float32, device=dev),
            admit=ints(R_g + 1), done=ints(R_g + 1), probe=ints(2),
            state={
                name: v.reshape(D, cap, *v.shape[1:])
                for name, v in self.scorer.init_state(D * cap, dev).items()
            },
        )

    def _stream_reset(self, st: _StreamState, x, n: int, arr: np.ndarray) -> None:
        """Write a run's inputs and the loop's initial state into ``st``:
        the rows by request id, each ring's arrival steps (request i is slot
        i // D of ring i % D; int32 max past its rows: never arrived), empty
        lanes, zero counters and result buffers."""
        D, R_l = st.arr.shape
        ring = np.full((D, R_l), np.iinfo(np.int32).max, dtype=np.int32)
        counts = np.zeros(D, dtype=np.int32)
        for k in range(D):
            a = arr[k::D]
            ring[k, : a.size] = a
            counts[k] = a.size
        self._write_rows(st.x, x)
        st.arr.copy_(torch.from_numpy(ring))
        st.n.copy_(torch.from_numpy(counts))
        st.rows.fill_(st.x.shape[0] - 1)
        st.ex.fill_(self.dplan.plan.T)
        for t in (st.stage, st.g, st.n_live, st.head, st.steps_run, st.step, st.dec,
                  st.gout, st.admit, st.done, *st.state.values()):
            t.zero_()

    def _shard_lane_step(self, x, lanes, g, stages, stop, live, state):
        """One shard's mixed-stage step -> ``(g_new, active, dpos, ex_rel,
        pack, n_keep, state)``: B7, or the scorer's lanes and B6."""
        if self.megakernel:
            outs = mk.mega_lane(
                self.scorer.slabs, x, lanes, g, stages, stop, live,
                self._eps_pos, self._eps_neg, block_n=self._bn_bill(),
            )
            return (*outs, state)
        # rookies sit at stage 0, where a stateful scorer takes their state
        # from the operand
        scores, state = self.scorer.lane_stage(state, self._stage_t0[stages], lanes, x, live)
        outs = cascade_lane_step(
            g, scores.contiguous(), stages, self._eps_pos, self._eps_neg, self._col_valid,
            n_valid=live, block_n=self.block_n,
        )
        return (*outs, state)

    def _stream_burst(self, st: _StreamState) -> None:
        """``STREAM_BURST`` steps of every shard's admission ring, in place
        on ``st`` (``DeviceExecutor._stream_burst`` with a shard axis).
        Nothing here syncs with the host."""
        x, arr, n, step, steps_run = st.x, st.arr, st.n, st.step, st.steps_run
        dec, ex, gout, admit, done = st.dec, st.ex, st.gout, st.admit, st.done
        dp, dev = self.dplan, self.device
        S, T = dp.S, dp.plan.T
        R = x.shape[0] - 1  # R_g, the trash id
        D, cap = st.rows.shape
        i32 = torch.int32
        lane = torch.arange(cap, device=dev)
        shard = torch.arange(D, device=dev)[:, None]
        lanes, stages, gl, live, hd = st.rows, st.stage, st.g, st.n_live, st.head
        states = [{name: v[k] for name, v in st.state.items()} for k in range(D)]
        for _ in range(STREAM_BURST):
            # the reference's loop condition: live lanes or pending rows on
            # any shard.  Once false it stays false, and the step is inert.
            steps_run += (n - hd + live).sum(dtype=i32).clamp_(max=1)
            # admission refill, shard by shard: free lanes take the next
            # arrived rows of the shard's own ring; ring slot j of shard k
            # holds request j * D + k
            arrived = torch.searchsorted(
                arr, step.reshape(1, 1).expand(D, 1).contiguous(), right=True,
                out_int32=True,
            )[:, 0]
            k_new = torch.minimum(cap - live, arrived - hd)
            off = lane - live[:, None]
            is_new = (off >= 0) & (off < k_new[:, None])
            lanes = torch.where(is_new, (off + hd[:, None]) * D + shard, lanes)
            admit[torch.where(is_new, lanes, R)] = step
            live = live + k_new
            hd = hd + k_new
            stop = stages >= S - 1  # lanes running their last stage
            outs = [
                self._shard_lane_step(x, lanes[k], gl[k], stages[k], stop[k], live[k], states[k])
                for k in range(D)
            ]
            g_new, active, dpos, ex_rel, pack = (_stack([o[i] for o in outs]) for i in range(5))
            newly = ex_rel > 0
            fin = newly | (active.bool() & stop)
            scat = torch.where(fin, lanes, R)
            dec[scat] = torch.where(newly, dpos.bool(), g_new >= self._beta)
            ex[scat] = torch.where(newly, ex_rel + self._stage_t0[stages], T)
            gout[scat] = g_new
            done[scat] = step
            pack = pack.long()
            lanes = _repack_shards(lanes, pack, R)[:, :cap]
            stages = _repack_shards(stages + 1, pack, 0)[:, :cap]
            gl = _repack_shards(g_new, pack, 0.0)[:, :cap]
            if st.state:
                states = [repack_state(o[6], pack[k]) for k, o in enumerate(outs)]
            live = _stack([o[5] for o in outs])
            step += 1
        for name, buf in st.state.items():
            buf.copy_(torch.stack([s_k[name] for s_k in states]))
        st.rows.copy_(lanes)
        st.stage.copy_(stages)
        st.g.copy_(gl)
        st.n_live.copy_(live)
        st.head.copy_(hd)
        st.probe.copy_(torch.stack([live.sum(dtype=i32), hd.sum(dtype=i32)]))

    def run_stream(
        self,
        batch,
        n: int,
        arrivals=None,
        capacity: int | None = None,
        ring_capacity: int | None = None,
        prepared: bool = False,
    ) -> StreamResult:
        """Continuously stream ``n`` rows, data-parallel over the shards.

        ``DeviceExecutor.run_stream``'s contract with the admission ring
        split by shard: pending rows are dealt round robin in arrival order
        (request i waits in shard ``i % D``'s ring), so every shard keeps
        receiving work.  ``capacity`` is the GLOBAL lane count (``capacity /
        D`` lanes a shard, block-padded); per-shard occupancy lands in
        ``last_run_info``.
        """
        T = self.dplan.plan.T
        if self.model_shards > 1:
            raise ValueError(
                f"run_stream is unavailable on a {self._mesh_desc()}: streaming "
                "admission mixes per-lane stages, which would need a per-lane "
                "model-axis psum (data-parallel only); compile with model_shards=1 "
                "for streaming"
            )
        if not self.scorer.has_lanes and not self.megakernel:
            raise ValueError(
                "run_stream needs a scorer with per-lane stage scoring (lane_fn) "
                "on the multi-kernel path; this scorer only supports batch stages"
            )
        D = self.shards
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
        cap = self._cap_local(capacity or n)
        R_l = -(-max(n, int(ring_capacity or n)) // D)
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
        key = ("stream", cap, R_l, tuple(x.shape[1:]), x.dtype)

        def wave():
            (st,) = self._buffers(key, lambda: (self._stream_state(cap, R_l, x),))
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
            words = torch.cat(
                [st.steps_run[None], st.dec[:n].to(torch.int32), st.ex[:n],
                 st.gout[:n].view(torch.int32), st.admit[:n], st.done[:n]]
            ).cpu().numpy()
            return words, enqueued, syncs

        words, enqueued, syncs = launch_wave("sharded", wave)
        steps_run = int(words[0])
        dec, ex, g, admit, done = np.split(words[1:], 5)
        admit, done = admit.astype(np.int64), done.astype(np.int64)
        # per-shard block-guard billing from the timeline (shard membership
        # is the round-robin deal: row i lives on shard i % D)
        bn, W = self._bn_bill(), self.dplan.W
        occ = np.stack([stream_occupancy(admit[k::D], done[k::D], steps_run) for k in range(D)])
        self.last_run_info = {
            "shards": D,
            "stream_steps": steps_run,
            "per_shard_occupancy": occ,
            "per_shard_admitted": np.array([admit[k::D].size for k in range(D)], np.int32),
        }
        return StreamResult(
            decisions=dec.astype(bool),
            exit_step=ex.astype(np.int64),
            g_final=g.view(np.float32),
            admit_step=admit,
            done_step=done,
            steps_run=steps_run,
            occupancy=occ.sum(axis=0),
            capacity=D * cap,
            scores_computed=int(((-(-occ // bn)) * bn * W).sum()),
            scores_possible=n * T,
            steps_enqueued=enqueued,
            syncs=syncs + 1,
        )

    # -- grouped (ranking) decide, whole groups a shard --------------------

    def _cap_groups_local(self, n_groups: int, capacity_groups: int | None) -> int:
        """Per-shard group-slot capacity: the balanced share, padded to the
        group decide's block."""
        per = -(-max(n_groups, capacity_groups or 0, 1) // self.shards)
        return -(-per // DEFAULT_BLOCK_G) * DEFAULT_BLOCK_G

    def _grouped_program(self, k: int, x, gids, rows2d, valid2d, n0, eps_g):
        """The grouped stage loop over the shards: ``DeviceExecutor``'s,
        each shard over its own group slots.  ``gids`` (D, cap_g) the slots'
        global group ids (trash ``D * cap_g``), ``rows2d``/``valid2d`` (D,
        cap_g, B), ``n0`` (D,) the live group counts.  Returns one int32
        buffer: the (D * cap_g, k) verdicts, the exit stages and the
        margins' bits by global group id, the (D,) final live counts and
        the (D, S) live counts entering each stage."""
        dp, dev = self.dplan, self.device
        S, W = dp.S, dp.W
        D, cap_g, B = rows2d.shape
        L = cap_g * B
        G_t = D * cap_g
        i32 = torch.int32
        grp = torch.arange(cap_g, device=dev)
        n_active = n0
        g2d = torch.zeros(D, cap_g, B, dtype=torch.float32, device=dev)
        verd = torch.full((G_t + 1, k), -1, dtype=i32, device=dev)
        exst = torch.full((G_t + 1,), S, dtype=i32, device=dev)
        marg = torch.full((G_t + 1,), float("inf"), dtype=torch.float32, device=dev)
        n_in_log = torch.zeros(D, S, dtype=i32, device=dev)
        eps_b = eps_g[:, None].expand(S, cap_g).contiguous()
        states: list[dict] = [{} for _ in range(D)]

        def decide(g2d, valid2d, rows2d, eps, n_active):
            """B8 on every shard -> stacked (margin, exit, verdict)."""
            outs = [
                cascade_group_kernel(g2d[j], valid2d[j], eps, k, n_live=n_active[j],
                                     rows=rows2d[j])
                for j in range(D)
            ]
            return (_stack([o[i] for o in outs]) for i in range(3))

        for s in range(S):
            n_in_log[:, s] = n_active
            t0 = int(dp.stage_t0[s])
            staged = [
                self.scorer.stage(states[j], t0, t0 + W, rows2d[j].reshape(L), x, n_active[j] * B)
                for j in range(D)
            ]
            scores = _stack([sc for sc, _ in staged])
            scores = torch.where(self._col_valid[s], scores, 0.0)
            scores = torch.where(valid2d.reshape(D, L, 1) != 0, scores, 0.0)
            # per-column sequential accumulate: the host oracle's f32 adds
            g_flat = g2d.reshape(D, L)
            for j in range(W):
                g_flat = g_flat + scores[:, :, j]
            g_new = g_flat.reshape(D, cap_g, B)
            margin, exit_g, verdict = decide(g_new, valid2d, rows2d, eps_b[s], n_active)
            exit_b = exit_g.bool()
            scat = torch.where(exit_b, gids, G_t)
            verd[scat] = verdict
            exst.index_fill_(0, scat.reshape(-1), s + 1)
            marg[scat] = margin
            # whole-group compaction, local to each shard
            keep = (grp < n_active[:, None]) & ~exit_b
            pack = torch.where(keep, torch.cumsum(keep, dim=1) - 1, cap_g)
            gids = _repack_shards(gids, pack, G_t)[:, :cap_g]
            rows2d = _repack_shards(rows2d, pack, 0)[:, :cap_g]
            valid2d = _repack_shards(valid2d, pack, 0)[:, :cap_g]
            g2d = _repack_shards(g_new, pack, 0.0)[:, :cap_g]
            if staged[0][1]:
                states = [repack_state(st, _lane_pack(pack[j], B)) for j, (_, st) in enumerate(staged)]
            n_active = keep.sum(dim=1, dtype=i32)
        # ran-out groups carry the full cascade's ranking; B8 at eps = +inf
        # gives their margins and picks
        inf = torch.full((cap_g,), float("inf"), dtype=torch.float32, device=dev)
        margin_f, _, verdict_f = decide(g2d, valid2d, rows2d, inf, n_active)
        scat = torch.where(grp < n_active[:, None], gids, G_t)
        verd[scat] = verdict_f
        exst.index_fill_(0, scat.reshape(-1), S)
        marg[scat] = margin_f
        return torch.cat([
            verd[:G_t].reshape(-1), exst[:G_t], marg[:G_t].view(i32), n_active,
            n_in_log.reshape(-1),
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
        """Execute the grouped cascade for ``n_groups`` bucket-laid-out query
        groups, data-parallel over the shards.

        ``DeviceExecutor.run_grouped``'s contract (one bucket width B a
        call; ``capacity_groups`` pins the GLOBAL group-slot capacity,
        ``capacity_rows`` the operand's).  Groups split contiguously over
        the shards as whole units; there is no grouped rebalance.
        """
        T, S = self.dplan.plan.T, self.dplan.S
        if self.model_shards > 1:
            raise ValueError(
                f"run_grouped is unavailable on a {self._mesh_desc()}: the grouped "
                "(ranking) decide is data-parallel only (BackendCapabilities."
                "model_parallel covers batch run()); compile with model_shards=1 "
                "for grouped serving"
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
        D = self.shards
        n_docs = int((group_valid[:n_groups] != 0).sum())
        B = group_rows.shape[1]
        k = int(k)
        cap_g = self._cap_groups_local(n_groups, capacity_groups)
        G_t = D * cap_g
        x = self._cast_operand(batch if prepared else self.scorer.prepare(batch))
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, executor on {self.device}")
        # balanced contiguous assignment of whole groups: shard j takes the
        # j-th slice (global ids travel with the rectangles)
        gids = np.full((D, cap_g), G_t, dtype=np.int64)
        rows_init = np.zeros((D, cap_g, B), dtype=np.int64)
        valid_init = np.zeros((D, cap_g, B), dtype=np.int32)
        start, cnt = self._split(n_groups)
        for j in range(D):
            sl = slice(start[j], start[j] + cnt[j])
            gids[j, : cnt[j]] = np.arange(start[j], start[j] + cnt[j])
            rows_init[j, : cnt[j]] = group_rows[sl]
            valid_init[j, : cnt[j]] = group_valid[sl] != 0
        dev = self.device
        cap_x = 1 << (max(x.shape[0], capacity_rows or 0, 1) - 1).bit_length()
        key = ("grouped", k, cap_g, B, cap_x, tuple(x.shape[1:]), x.dtype)

        def wave():
            bufs = self._buffers(key, lambda: (
                torch.empty((cap_x, *x.shape[1:]), dtype=x.dtype, device=dev),
                torch.empty((D, cap_g), dtype=torch.int64, device=dev),
                torch.empty((D, cap_g, B), dtype=torch.int64, device=dev),
                torch.empty((D, cap_g, B), dtype=torch.int32, device=dev),
                torch.empty(D, dtype=torch.int32, device=dev),
                torch.empty(S, dtype=torch.float32, device=dev),
            ))
            sx, gids_b, rows_b, valid_b, n0, eps_b = bufs
            self._write_rows(sx, x)
            for buf, host in ((gids_b, gids), (rows_b, rows_init), (valid_b, valid_init),
                              (n0, cnt.astype(np.int32)), (eps_b, eps_g)):
                buf.copy_(torch.from_numpy(host))
            return self._execute(
                key, functools.partial(self._grouped_program, k), bufs
            ).cpu().numpy()

        words = launch_wave("sharded", wave)
        G, Ck = n_groups, G_t * k
        verd = words[:Ck].reshape(G_t, k)[:G]
        exst, marg = words[Ck : Ck + G], words[Ck + G_t : Ck + G_t + G]
        o = Ck + 2 * G_t
        n_f = words[o : o + D]
        n_in_log = words[o + D :].reshape(D, S)
        s_f = int((n_in_log.sum(axis=0) > 0).sum())
        stages = self.dplan.plan.stages
        bn, W = self._bn_bill(), self.dplan.W
        chunk_stats = []
        per_shard_scores = np.zeros((D, s_f), dtype=np.int64)
        for s in range(s_f):
            n_in_k = n_in_log[:, s].astype(np.int64)
            n_in = int(n_in_k.sum())
            n_next = int(n_in_log[:, s + 1].sum()) if s + 1 < s_f else int(n_f.sum())
            # group-quantized block billing per shard: a live group scores
            # its full B-lane rectangle, block-guarded locally
            per_shard_scores[:, s] = (-(-(n_in_k * B) // bn)) * bn * W
            chunk_stats.append(
                ChunkStat(
                    t0=stages[s][0],
                    t1=stages[s][1],
                    n_in=n_in,
                    n_exited=n_in - n_next,
                    scores_computed=int(per_shard_scores[:, s].sum()),
                )
            )
        self.last_run_info = {
            "shards": D,
            "stages_run": s_f,
            "per_shard_n_in": n_in_log[:, :s_f].copy(),
            "per_shard_final_live": n_f.copy(),
            "per_shard_scores": per_shard_scores,
            "rebalanced_stages": [],  # no grouped rebalance
        }
        return GroupedResult(
            verdicts=verd.astype(np.int32),
            exit_stage=exst.astype(np.int64),
            margin=marg.view(np.float32),
            chunk_stats=chunk_stats,
            scores_computed=sum(c.scores_computed for c in chunk_stats),
            scores_possible=n_docs * T,
        )
