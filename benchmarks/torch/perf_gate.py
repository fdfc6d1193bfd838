#!/usr/bin/env python3
"""The port's billing gate: ``benchmarks/perf_gate.py``'s fixed-seed
fixtures through ``repro_torch``, held to the reference's own counts.

    PYTHONPATH=src python benchmarks/torch/perf_gate.py --device cpu --check
    PYTHONPATH=src python benchmarks/torch/perf_gate.py --device cuda --check

The counters are pure work counts (scores computed, block-billed; stages
run; survivor sums; modeled models; streaming steps; program traces): no
clock is read.  The seeds (2026-2032), fixtures and key names are the
reference gate's, and every executor is built through the port's backend
registry with its key prefix from ``Backend.billing_key``.  On the CPU the
loops run the kernels' plain versions; on the card they launch the kernels
(captured as CUDA graphs, one per program key).

A key is *reachable* when the port's counterpart of the exact call in the
reference gate produces it, and *pending* when that counterpart is missing:
``PENDING`` names the queue item of ``ROADMAP.md`` that brings it.
``--check`` compares every reachable key with
``benchmarks/results/baseline_billing.json`` (read, never written) and
requires equality: the baseline is the reference's count, so a count below
it is a parity fault as much as one above.  It exits 1 on any difference,
on a key the port produces that the baseline lacks, and on any baseline
key that is neither reachable nor pending.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BASELINE = ROOT / "benchmarks" / "results" / "baseline_billing.json"

# baseline key patterns the port cannot produce yet, with the queue item
# (ROADMAP.md, queue A) that brings each
PENDING = (
    ("*.sharded*", "A15 (queue A item 8): the sharded and 2-D mesh executors"),
)


def pending_reason(key: str) -> str | None:
    """The queue item that brings ``key``, or None for a reachable key."""
    for pattern, item in PENDING:
        if fnmatch.fnmatchcase(key, pattern):
            return item
    return None


def collect_counters(device: str) -> dict[str, int]:
    """The reachable counters, from the reference gate's fixtures, with
    every run on ``device`` ("cpu" or "cuda")."""
    import numpy as np
    import torch

    from repro_torch.api.registry import get_backend
    from repro_torch.api.scorers import FunctionScorer
    from repro_torch.core import CascadePlan, evaluate_cascade, fit_qwyc
    from repro_torch.core.executor import matrix_producer
    from repro_torch.kernels import ops
    from repro_torch.kernels.device_executor import BoundScorer, DevicePlan, matrix_stage_scorer
    from repro_torch.ranking import (
        bucket_layout,
        fit_grouped,
        group_offsets,
        pack_by_bucket,
        run_grouped_host,
    )
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    dev = torch.device(device)
    HOST = get_backend("host")
    DEVICE = get_backend("device")

    def scorer(dplan):
        return matrix_stage_scorer(dplan, device=dev)

    c: dict[str, int] = {}
    rng = np.random.default_rng(2026)
    n, t = 512, 32
    z = rng.normal(size=(n, 1))
    F = (rng.normal(size=(n, t)) * 0.7 + 0.4 * z).astype(np.float64)

    for mode in ("both", "neg_only"):
        m = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
        ev = evaluate_cascade(m, F)
        plan = CascadePlan.from_qwyc(m, chunk_t=8)
        p = f"{mode}"
        c[f"{p}.modeled_models"] = int(ev["exit_step"].sum())

        host = HOST.make_executor(plan, producer=matrix_producer(F[:, m.order])).run(n)
        hk = HOST.billing_key()
        c[f"{p}.{hk}.scores"] = int(host.scores_computed)
        c[f"{p}.{hk}.stages"] = len(host.chunk_stats)
        c[f"{p}.{hk}.survivor_sum"] = int(sum(host.survivors_per_chunk))

        # the fused lazy path on the host loop: the chunk decide (B2) at
        # block 64, billed at its block
        billed = ops.score_and_decide(
            matrix_producer(F[:, m.order].astype(np.float32)), plan, n,
            block_n=64, backend="host", torch_device=dev,
        )
        kk = HOST.billing_key(decide="kernel", block_n=64)
        c[f"{p}.{kk}.scores"] = int(billed.scores_computed)

        Fo = F[:, m.order].astype(np.float32)
        dplan = DevicePlan.from_plan(plan)
        dex = DEVICE.make_executor(dplan, scorer=scorer(dplan), block_n=64, device=dev)
        dres = dex.run(Fo, n)
        assert np.array_equal(dres.decisions, ev["decisions"])
        dk = DEVICE.billing_key()
        c[f"{p}.{dk}.scores"] = int(dres.scores_computed)
        c[f"{p}.{dk}.stages"] = len(dres.chunk_stats)
        c[f"{p}.{dk}.traces"] = int(dex.traces)

        # the multi-kernel path bills what the fused step billed
        dex_fb = DEVICE.make_executor(
            dplan, scorer=scorer(dplan), block_n=64, megakernel=False, device=dev
        )
        fres = dex_fb.run(Fo, n)
        assert np.array_equal(fres.decisions, dres.decisions)
        assert np.array_equal(fres.exit_step, dres.exit_step)
        assert fres.scores_computed == dres.scores_computed
        assert len(fres.chunk_stats) == len(dres.chunk_stats)
        fk = f"{p}.{dk}.multikernel"
        c[f"{fk}.scores"] = int(fres.scores_computed)
        c[f"{fk}.stages"] = len(fres.chunk_stats)
        c[f"{fk}.traces"] = int(dex_fb.traces)

        # bf16 slabs over a bf16-representable operand (the scores rounded
        # to nearest even, as the reference's jnp cast rounds them): fused
        # and multi-kernel decide and bill alike
        Fq = torch.from_numpy(Fo).to(torch.bfloat16).float().numpy()
        dplan_q = DevicePlan.from_plan(plan, quant="bf16")
        dexq = DEVICE.make_executor(
            dplan_q, scorer=scorer(dplan_q), block_n=64, megakernel=True, device=dev
        )
        dexq_fb = DEVICE.make_executor(
            dplan_q, scorer=scorer(dplan_q), block_n=64, megakernel=False, device=dev
        )
        qres, qfres = dexq.run(Fq, n), dexq_fb.run(Fq, n)
        assert np.array_equal(qres.decisions, qfres.decisions)
        assert np.array_equal(qres.exit_step, qfres.exit_step)
        assert qres.scores_computed == qfres.scores_computed
        qk = f"{p}.{dk}.bf16mk"
        c[f"{qk}.scores"] = int(qres.scores_computed)
        c[f"{qk}.stages"] = len(qres.chunk_stats)
        c[f"{qk}.traces"] = int(dexq.traces)

    # serving-path billing: the lazy host loop (the reference server's
    # default backend is the host loop; the port runs it only when named)
    rng2 = np.random.default_rng(2027)
    ns, ts, d = 384, 24, 8
    W = rng2.normal(size=(ts, d))
    X = rng2.normal(size=(ns, d)).astype(np.float32)
    Fs = (X @ W.T).astype(np.float64)
    ms = fit_qwyc(Fs, beta=0.0, alpha=0.01)
    Wo = W[ms.order]

    def chunk_score_fn(x, rows, t0, t1):
        return x.cpu().numpy()[rows] @ Wo[t0:t1].T

    srv = QWYCServer(
        ms, batch_size=128, backend="sorted-kernel", chunk_t=6,
        chunk_score_fn=chunk_score_fn, score_block_n=32, exec_backend="host", device=dev,
    )
    for row in X:
        srv.submit(row)
    srv.drain()
    c["serve.lazy.scores"] = int(srv.stats.scores_computed)
    c["serve.lazy.audit_scores"] = int(srv.stats.audit_scores)
    c["serve.lazy.models"] = int(srv.stats.models_evaluated)

    # streaming admission: the seed-2028 Poisson trace through the
    # continuous-batching server on the device, scoring with a user's
    # FunctionScorer (a matmul closure, its lanes an einsum); the counters
    # are the work the latency percentiles derive from
    ev_s = evaluate_cascade(ms, Fs)
    arrivals = np.cumsum(np.random.default_rng(2028).exponential(1.0 / 32.0, size=ns))
    Wo_t = torch.from_numpy(Wo.astype(np.float32))

    def lane_factory(dplan, device):
        Wp = torch.nn.functional.pad(Wo_t, (0, 0, 0, dplan.T_pad - ts)).to(device)
        width = dplan.W

        def fn(x, rows, t0, n_valid):
            return x[rows] @ Wp[t0 : t0 + width].T

        def lane_fn(x, rows, t0_lane, n_valid):
            pos = t0_lane.long()[:, None] + torch.arange(width, device=x.device)
            return torch.einsum("cd,cwd->cw", x[rows], Wp[pos])

        def prepare(xb):
            return torch.as_tensor(np.asarray(xb, dtype=np.float32)).to(device)

        return BoundScorer(fn=fn, prepare=prepare, width=width, lane_fn=lane_fn)

    srv3 = StreamingServer(
        ms, batch_size=32, window=128, chunk_t=6, exec_backend=DEVICE,
        scorer=FunctionScorer(lane_factory), audit_full_scores=False, device=dev,
    )
    for row, a in zip(X, arrivals):
        srv3.submit(row, arrival=a)
    res3 = srv3.drain()
    assert np.array_equal(np.array([r["decision"] for r in res3]), ev_s["decisions"])
    sk = DEVICE.billing_key()
    sst = srv3.stats
    c[f"stream.{sk}.admitted"] = int(sst.admitted_rows)
    c[f"stream.{sk}.scores"] = int(sst.scores_computed)
    c[f"stream.{sk}.steps"] = int(sst.stream_steps)
    c[f"stream.{sk}.slot_steps"] = int(sst.stream_slot_steps)
    c[f"stream.{sk}.latency_sum"] = int(sum(sst.latency_steps))
    c[f"stream.{sk}.traces"] = int(srv3._dev[0].traces)

    # streaming megakernel identity: the same arrival trace through the
    # admission ring with the fused lane kernel on and off, identical
    # decisions, timelines and bill, one program each
    plan_s = CascadePlan.from_qwyc(ms, chunk_t=6)
    dplan_s = DevicePlan.from_plan(plan_s)
    Fso = Fs[:, ms.order].astype(np.float32)
    arr_steps = np.sort(np.random.default_rng(2029).integers(0, 48, size=ns)).astype(np.int32)
    s_mk = None
    for flag, name in ((True, "stream.device.mk"), (False, "stream.device.multikernel")):
        dexs = DEVICE.make_executor(
            dplan_s, scorer=scorer(dplan_s), block_n=32, megakernel=flag, device=dev
        )
        sres_s = dexs.run_stream(Fso, ns, arrivals=arr_steps, capacity=64)
        if s_mk is None:
            s_mk = sres_s
        else:
            assert np.array_equal(s_mk.decisions, sres_s.decisions)
            assert np.array_equal(s_mk.exit_step, sres_s.exit_step)
            assert np.array_equal(s_mk.admit_step, sres_s.admit_step)
            assert np.array_equal(s_mk.done_step, sres_s.done_step)
            assert s_mk.scores_computed == sres_s.scores_computed
        c[f"{name}.scores"] = int(sres_s.scores_computed)
        c[f"{name}.steps"] = int(sres_s.steps_run)
        c[f"{name}.traces"] = int(dexs.traces)

    # grouped ranking: ragged query groups through the host oracle and the
    # grouped device program, one program per bucket shape
    rng4 = np.random.default_rng(2032)
    Gq, Tq = 24, 24
    sizes_q = rng4.integers(1, 17, size=Gq).astype(np.int64)
    Nq = int(sizes_q.sum())
    qual = rng4.exponential(1.0, size=Nq)
    Fr = rng4.normal(size=(Nq, Tq)) * 0.1 + qual[:, None]
    gp = fit_grouped(Fr, sizes_q, 3, alpha=0.05, chunk_t=6)
    ghost = run_grouped_host(gp, Fr, sizes_q)
    c["ranking.host.scores"] = int(ghost.scores_computed)
    c["ranking.host.stages"] = len(ghost.chunk_stats)

    gdplan = DevicePlan.from_plan(gp.plan)
    Ford = np.ascontiguousarray(Fr.astype(np.float32)[:, gp.plan.order])
    goff = group_offsets(sizes_q)
    packs = pack_by_bucket(sizes_q, gp.buckets)
    capq = max(len(g) for g in packs.values())
    gk = DEVICE.billing_key()

    def grouped_bill(ex, stream=False):
        paid = stages = 0
        for b, gidx in sorted(packs.items()):
            rows_b, valid_b = bucket_layout(sizes_q[gidx], b, offsets=goff[gidx])
            if stream:
                r = ex.run_stream_grouped(
                    Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k, capacity_groups=capq
                )
                stages += int(r.steps_run)
            else:
                r = ex.run_grouped(
                    Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k, capacity_groups=capq
                )
                stages += len(r.chunk_stats)
            assert np.array_equal(r.verdicts, ghost.verdicts[gidx])
            assert np.array_equal(r.exit_stage, ghost.exit_stage[gidx])
            paid += int(r.scores_computed)
        return paid, stages

    gex = DEVICE.make_executor(
        gdplan, scorer=scorer(gdplan), block_n=32, megakernel=False, device=dev
    )
    paid, stages = grouped_bill(gex)
    c[f"ranking.{gk}.scores"] = paid
    c[f"ranking.{gk}.stages"] = stages
    c[f"ranking.{gk}.traces"] = int(gex.traces)

    # the grouped admission ring: one program per bucket shape
    gex_s = DEVICE.make_executor(
        gdplan, scorer=scorer(gdplan), block_n=32, megakernel=False, device=dev
    )
    paid, steps = grouped_bill(gex_s, stream=True)
    c[f"ranking.stream.{gk}.scores"] = paid
    c[f"ranking.stream.{gk}.steps"] = steps
    c[f"ranking.stream.{gk}.traces"] = int(gex_s.traces)
    return c


def compare(baseline: dict[str, int], current: dict[str, int]) -> list[str]:
    """The gate's failures (it passes iff there are none): every
    reachable key must equal the baseline, a pending key must not be
    produced, and the key sets must not drift either way."""
    failures = []
    for k in sorted(baseline):
        if pending_reason(k) is not None:
            if k in current:
                failures.append(f"pending key produced: {k}={current[k]} ({pending_reason(k)})")
        elif k not in current:
            failures.append(f"counter not produced: {k} (baseline {baseline[k]})")
        elif current[k] > baseline[k]:
            failures.append(f"ABOVE baseline {k}: {baseline[k]} -> {current[k]} "
                            f"(+{current[k] - baseline[k]})")
        elif current[k] < baseline[k]:
            failures.append(f"BELOW baseline {k}: {baseline[k]} -> {current[k]} "
                            f"({current[k] - baseline[k]}): a parity fault")
    for k in sorted(set(current) - set(baseline)):
        failures.append(f"counter not in the baseline: {k}={current[k]}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any difference or unaccounted key")
    args = ap.parse_args(argv)

    baseline = json.loads(BASELINE.read_text())["counters"]
    current = collect_counters(args.device)
    pending = {k: pending_reason(k) for k in baseline if pending_reason(k) is not None}
    reachable = sorted(k for k in baseline if k not in pending)
    by_item: dict[str, int] = {}
    for item in pending.values():
        by_item[item] = by_item.get(item, 0) + 1
    print(f"[perf-gate] {args.device}: {len(baseline)} baseline keys, {len(reachable)} "
          f"reachable, {len(pending)} pending")
    for item, count in sorted(by_item.items()):
        print(f"[perf-gate]   pending {count:3d}: {item}")
    for k in reachable:
        got = current.get(k)
        print(f"[perf-gate]   {k} = {got} (baseline {baseline[k]})"
              + ("" if got == baseline[k] else "  <-- differs"))
    failures = compare(baseline, current)
    for line in failures:
        print(f"[perf-gate] FAIL {line}")
    if not args.check:
        return 0
    if failures:
        print(f"[perf-gate] {len(failures)} failure(s)")
        return 1
    print(f"[perf-gate] OK: {len(reachable)} reachable keys equal the baseline, "
          f"{len(pending)} pending, {len(baseline)} accounted for")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.exit(main())
