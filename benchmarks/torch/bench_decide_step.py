#!/usr/bin/env python3
"""Device time per call of the decide kernels B8 (``csrc/cascade_group.cu``),
B6 (``csrc/cascade_lane.cu``), B2 (``csrc/cascade_chunk.cu``) and B1
(``csrc/cascade.cu``) with the PyTorch calls that their loops run beside
them, for the ``repro_torch`` of one source tree.

    python benchmarks/torch/bench_decide_step.py [--src DIR] [--reps N]
        [--set module.NAME=VALUE,...] [--paths]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed on one card, one process each, in turns (parent,
change, change, parent).  Each tree builds its kernels into its own
``build/``.  ``--set`` overrides module constants of that tree's
``repro_torch.kernels`` before anything is timed (for instance
``cascade_kernel.MAX_CTA_GROUPS=1`` gives B8's warp form one group a CTA).

The inputs are made from fixed seeds at the serving shapes.  B8: 256 group
slots of bucket width 32, 200 live, ragged sizes, k 10 (the ranking
drain's widest wave).  B6: 256 lanes at W 8 over the 64 stages of a
T = 500 plan with a ragged last stage, all live.  B2: the same plan's
stage 5, 256 lanes, all live, their partial sums at permuted slots of a
(257,) buffer.  B1: a (2000, 500) matrix with Filter-and-Score-like
thresholds (negative exits only; rows drifting up never exit).  Names:

* ``b8/picks``: what the tree's grouped loop runs a stage for the margin,
  the exit and the picks: B8 with ``rows=`` where the tree's B8 takes it,
  else B8 and then ``group_topk_rows`` (its stable sort and gathers);
* ``b8/chain``: B8 without rows and then ``group_topk_rows``, in both
  trees; ``b8/margin``: B8 without rows; ``b8/sort``: the stable int64
  sort of (256, 32) keys alone, the yardstick of the pick half;
* ``b6/step``: what the tree's unfused streaming step runs for the decide
  and the compaction: B6's step form where the tree has it, else the
  chain; ``b6/chain``: the stage tables gathered and the scores masked by
  PyTorch, B6 in the reference's form, the cumsum compaction;
  ``b6/reference_form``: that B6 launch alone;
* ``b2/step``: what the tree's unfused batch stage runs for the decide
  and the compaction: B2's step form where the tree has it, else the
  chain; ``b2/chain``: the partial sums gathered through the row ids, the
  scores masked by the stage's column row, B2 in the reference's form,
  the cumsum pack; ``b2/reference_form``: that B2 launch alone (the
  control of earlier versions of this bench, ``control/cascade_chunk``);
* ``b1/eager``: B1 on the (2000, 500) matrix, as ``ops.cascade_decide``
  calls it.

``us`` is ``chip_smoke.device_time_ms``'s device time per call (every
kernel and copy the call launches, over ``--reps`` calls, after a
warm-up); ``host_us`` the host's wall time per call over ``--reps`` calls
enqueued back to back, then one synchronize; ``calls`` the PyTorch
operator calls a call makes (``chip_smoke.OpCount``).

``--paths`` also serves the two paths these kernels carry, on exp1_adult's
GBT and fitted cascade (``bench_matrix_step.exp1_eager``'s, cached in
``build/bench_matrix_exp1.npz`` by the first process): the ranking drain
of chip_smoke's phase 4d (the test rows cut into ragged queries, Poisson
mean 16, seed 2031; ``api.fit(groups=, topk=10)`` at alpha 0.05 on the
cascade's order; B3 + B8, 256 queries a flush) timed by
``chip_smoke.rank_timing``, the unfused streaming server (lane_fn + B6;
capacity 256, window 1024, 256 requests a step) timed by
``chip_smoke.stream_timing``, and the unfused batch server (B3 + B2,
sorted-kernel, chunk_t 8) at batch 128 / 256 / 1024 timed by
``chip_smoke.flush_latency``, with the PyTorch calls of one batch-256
flush a stage (``chip_smoke.unfused_calls`` where the tree's B2 has its
step form; counted the same way otherwise): walls, PyTorch calls per
grouped stage, step or stage, busy shares, and the sorts the drain runs.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line
``{"src": ..., "card": ..., "set": ..., "us": {...}, "host_us": {...},
"calls": {...}, "paths": {...}}``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import OpCount, device_time_ms  # noqa: E402  (imports no torch at load)


def path_times() -> dict:
    """``--paths``: exp1_adult's ranking drain and unfused streaming wave."""
    import numpy as np
    import torch

    from bench_matrix_step import exp1_eager
    from chip_smoke import (
        RANK_ALPHA, RANK_BATCH, RANK_GROUP_MEAN, RANK_K, STREAM_CAP, STREAM_WINDOW,
        flush_latency, rank_timing, serve, stream_timing,
    )
    from repro_torch import api
    from repro_torch.api.scorers import TreeScorer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch.serve import GROUPS_SEED, _ragged_sizes
    from repro_torch.ranking import group_offsets
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    cache = ROOT / "build" / "bench_matrix_exp1.npz"
    score_fn, x_test, fit = exp1_eager(cache)
    z = np.load(cache)
    params = [torch.from_numpy(z[k]).cuda() for k in ("feats", "thrs", "leaves")]
    ds = make_dataset("adult", scale=1.0)
    rng = np.random.default_rng(GROUPS_SEED)
    sizes_tr = _ragged_sizes(len(ds.y_train), RANK_GROUP_MEAN, rng)
    sizes_te = _ragged_sizes(len(ds.y_test), RANK_GROUP_MEAN, rng)
    F_train = score_fn(torch.from_numpy(ds.x_train).cuda()).cpu().numpy()
    fitted = api.fit(
        F_train, groups=sizes_tr, topk=RANK_K, alpha=RANK_ALPHA, beta=fit.beta, mode="both",
        chunk_t=8, order=fit.order, optimize_order=False,
    )
    rank = rank_timing(dict(
        server=lambda: fitted.compile("device", device="cuda").serve(
            score_fn=score_fn, batch_size=RANK_BATCH),
        x=ds.x_test, offsets=group_offsets(sizes_te), S=fitted.grouped.S,
    ))
    stream = stream_timing(
        lambda: StreamingServer(
            fit, exec_backend="device", device="cuda", batch_size=STREAM_CAP,
            window=STREAM_WINDOW, chunk_t=8, block_n=64, scorer=TreeScorer(*params),
            backend_opts={"megakernel": False},
        ), x_test, "exp1_adult unfused")

    def batch_server(**kw):
        kw.setdefault("batch_size", 256)
        kw.setdefault("backend_opts", {"megakernel": False})
        return QWYCServer(fit, exec_backend="device", device="cuda", backend="sorted-kernel",
                          chunk_t=8, scorer=TreeScorer(*params), **kw)

    lat = flush_latency(batch_server, x_test, "exp1_adult", megakernels=(False,))
    # the PyTorch calls of one steady batch-256 flush, a stage
    srv = batch_server()
    serve(srv, x_test[:256])
    for row in x_test[256:511]:
        srv.submit(row)
    with OpCount() as ops:
        srv.submit(x_test[511])
    torch.cuda.synchronize()
    n_stages = srv._dev[0].dplan.S
    keys = ("drain_median_ms", "drain_p90_ms", "torch_ops_per_stage", "device_busy_us",
            "busy_share", "sort_kernels", "sort_calls")
    return dict(
        rank={k: rank.get(k) for k in keys},
        stream_unfused={k: stream[k] for k in (
            "wave_median_ms", "wave_p90_ms", "step_median_ms", "torch_ops_per_step",
            "device_busy_us", "busy_share")},
        batch_unfused=dict(
            latency=lat, torch_ops=ops.n, torch_ops_per_stage=ops.n / n_stages,
            stages=n_stages, cumsum=ops.by_name.get("aten.cumsum", 0),
            gathers=ops.by_name.get("aten.index", 0),
        ),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--set", default="", help="module.NAME=VALUE,... of repro_torch.kernels")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_decide_step: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels import cascade_kernel as ck
    from repro_torch.kernels.device_executor import DevicePlan, group_topk_rows

    for item in filter(None, args.set.split(",")):
        name, value = item.split("=")
        mod, attr = name.rsplit(".", 1)
        module = importlib.import_module(f"repro_torch.kernels.{mod}")
        if not hasattr(module, attr):
            raise SystemExit(f"bench_decide_step: {mod} has no {attr}")
        setattr(module, attr, type(getattr(module, attr))(int(value)))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    us, host_us, calls = {}, {}, {}

    def timed(name, fn):
        us[name] = 1e3 * device_time_ms(fn, args.reps)
        with OpCount() as ops:
            fn()
        calls[name] = ops.n
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        host_us[name] = 1e6 * (time.perf_counter() - t) / args.reps

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # B8 at the ranking drain's widest wave
    G, B, k, live = 256, 32, 10, 200
    sizes = np.clip(rng.poisson(16, size=G), 1, B)
    sizes[live:] = 0
    valid = t((np.arange(B)[None, :] < sizes[:, None]).astype(np.int32))
    g = t(rng.normal(size=(G, B)).astype(np.float32))
    eps = t(np.full(G, 0.4, np.float32))
    rows = t(rng.integers(0, 4000, size=(G, B)).astype(np.int64))
    n_live = torch.tensor(live, dtype=torch.int32, device=dev)
    takes_rows = "rows" in inspect.signature(ck.cascade_group_kernel).parameters

    def b8_chain():
        return (ck.cascade_group_kernel(g, valid, eps, k, n_live=n_live),
                group_topk_rows(g, valid, rows, k))

    timed("b8/picks", (lambda: ck.cascade_group_kernel(g, valid, eps, k, n_live=n_live,
                                                       rows=rows)) if takes_rows else b8_chain)
    timed("b8/chain", b8_chain)
    timed("b8/margin", lambda: ck.cascade_group_kernel(g, valid, eps, k, n_live=n_live))
    key = torch.randint(-(1 << 40), 1 << 40, (G, B), device=dev)
    timed("b8/sort", lambda: torch.sort(key, dim=1, descending=True, stable=True))

    # B6 at the unfused streaming step's shape
    T, cap = 500, 256
    plan = CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
        eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=8, lead_t=1,
    )
    dplan = DevicePlan.from_plan(plan)
    S, W = dplan.S, dplan.W
    ep, en, col = t(dplan.eps_pos), t(dplan.eps_neg), t(dplan.col_valid)
    stage_np = rng.integers(0, S, size=cap).astype(np.int32)
    stage_np[:S] = np.arange(S)
    stage = t(stage_np)
    scores = t(rng.normal(scale=0.3, size=(cap, W)).astype(np.float32))
    g0 = t(rng.normal(scale=0.5, size=cap).astype(np.float32))
    nv = torch.tensor(cap, dtype=torch.int32, device=dev)

    def b6_chain():
        sc = torch.where(col[stage], scores, 0.0)
        g_new, act, dpos, ex = ck.cascade_lane_kernel(g0, sc, ep[stage], en[stage], block_n=64,
                                                      n_valid=nv)
        keep = act.bool() & ~(stage >= S - 1)
        pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=torch.int32) - 1, cap)
        return g_new, act, dpos, ex, pack, keep.sum(dtype=torch.int32)

    step = getattr(ck, "cascade_lane_step", None)
    timed("b6/step", (lambda: step(g0, scores, stage, ep, en, col, n_valid=nv, block_n=64))
          if step else b6_chain)
    timed("b6/chain", b6_chain)
    sc_masked = torch.where(col[stage], scores, 0.0)
    ep_l, en_l = ep[stage].contiguous(), en[stage].contiguous()
    timed("b6/reference_form", lambda: ck.cascade_lane_kernel(
        g0, sc_masked, ep_l, en_l, block_n=64, n_valid=nv))

    # B2 at the unfused batch stage's shape: stage 5 of the same plan,
    # partial sums at permuted slots of a (cap + 1,) buffer
    g_slots = torch.cat([g0, torch.zeros(1, device=dev)])
    rows_b2 = t(rng.permutation(cap).astype(np.int64))
    lane = torch.arange(cap, device=dev)

    def b2_chain():
        sc = torch.where(col[5][None, :], scores, 0.0)
        g_new, act, dpos, ex = ck.cascade_chunk_kernel(
            g_slots[rows_b2], sc.contiguous(), ep[5], en[5], 0, block_n=64, n_valid=nv)
        keep = act.bool() & (lane < nv)
        pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=torch.int32) - 1, cap)
        return g_new, act, dpos, ex, pack, keep.sum(dtype=torch.int32)

    b2_step = getattr(ck, "cascade_chunk_step", None)
    timed("b2/step", (lambda: b2_step(g_slots, rows_b2, scores, 5, ep, en, col, n_valid=nv,
                                      block_n=64)) if b2_step else b2_chain)
    timed("b2/chain", b2_chain)
    ep_c, en_c = ep[5].contiguous(), en[5].contiguous()
    g_rows = g_slots[rows_b2]
    sc_b2 = torch.where(col[5][None, :], scores, 0.0)
    timed("b2/reference_form", lambda: ck.cascade_chunk_kernel(
        g_rows, sc_b2, ep_c, en_c, 0, block_n=64, n_valid=nv))

    # B1 on a (2000, 500) matrix with negative exits only, as the eager
    # Filter-and-Score path calls it (ops.cascade_decide's block_n 256)
    n1, T1 = 2000, 500
    drift = rng.normal(scale=0.05, size=(n1, 1))
    F1 = t((rng.normal(scale=0.3, size=(n1, T1)) + drift).astype(np.float32))
    ep1 = t(np.full(T1, np.inf, np.float32))
    en1 = t(-rng.uniform(1.5, 4.0, size=T1).astype(np.float32))
    timed("b1/eager", lambda: ck.cascade_kernel(F1, ep1, en1, 0.0, block_n=256, chunk_t=8))
    steps = int(ck.cascade_kernel(F1, ep1, en1, 0.0, block_n=256, chunk_t=8)[1].sum())
    report = {"src": args.src, "card": card, "set": args.set, "us": us,
              "host_us": host_us, "calls": calls, "b1_steps_walked": steps}
    if args.paths:
        report["paths"] = path_times()
    print(card, flush=True)
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
