#!/usr/bin/env python3
"""Device time per call of the decide kernels B8 (``csrc/cascade_group.cu``)
and B6 (``csrc/cascade_lane.cu``) with the PyTorch calls that their loops
run beside them, and B2 as a control, for the ``repro_torch`` of one
source tree.

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
T = 500 plan with a ragged last stage, all live.  Names:

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
* ``control/cascade_chunk``: B2 on (256, 8) scores.

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
``chip_smoke.rank_timing``, and the unfused streaming server (lane_fn +
B6; capacity 256, window 1024, 256 requests a step) timed by
``chip_smoke.stream_timing``: walls, PyTorch calls per grouped stage or
step, busy shares, and the sorts the drain runs.

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
        rank_timing, stream_timing,
    )
    from repro_torch import api
    from repro_torch.api.scorers import TreeScorer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch.serve import GROUPS_SEED, _ragged_sizes
    from repro_torch.ranking import group_offsets
    from repro_torch.serving.engine import StreamingServer

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
    keys = ("drain_median_ms", "drain_p90_ms", "torch_ops_per_stage", "device_busy_us",
            "busy_share", "sort_kernels", "sort_calls")
    return dict(
        rank={k: rank.get(k) for k in keys},
        stream_unfused={k: stream[k] for k in (
            "wave_median_ms", "wave_p90_ms", "step_median_ms", "torch_ops_per_step",
            "device_busy_us", "busy_share")},
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

    # B2 on one stage's scores
    ep_c, en_c = ep[5].contiguous(), en[5].contiguous()
    timed("control/cascade_chunk", lambda: ck.cascade_chunk_kernel(
        g0, scores, ep_c, en_c, 0, block_n=64, n_valid=nv))
    report = {"src": args.src, "card": card, "set": args.set, "us": us,
              "host_us": host_us, "calls": calls}
    if args.paths:
        report["paths"] = path_times()
    print(card, flush=True)
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
