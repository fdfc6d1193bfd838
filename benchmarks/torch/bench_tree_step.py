#!/usr/bin/env python3
"""Device time per launch of B4 and B7 tree (``csrc/mega_stage.cu``) at the
exp1_adult serving shape and at exp2_nomao's depth, with B4 matrix and B8
(``csrc/cascade_group.cu``) as controls, for the ``repro_torch`` of one
source tree.

    python benchmarks/torch/bench_tree_step.py [--src DIR] [--reps N] [--quants f32,bf16,int8]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed on one card, one process each, in turns (parent,
change, change, parent).  Each tree builds its kernels into its own
``build/``.  The inputs are made from fixed seeds: 500 oblivious trees of
depth 5 and of depth 9 over D = 14 features, chunk 8 after a lead model
(64 stages of W = 8), a buffer of 256 rows in blocks of 64 with thresholds
that retire rows mid-block; B4 at stage 5, B7's lanes either spread over
all 64 stages or all at stage 5; trees at each storage of ``--quants``.
The controls: B4 matrix on a (257, 500) f32 score matrix at stage 5, and
B8 on 256 groups of 32 lanes at k 10.  The time is
``chip_smoke.device_time_ms``'s: the profiler's device time of ``--reps``
launches, per launch, after a warm-up.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line
``{"src": ..., "card": ..., "us": {name: device us per launch}}``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_time_ms  # noqa: E402  (imports no torch at load)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--quants", default="f32,bf16,int8")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_tree_step: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.cascade_kernel import cascade_group_kernel
    from repro_torch.kernels.device_executor import DevicePlan, matrix_stage_scorer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T, D, cap, bn, stage = 500, 14, 256, 64, 5
    plan = CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
        eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=8, lead_t=1,
    )
    x = torch.from_numpy(rng.uniform(size=(cap + 1, D)).astype(np.float32)).to(dev)
    g0 = torch.from_numpy(rng.normal(scale=0.5, size=cap).astype(np.float32)).to(dev)
    nv = torch.tensor(cap, dtype=torch.int32, device=dev)
    rows = torch.arange(cap, device=dev)
    xr = x[rows].contiguous()
    us = {}

    def timed(name, fn):
        us[name] = 1e3 * device_time_ms(fn, args.reps)

    for depth in (5, 9):
        feats = rng.integers(0, D, size=(T, depth)).astype(np.int32)
        thrs = rng.uniform(size=(T, depth)).astype(np.float32)
        leaves = rng.normal(size=(T, 1 << depth)).astype(np.float32)
        for q in args.quants.split(","):
            dplan = DevicePlan.from_plan(plan, quant=q)
            slabs = mk.build_tree_slabs(dplan, feats, thrs, leaves, quant=q, device=dev)
            eps = torch.from_numpy(dplan.eps_pos).to(dev), torch.from_numpy(dplan.eps_neg).to(dev)
            spread = torch.from_numpy(rng.integers(0, dplan.S, size=cap).astype(np.int32)).to(dev)
            spread[: dplan.S] = torch.arange(dplan.S, dtype=torch.int32, device=dev)
            one = torch.full((cap,), stage, dtype=torch.int32, device=dev)
            sfx = ("" if q == "f32" else f"_{q}") + ("" if depth == 5 else f"/depth{depth}")
            timed(f"mega_stage_tree{sfx}", lambda: mk.mega_stage_kernel(
                slabs, xr, g0, stage, int(dplan.stage_t0[stage]), nv, *eps, block_n=bn))
            for label, st in (("", spread), ("/one_stage", one)):
                stop = st >= dplan.S - 1
                timed(f"mega_lane_tree{sfx}{label}", lambda: mk.mega_lane_kernel(
                    slabs, x, rows, g0, st, stop, nv, *eps, block_n=bn))
    # controls: kernels this change does not touch
    dplan = DevicePlan.from_plan(plan)
    eps = torch.from_numpy(dplan.eps_pos).to(dev), torch.from_numpy(dplan.eps_neg).to(dev)
    matrix = matrix_stage_scorer(dplan, device=dev)
    F = matrix.prepare(rng.normal(size=(cap + 1, T)).astype(np.float32))
    Fr = F[rows].contiguous()
    timed("mega_stage_matrix", lambda: mk.mega_stage_kernel(
        matrix.slabs, Fr, g0, stage, int(dplan.stage_t0[stage]), nv, *eps, block_n=bn))
    G, B, k = 256, 32, 10
    gg = torch.from_numpy(rng.normal(size=(G, B)).astype(np.float32)).to(dev)
    valid = torch.from_numpy((rng.uniform(size=(G, B)) < 0.8).astype(np.int32)).to(dev)
    eg = torch.from_numpy(rng.uniform(0.0, 2.0, size=G).astype(np.float32)).to(dev)
    n_live = torch.tensor(G, dtype=torch.int32, device=dev)
    timed("cascade_group", lambda: cascade_group_kernel(gg, valid, eg, k, n_live=n_live))
    print(card, flush=True)
    print(json.dumps({"src": args.src, "card": card, "us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
