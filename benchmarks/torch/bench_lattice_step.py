#!/usr/bin/env python3
"""Device time per launch of B4 and B7 lattice (``csrc/mega_stage.cu``) at
the exp4_rw2_joint serving shape, for the ``repro_torch`` of one source tree.

    python benchmarks/torch/bench_lattice_step.py [--src DIR] [--reps N]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed on one card, one process each, in turns (parent,
change, change, parent).  Each tree builds its kernels into its own
``build/``.  The inputs are made from fixed seeds: 500 lattices over S = 8
of D = 30 features, chunk 8 after a lead model (64 stages of W = 8), a
buffer of 256 rows in blocks of 64 with thresholds that retire rows
mid-block; B7's lanes either spread over all 64 stages or all at stage 5.
Each kernel runs at f32, bf16 and int8 slabs.  The time is
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
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_lattice_step: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.device_executor import DevicePlan, lattice_stage_scorer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T, S, D, cap, bn = 500, 8, 30, 256, 64
    theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
    feats = np.stack([rng.choice(D, S, replace=False) for _ in range(T)]).astype(np.int32)
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
    for q in ("f32", "bf16", "int8"):
        dplan = DevicePlan.from_plan(plan, quant=q)
        slabs = lattice_stage_scorer(dplan, theta, feats, block_n=bn, quant=q, device=dev).slabs
        eps = torch.from_numpy(dplan.eps_pos).to(dev), torch.from_numpy(dplan.eps_neg).to(dev)
        spread = torch.from_numpy(rng.integers(0, dplan.S, size=cap).astype(np.int32)).to(dev)
        spread[: dplan.S] = torch.arange(dplan.S, dtype=torch.int32, device=dev)
        one = torch.full((cap,), 5, dtype=torch.int32, device=dev)
        sfx = "" if q == "f32" else f"_{q}"
        us[f"mega_stage_lattice{sfx}"] = 1e3 * device_time_ms(
            lambda: mk.mega_stage_kernel(slabs, xr, g0, 5, int(dplan.stage_t0[5]), nv, *eps,
                                         block_n=bn), args.reps)
        for label, stage in (("", spread), ("/one_stage", one)):
            stop = stage >= dplan.S - 1
            us[f"mega_lane_lattice{sfx}{label}"] = 1e3 * device_time_ms(
                lambda: mk.mega_lane_kernel(slabs, x, rows, g0, stage, stop, nv, *eps,
                                            block_n=bn), args.reps)
    print(card, flush=True)
    print(json.dumps({"src": args.src, "card": card, "us": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
