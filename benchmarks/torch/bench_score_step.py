#!/usr/bin/env python3
"""Device time per launch of the score kernels B3 (``csrc/tree_scores.cu``)
and B5 (``csrc/lattice_scores.cu``) at every shape the serving paths give
them, with B2, B4 tree and B4 lattice as controls, for the ``repro_torch``
of one source tree.

    python benchmarks/torch/bench_score_step.py [--src DIR] [--reps N]
        [--set module.NAME=VALUE,...]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed on one card, one process each, in turns (parent,
change, change, parent).  Each tree builds its kernels into its own
``build/``.  ``--set`` overrides module constants of that tree's
``repro_torch.kernels`` before anything is timed (for instance
``lattice_kernel.TEAM_THREADS_PER_SM=0`` forces B5's thread regime,
``tree_kernel.TILE=16`` gives B3 tiles of at most 16 trees).

The inputs are made from fixed seeds.  B3: 500 oblivious trees of depth 5
over D = 14 features (exp1_adult's widths), and at the calibration shape
also of depth 1 and 9.  B5: 500 lattices over S = 8
of D = 30 features (exp4_rw2_joint's).  Shapes: the sort key (256 rows x
1 model, rows 0-255 of a 257-row buffer, a host live count), a stage slab
(256 x 8 through ``rows=`` with a device live count, as the unfused loop
calls it), the eager matrices (B3: a batch of 256 x 500; B5: the 2000 test
rows x 500) and the calibration matrix (8000 x 500).  The controls: B2 on
(256, 8) scores, B4 tree and B4 lattice at stage 5 of a 64-stage plan of W
8 (cap 256, blocks of 64).  The time is ``chip_smoke.device_time_ms``'s:
the profiler's device time of ``--reps`` launches, per launch, after a
warm-up (calibration shapes: a fifth of the reps).

The long shapes (calibration, B5's eager matrix) are also timed with CUDA
events around back-to-back launches, a cross-check of the profiler.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line
``{"src": ..., "card": ..., "set": ..., "us": {name: device us per
launch}, "events_us": {name: us per launch}}``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
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
    ap.add_argument("--set", default="", help="module.NAME=VALUE,... of repro_torch.kernels")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_score_step: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.cascade_kernel import cascade_chunk_kernel
    from repro_torch.kernels.device_executor import (
        DevicePlan,
        lattice_stage_scorer,
        tree_stage_scorer,
    )
    from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
    from repro_torch.kernels.tree_kernel import gbt_scores_kernel

    for item in filter(None, args.set.split(",")):
        name, value = item.split("=")
        mod, attr = name.rsplit(".", 1)
        module = importlib.import_module(f"repro_torch.kernels.{mod}")
        if not hasattr(module, attr):
            raise SystemExit(f"bench_score_step: {mod} has no {attr}")
        setattr(module, attr, type(getattr(module, attr))(value))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T, cap, bn, stage = 500, 256, 64, 5
    us, events_us = {}, {}

    def timed(name, fn, reps=args.reps):
        us[name] = 1e3 * device_time_ms(fn, reps)

    def event_timed(name, fn, reps):
        # a cross-check of the profiler at the long shapes: CUDA events
        # around back-to-back launches (valid where a launch outlasts the
        # host's call)
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        events_us[name] = 1e3 * start.elapsed_time(end) / reps

    def t(a):
        return torch.from_numpy(a).to(dev)

    rows = torch.arange(cap, device=dev)
    nv = torch.tensor(cap, dtype=torch.int32, device=dev)
    plan = CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
        eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=8, lead_t=1,
    )
    dplan = DevicePlan.from_plan(plan)
    W, t0 = dplan.W, int(dplan.stage_t0[stage])
    eps = t(dplan.eps_pos), t(dplan.eps_neg)
    g0 = t(rng.normal(scale=0.5, size=cap).astype(np.float32))

    # B3 at exp1_adult's widths
    depth, D = 5, 14
    feats = rng.integers(0, D, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(size=(T, 1 << depth)).astype(np.float32)
    ft, tt, lt = t(feats), t(thrs), t(leaves)
    x_cal = t(rng.uniform(size=(8000, D)).astype(np.float32))
    x_buf = x_cal[: cap + 1].contiguous()
    timed("gbt_scores/sort_key_256x1", lambda: gbt_scores_kernel(
        ft, tt, lt, x_buf[:cap], block_n=bn, t0=0, t1=1, n_valid=cap))
    timed("gbt_scores/stage_256x8", lambda: gbt_scores_kernel(
        ft, tt, lt, x_buf, block_n=bn, t0=t0, t1=t0 + W, rows=rows, n_valid=nv))
    timed("gbt_scores/eager_256x500", lambda: gbt_scores_kernel(ft, tt, lt, x_buf[:cap]))
    timed("gbt_scores/calibration_8000x500",
          lambda: gbt_scores_kernel(ft, tt, lt, x_cal), max(10, args.reps // 5))
    event_timed("gbt_scores/calibration_8000x500",
                lambda: gbt_scores_kernel(ft, tt, lt, x_cal), max(10, args.reps // 5))
    # what a level costs at the calibration shape: depth 1 and exp2_nomao's 9
    for dd in (1, 9):
        fd = t(rng.integers(0, D, size=(T, dd)).astype(np.int32))
        td = t(rng.uniform(size=(T, dd)).astype(np.float32))
        ld = t(rng.normal(size=(T, 1 << dd)).astype(np.float32))
        timed(f"gbt_scores/calibration_8000x500_depth{dd}",
              lambda: gbt_scores_kernel(fd, td, ld, x_cal), max(10, args.reps // 5))
    tree = tree_stage_scorer(dplan, feats, thrs, leaves, block_n=bn, device=dev)
    xr = x_buf[rows].contiguous()
    timed("control/mega_stage_tree", lambda: mk.mega_stage_kernel(
        tree.slabs, xr, g0, stage, t0, nv, *eps, block_n=bn))

    # B5 at exp4_rw2_joint's widths
    S, Dl = 8, 30
    theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
    lfeats = np.stack([rng.choice(Dl, S, replace=False) for _ in range(T)]).astype(np.int32)
    th, lf = t(theta), t(lfeats)
    xl_cal = t(rng.uniform(size=(8000, Dl)).astype(np.float32))
    xl_buf = xl_cal[: cap + 1].contiguous()
    timed("lattice_scores/sort_key_256x1", lambda: lattice_scores_kernel(
        th, lf, xl_buf[:cap], block_n=bn, t0=0, t1=1, n_valid=cap))
    timed("lattice_scores/stage_256x8", lambda: lattice_scores_kernel(
        th, lf, xl_buf, block_n=bn, t0=t0, t1=t0 + W, rows=rows, n_valid=nv))
    for name, xs in (("eager_2000x500", xl_cal[:2000]), ("calibration_8000x500", xl_cal)):
        timed(f"lattice_scores/{name}", lambda: lattice_scores_kernel(th, lf, xs),
              max(10, args.reps // 5))
        event_timed(f"lattice_scores/{name}", lambda: lattice_scores_kernel(th, lf, xs),
                    max(10, args.reps // 5))
    lattice = lattice_stage_scorer(dplan, theta, lfeats, block_n=bn, device=dev)
    xlr = xl_buf[rows].contiguous()
    timed("control/mega_stage_lattice", lambda: mk.mega_stage_kernel(
        lattice.slabs, xlr, g0, stage, t0, nv, *eps, block_n=bn))

    # B2 on one stage's scores
    chunk = t(rng.normal(size=(cap, W)).astype(np.float32))
    ep = t(rng.uniform(0.5, 3.0, size=W).astype(np.float32))
    en = -t(rng.uniform(0.5, 3.0, size=W).astype(np.float32))
    timed("control/cascade_chunk", lambda: cascade_chunk_kernel(
        g0, chunk, ep, en, 0, block_n=bn, n_valid=nv))
    print(card, flush=True)
    print(json.dumps({"src": args.src, "card": card, "set": args.set, "us": us,
                      "events_us": events_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
