#!/usr/bin/env python3
"""Device time per launch of B4 and B7 matrix (``csrc/mega_stage.cu``) at the
exp1_adult serving shape, with B2 (``csrc/cascade_chunk.cu``) and B4 tree as
controls, and (``--paths``) the exp1 eager paths these kernels serve, for
the ``repro_torch`` of one source tree.

    python benchmarks/torch/bench_matrix_step.py [--src DIR] [--reps N] [--paths]
        [--cache FILE] [--out FILE]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed on one card, one process each, in turns (parent,
change, change, parent).  Each tree builds its kernels into its own
``build/``.  The inputs are made from fixed seeds: a cascade of T = 500
after a lead model in chunks of 8 (64 stages of W = 8, stage starts 1 + 8k),
a (257, 505) score matrix (T_pad = 505) at f32 and at bf16, a buffer of 256
lanes in blocks of 64 reading a permutation of its rows, thresholds that
retire rows mid-block.  Kernels: B4 matrix at stage 5 on the gathered
rows, and reading the matrix in place through ``rows=`` where the tree's
wrapper takes it; B7 matrix with lanes over all 64 stages and all at stage
5; the controls B2 on the stage's (256, 8) scores and B4 tree (500 depth-5
trees over 14 features) at stage 5.  The time is
``chip_smoke.device_time_ms``'s: the profiler's device time of ``--reps``
launches, per launch, after a warm-up.

``--paths`` also serves exp1_adult's eager path (``score_fn``: one B3 score
matrix a flush, then B4 matrix a stage; streaming: B3 + B7 matrix) with
``chip_smoke.eager_timing``: flush latency at batch 128 / 256 / 1024, one
batch-256 flush's device busy share and top kernels, and streaming waves at
256 and 4 requests a step.  The GBT (500 trees on the card) and its
``fit_qwyc`` (alpha 0.005, mode both; about 40 s on the host) are saved to
``--cache`` by the first process and loaded by the next, so every tree
serves the same cascade.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line
``{"src": ..., "card": ..., "us": {name: device us per launch}, "paths":
{...}}`` (the paths' summary; ``--out`` gets the whole report).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_time_ms, eager_timing  # noqa: E402  (no torch at load)


def kernel_times(mk, dev, reps: int) -> dict:
    """Device us per launch of B4 / B7 matrix at f32 and bf16, B2, B4 tree."""
    import numpy as np
    import torch

    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels.cascade_kernel import cascade_chunk_kernel
    from repro_torch.kernels.device_executor import DevicePlan, matrix_stage_scorer

    rng = np.random.default_rng(0)
    T, D, cap, bn, stage = 500, 14, 256, 64, 5
    plan = CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
        eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=8, lead_t=1,
    )
    g0 = torch.from_numpy(rng.normal(scale=0.5, size=cap).astype(np.float32)).to(dev)
    nv = torch.tensor(cap, dtype=torch.int32, device=dev)
    rows = torch.from_numpy(rng.permutation(cap + 1)[:cap]).to(dev)
    F32 = rng.normal(scale=0.4, size=(cap + 1, T)).astype(np.float32)
    in_place = "rows" in inspect.signature(mk.mega_stage_kernel).parameters
    us = {}

    def timed(name, fn):
        us[name] = 1e3 * device_time_ms(fn, reps)

    for q in ("f32", "bf16"):
        dplan = DevicePlan.from_plan(plan, quant=q)
        matrix = matrix_stage_scorer(dplan, device=dev)
        F = matrix.prepare(F32).to(matrix.slabs.x_dtype or torch.float32)
        assert F.shape == (cap + 1, 505)
        Fr = F[rows].contiguous()
        eps = torch.from_numpy(dplan.eps_pos).to(dev), torch.from_numpy(dplan.eps_neg).to(dev)
        t0 = int(dplan.stage_t0[stage])
        sfx = "" if q == "f32" else f"_{q}"
        timed(f"mega_stage_matrix{sfx}", lambda: mk.mega_stage_kernel(
            matrix.slabs, Fr, g0, stage, t0, nv, *eps, block_n=bn))
        if in_place:
            timed(f"mega_stage_matrix{sfx}/rows", lambda: mk.mega_stage_kernel(
                matrix.slabs, F, g0, stage, t0, nv, *eps, block_n=bn, rows=rows))
        spread = torch.from_numpy(rng.integers(0, dplan.S, size=cap).astype(np.int32)).to(dev)
        spread[: dplan.S] = torch.arange(dplan.S, dtype=torch.int32, device=dev)
        one = torch.full((cap,), stage, dtype=torch.int32, device=dev)
        for label, st in (("", spread), ("/one_stage", one)):
            stop = st >= dplan.S - 1
            timed(f"mega_lane_matrix{sfx}{label}", lambda: mk.mega_lane_kernel(
                matrix.slabs, F, rows, g0, st, stop, nv, *eps, block_n=bn))
    # controls: kernels this change does not touch
    dplan = DevicePlan.from_plan(plan)
    eps = torch.from_numpy(dplan.eps_pos).to(dev), torch.from_numpy(dplan.eps_neg).to(dev)
    t0 = int(dplan.stage_t0[stage])
    chunk = torch.from_numpy(F32[:cap, t0 : t0 + 8].copy()).to(dev)
    timed("cascade_chunk", lambda: cascade_chunk_kernel(
        g0, chunk, eps[0][stage], eps[1][stage], 0, block_n=bn, n_valid=nv))
    feats = rng.integers(0, D, size=(T, 5)).astype(np.int32)
    thrs = rng.uniform(size=(T, 5)).astype(np.float32)
    leaves = rng.normal(size=(T, 32)).astype(np.float32)
    slabs = mk.build_tree_slabs(dplan, feats, thrs, leaves, device=dev)
    xr = torch.from_numpy(rng.uniform(size=(cap, D)).astype(np.float32)).to(dev)
    timed("mega_stage_tree", lambda: mk.mega_stage_kernel(
        slabs, xr, g0, stage, t0, nv, *eps, block_n=bn))
    return us


def exp1_eager(cache: Path):
    """exp1_adult's GBT, its test rows and its fitted cascade (``cache``
    holds them after the first call) -> (score_fn, x_test, fit)."""
    import numpy as np
    import torch

    from repro_torch.convert import qwyc_model_from_numpy
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops

    ds = make_dataset("adult", scale=1.0)
    if not cache.exists():
        from repro_torch.core import fit_qwyc
        from repro_torch.ensembles.gbt import train_gbt

        gbt = train_gbt(ds.x_train, ds.y_train, n_trees=500, depth=5, device="cuda")
        p = {k: getattr(gbt, k).cpu().numpy() for k in ("feats", "thrs", "leaves")}
        F = ops.gbt_scores(*(torch.from_numpy(p[k]).cuda() for k in ("feats", "thrs", "leaves")),
                           torch.from_numpy(ds.x_train).cuda())
        fit = fit_qwyc(F.cpu().numpy().astype(np.float64), beta=-gbt.base_score, alpha=0.005,
                       mode="both")
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, **p, order=fit.order, eps_pos=fit.eps_pos, eps_neg=fit.eps_neg,
                 beta=fit.beta, costs=fit.costs, alpha=fit.alpha, mode=fit.mode)
    z = np.load(cache)
    feats, thrs, leaves = (torch.from_numpy(z[k]).cuda() for k in ("feats", "thrs", "leaves"))
    fit = qwyc_model_from_numpy(z["order"], z["eps_pos"], z["eps_neg"], float(z["beta"]),
                                z["costs"], float(z["alpha"]), str(z["mode"]))
    return (lambda x: ops.gbt_scores(feats, thrs, leaves, x)), ds.x_test, fit


def path_times(cache: Path) -> dict:
    from chip_smoke import STREAM_CAP, STREAM_WINDOW
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    score_fn, x, fit = exp1_eager(cache)

    def batch(**kw):
        kw.setdefault("batch_size", 256)
        return QWYCServer(fit, exec_backend="device", device="cuda", backend="sorted-kernel",
                          chunk_t=8, score_fn=score_fn, **kw)

    def stream():
        return StreamingServer(fit, exec_backend="device", device="cuda", batch_size=STREAM_CAP,
                               window=STREAM_WINDOW, chunk_t=8, block_n=64, score_fn=score_fn)

    return eager_timing(batch, stream, x, "exp1_adult eager")


def _short(name: str) -> str:
    """A profiled kernel's name without its leading namespaces and its
    arguments, cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.sub(r"^(?:\w+::)+", "", name.split("(")[0])[:60]


def summary(paths: dict) -> dict:
    """The numbers PERF.md reads: walls, busy shares, the port's kernels
    and the top few others, by short name."""
    p = paths["profile_flush256"]
    out = {f"flush_{k}": [v["median_ms"], v["p90_ms"]] for k, v in paths["flush_latency"].items()}
    out["flush256_busy_us"], out["flush256_busy_share"] = p["device_busy_us"], p["busy_share"]
    out["flush256_port"] = {_short(k): v for k, v in p["port"].items()}
    out["flush256_top"] = [(_short(k), round(v[0], 1), v[1]) for k, v in p["top"][:6]]
    for rate, st in paths["stream"].items():
        out[f"wave_{rate}"] = dict(
            median_ms=st["wave_median_ms"], p90_ms=st["wave_p90_ms"],
            step_median_ms=st["step_median_ms"], busy_us=st["device_busy_us"],
            busy_share=st["busy_share"], port={_short(k): v for k, v in st["port"].items()},
            top=[(_short(k), round(v[0], 1), v[1]) for k, v in st["top"][:4]],
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--cache", default=str(ROOT / "build" / "bench_matrix_exp1.npz"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_matrix_step: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import megakernel as mk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    us = kernel_times(mk, torch.device("cuda"), args.reps)
    report = {"src": args.src, "card": card, "us": us}
    if args.paths:
        paths = path_times(Path(args.cache))
        report["paths"] = summary(paths)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(dict(report, paths_full=paths), default=str))
    print(card, flush=True)
    print(json.dumps(report, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
