#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run on failure:

1. Environment: Python, torch and CUDA versions, the card and its power
   limit (``nvidia-smi``).
2. Build: ``nvcc`` compiles every kernel source of ``src/repro_torch/csrc``
   (one process per source, all at once) into ``build/repro_torch_kernels``.
3. Each kernel (B1 cascade, B2 cascade_chunk, B3 gbt_scores, B4 mega_stage
   tree, matrix and lattice, B5 lattice_scores, B6 cascade_lane, B7
   mega_lane tree, matrix and lattice) against its plain PyTorch version on
   the card, at the main paths' shapes and at the edges (n_valid 0, a
   ragged last block, ±inf padded columns, rows retiring mid-block, lattice
   inputs at the cube's corners, rows that never exit, the ±inf "full
   evaluation" thresholds; for B6 and B7 lanes at every stage in one
   block and last-stage lanes): every output ``torch.equal``.
4. The first main path, paper experiment 1 (exp1_adult) at full width: the
   adult dataset (8000 train / 2000 test rows, D = 14), ``train_gbt`` with
   T = 500 depth-5 trees, the calibration matrix with B3, ``fit_qwyc`` at
   alpha = 0.005 (mode ``both``), then ``QWYCServer`` (device backend,
   sorted-kernel, batch 256, chunk_t 8) over the test rows.  The verdicts, models
   evaluated and full scores equal the same server run with device="cpu"
   (the plain versions) and the ``evaluate_cascade`` oracle; megakernel on
   equals off (results and billing).
4b. The second main path, paper experiment 4 (exp4_rw2_joint) at full
   width: rw2 (8000 / 2000 rows, D = 30), T = 500 lattices over S = 8
   features trained jointly (300 AdamW steps on the card), the calibration
   matrix with B5, ``fit_qwyc`` (alpha 0.005, neg_only).  Eager: B5 on the
   test rows, the columns ordered, ``ops.cascade_decide`` (B1), equal to
   ``evaluate_cascade``.  Served: the lattice server fused (B4 lattice) and
   unfused (B5 + B2), both equal to the same server on the CPU and to the
   eager B1 verdicts.
4c. Streaming admission: both cells' ensembles and cascades (no new fit)
   served by ``StreamingServer`` (capacity 256, window 1024, chunk_t 8,
   block 64) over the test rows under the seed-2028 Poisson trace at 256
   and 4.0 requests per stage step: fused (B7), unfused (lane_fn + B6),
   eager for exp1 (B3 score matrix + B7 matrix) and on the CPU, all equal
   in results and every wave's timeline, verdicts equal to
   ``evaluate_cascade``, ``g_final`` equal bit for bit to phase 4/4b's
   batch server, and (at the heavy rate) occupancy above the flush
   server's at the same capacity.
   In phases 4-4c the launch counts are set to 0 just before each path and
   read just after it: each path must have launched exactly its own kernels
   (a streaming path its B6 or B7 once per step enqueued).
5. Times, after a warm-up: the per-flush latency of both servers at batch
   128 / 256 / 1024, fused and unfused (host clock, median and p90 of 100
   flushes), the device's busy share of a batch-256 flush (profiler device
   time over the unprofiled median flush); the streaming servers' drains
   (requests/s, wave and step wall times, steps and syncs per wave,
   PyTorch operator calls per step, one wave's busy share); and each
   kernel's device time per launch (profiler) at its main-path shape
   beside its plain version's and its bound.

Prints the card, then the ``kernels`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# flush-latency samples per (batch, path), after N_WARM unrecorded flushes
N_WARM, N_FLUSH = 5, 100
# phase 4c's streaming servers: lane capacity, admission ring, arrival rates
# (requests per stage step: the streaming benchmark's heavy traffic at the
# capacity, and the CLI's default), the protocol's trace seed; phase 5
# times N_DRAINS drains of the test rows at the heavy rate
STREAM_CAP, STREAM_WINDOW, STREAM_RATES = 256, 1024, (256.0, 4.0)
ARRIVAL_SEED = 2028
N_DRAINS = 5
# exp1's cascade modes: Filter-and-Score (neg_only) is served by the lattice
# phase, and exp1's own neg_only fit (a host fit_qwyc of about 25 s) is left
# out to keep the run near 300 s
GBT_MODES = ("both",)

KERNELS = {
    # name: (source, TPU kernel it replaces, the served path whose launches
    # the kernels line reports)
    "cascade": ("src/repro_torch/csrc/cascade.cu",
                "src/repro/kernels/cascade_kernel.py:127", "lattice_eager/neg_only"),
    "cascade_chunk": ("src/repro_torch/csrc/cascade_chunk.cu",
                      "src/repro/kernels/cascade_kernel.py:346", "unfused/both"),
    "gbt_scores": ("src/repro_torch/csrc/tree_scores.cu",
                   "src/repro/kernels/tree_kernel.py:62", "fused/both"),
    "mega_stage_tree": ("src/repro_torch/csrc/mega_stage.cu",
                        "src/repro/kernels/megakernel.py:556", "fused/both"),
    "mega_stage_matrix": ("src/repro_torch/csrc/mega_stage.cu",
                          "src/repro/kernels/megakernel.py:556", "eager/both"),
    "mega_stage_lattice": ("src/repro_torch/csrc/mega_stage.cu",
                           "src/repro/kernels/megakernel.py:556",
                           "lattice_fused/neg_only"),
    "lattice_scores": ("src/repro_torch/csrc/lattice_scores.cu",
                       "src/repro/kernels/lattice_kernel.py:60",
                       "lattice_fused/neg_only"),
    "cascade_lane": ("src/repro_torch/csrc/cascade_lane.cu",
                     "src/repro/kernels/cascade_kernel.py:277", "stream_unfused/both/r256"),
    "mega_lane_tree": ("src/repro_torch/csrc/mega_stage.cu",
                       "src/repro/kernels/megakernel.py:724", "stream_fused/both/r256"),
    "mega_lane_matrix": ("src/repro_torch/csrc/mega_stage.cu",
                         "src/repro/kernels/megakernel.py:724", "stream_eager/both/r256"),
    "mega_lane_lattice": ("src/repro_torch/csrc/mega_stage.cu",
                          "src/repro/kernels/megakernel.py:724",
                          "lattice_stream_fused/neg_only/r256"),
}
# the kernels each path of phase 4 must launch; no other kernel may
PATH_KERNELS = {
    "calibration": {"gbt_scores"},  # the (N, 500) score matrices
    "fused": {"gbt_scores", "mega_stage_tree"},  # default: sort key + B4 tree
    "unfused": {"gbt_scores", "cascade_chunk"},  # megakernel=False: B3 + B2
    "cpu": set(),  # device="cpu": the plain versions only
    "eager": {"gbt_scores", "mega_stage_matrix"},  # score_fn matrix + B4 matrix
    "lattice_calibration": {"lattice_scores"},  # the (N, 500) score matrix
    "lattice_eager": {"lattice_scores", "cascade"},  # B5 test matrix + B1
    "lattice_fused": {"lattice_scores", "mega_stage_lattice"},  # sort key + B4
    "lattice_unfused": {"lattice_scores", "cascade_chunk"},  # B5 + B2
    "lattice_cpu": set(),
    # phase 4c, streaming admission
    "stream_fused": {"mega_lane_tree"},  # B7 tree
    "stream_unfused": {"cascade_lane"},  # lane_fn (plain PyTorch) + B6
    "stream_eager": {"gbt_scores", "mega_lane_matrix"},  # score_fn matrix + B7 matrix
    "stream_cpu": set(),
    "lattice_stream_fused": {"mega_lane_lattice"},  # B7 lattice
    "lattice_stream_unfused": {"cascade_lane"},  # lane_fn + B6
    "lattice_stream_cpu": set(),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


class Check:
    """Exact comparisons; records the largest abs error per kernel."""

    def __init__(self):
        self.max_err: dict[str, float] = {}

    def equal(self, kernel: str, what: str, a, b) -> None:
        import torch

        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(
                f"{kernel} {what}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}"
            )
        if a.numel():
            diff = (a.double() - b.double()).abs()
            diff = torch.where(a == b, 0.0, diff)  # ±inf == ±inf
            err = float(diff.max())
        else:
            err = 0.0
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {what}: kernel != plain (max abs err {err})")


def counted(launches: dict, path: str, fn):
    """``fn()`` with every launch count set to 0 just before it; the counts
    are read just after it, stored as ``launches[path]``, and must name
    exactly the kernels of ``PATH_KERNELS`` for the path."""
    import torch

    from repro_torch.kernels import _build

    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = PATH_KERNELS[path.split("/")[0]]
    if set(got) != want:
        raise AssertionError(f"{path}: launched {got}, expected exactly {sorted(want)}")
    launches[path] = got
    return out


def device_work(prof) -> dict:
    """{name: (device us, count)} of the kernels and copies a profile saw."""
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and e.device_type.name == "CUDA":
            out[e.key] = (float(dt), int(e.count))
    return out


def profile_device(window, prepare=None, tries: int = 3) -> dict:
    """``device_work`` of one profiled run of ``window()`` (after
    ``prepare()``, unprofiled).  On this card the profiler now and then
    returns no device events for a window (seen once in a phase-5 window
    that the run before had timed): the window is profiled again, at most
    ``tries`` times in all, and the run fails if no attempt sees device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window()
            torch.cuda.synchronize()
        work = device_work(prof)
        if work:
            return work
        log(f"[phase 5] profiler attempt {attempt + 1}/{tries} saw no device time")
    raise AssertionError(f"the profiler saw no device time in {tries} attempts")


def device_time_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``: the profiler's sum over every
    kernel and copy it launched, over ``reps`` calls, per call, after a
    warm-up.  The host's time between launches is left out: at serving
    shapes a call costs the host tens of times what it costs the card."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(reps):
            fn()

    total_us = sum(us for us, _ in profile_device(window).values())
    return total_us / reps / 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_plan(rng, T: int, chunk_t: int, lead_t: int, lo=1.0, hi=4.0):
    import numpy as np

    from repro_torch.core.executor import CascadePlan

    return CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(lo, hi, size=T),
        eps_neg=-rng.uniform(lo, hi, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=chunk_t, lead_t=lead_t,
    )


def phase_kernels(check: Check) -> dict:
    """Phase 3: every kernel against its plain version on the card.
    Returns the main-path-shaped inputs phase 5 times."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import (
        cascade_chunk_kernel,
        cascade_chunk_plain,
        cascade_kernel,
        cascade_lane_kernel,
        cascade_lane_plain,
        cascade_plain,
    )
    from repro_torch.kernels.device_executor import (
        DevicePlan,
        lattice_stage_scorer,
        matrix_stage_scorer,
        tree_stage_scorer,
    )
    from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
    from repro_torch.kernels.megakernel import (
        mega_lane_kernel,
        mega_lane_plain,
        mega_stage_kernel,
        mega_stage_plain,
    )
    from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    i32 = torch.int32

    def nv(v):
        return torch.tensor(v, dtype=i32, device=dev)

    # B2 at (cap 256, W 8); t0 > 0; padded columns; n_valid edges
    m, ct = 256, 8
    g0 = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
    chunk = torch.from_numpy(rng.normal(size=(m, ct)).astype(np.float32)).to(dev)
    ep = torch.from_numpy(rng.uniform(0.5, 3.0, size=ct).astype(np.float32)).to(dev)
    en = -torch.from_numpy(rng.uniform(0.5, 3.0, size=ct).astype(np.float32)).to(dev)
    ep_pad, en_pad = ep.clone(), en.clone()
    ep_pad[5:], en_pad[5:] = float("inf"), float("-inf")
    chunk_pad = chunk.clone()
    chunk_pad[:, 5:] = 0.0
    for label, (s, p, n_), n_valid in [
        ("full", (chunk, ep, en), None), ("nv=256", (chunk, ep, en), nv(256)),
        ("nv=0", (chunk, ep, en), nv(0)), ("ragged nv=200", (chunk, ep, en), nv(200)),
        ("±inf padded", (chunk_pad, ep_pad, en_pad), nv(131)),
    ]:
        got = cascade_chunk_kernel(g0, s, p, n_, 17, block_n=64, n_valid=n_valid)
        want = cascade_chunk_plain(g0, s, p, n_, 17, n_valid=n_valid)
        for k, (a, b) in enumerate(zip(got, want)):
            check.equal("cascade_chunk", f"{label} output {k}", a, b)
        assert int(got[3].gt(0).sum()) > 0 or label == "nv=0"
    log("[phase 3] B2 cascade_chunk == plain (5 cases)")

    # B3 at the calibration shape (8000 x 500) and a stage slab (256 x 8)
    T, depth, d = 500, 5, 14
    feats = torch.from_numpy(rng.integers(0, d, size=(T, depth)).astype(np.int32)).to(dev)
    thrs = torch.from_numpy(rng.uniform(size=(T, depth)).astype(np.float32)).to(dev)
    leaves = torch.from_numpy(rng.normal(size=(T, 1 << depth)).astype(np.float32)).to(dev)
    x_cal = torch.from_numpy(rng.uniform(size=(8000, d)).astype(np.float32)).to(dev)
    check.equal(
        "gbt_scores", "calibration 8000x500",
        gbt_scores_kernel(feats, thrs, leaves, x_cal),
        gbt_scores_plain(feats, thrs, leaves, x_cal),
    )
    x_buf = torch.from_numpy(rng.uniform(size=(257, d)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.permutation(256)).to(dev)
    rows[200:] = 256  # trash lanes read the trash row
    for label, kw in [
        ("stage slab", dict(t0=9, t1=17, rows=rows, n_valid=nv(256))),
        ("ragged nv=100", dict(t0=1, t1=9, rows=rows, n_valid=nv(100))),
        ("nv=0", dict(t0=0, t1=8, rows=rows, n_valid=nv(0))),
        ("sort key, host nv", dict(t0=0, t1=1, n_valid=200)),
    ]:
        check.equal(
            "gbt_scores", label,
            gbt_scores_kernel(feats, thrs, leaves, x_buf, block_n=64, **kw),
            gbt_scores_plain(feats, thrs, leaves, x_buf, block_n=64, **kw),
        )
    log("[phase 3] B3 gbt_scores == plain (5 cases)")

    # B4: exp1's plan geometry (T 500, chunk 8, lead 1 -> S 64, W 8)
    plan = random_plan(rng, T, 8, 1)
    dplan = DevicePlan.from_plan(plan)
    assert (dplan.S, dplan.W) == (64, 8)
    fo, to, lo = feats.cpu().numpy(), thrs.cpu().numpy(), leaves.cpu().numpy()
    tree = tree_stage_scorer(dplan, fo, to, lo, block_n=64, device=dev)
    matrix = matrix_stage_scorer(dplan, device=dev)
    F = matrix.prepare(rng.normal(size=(257, T)).astype(np.float32))
    eps_pos = torch.from_numpy(dplan.eps_pos).to(dev)
    eps_neg = torch.from_numpy(dplan.eps_neg).to(dev)
    g_buf = torch.from_numpy(rng.normal(scale=0.5, size=256).astype(np.float32)).to(dev)
    n_cases = 0
    for variant, scorer, xop in (("tree", tree, x_buf), ("matrix", matrix, F)):
        xr = xop[rows].contiguous()
        for stage in (0, 5, 63):  # lead stage, a full stage, the ragged last one
            for n_valid in (nv(256), nv(0), nv(100), nv(200)):
                t0 = int(dplan.stage_t0[stage])
                args = (scorer.slabs, xr, g_buf, stage, t0, n_valid, eps_pos, eps_neg)
                got = mega_stage_kernel(*args, block_n=64)
                want = mega_stage_plain(*args, block_n=64)
                for k, (a, b) in enumerate(zip(got, want)):
                    check.equal(f"mega_stage_{variant}", f"stage {stage} output {k}", a, b)
                n_cases += 1
    log(f"[phase 3] B4 mega_stage tree + matrix == plain ({n_cases} cases)")

    # B5: exp4's widths (D 30, S 8, T 500), the calibration shape and stage
    # slabs, S in {1, 4, 8}; rows at the cube's corners (inputs 0 and 1)
    D, LS = 30, 8

    def lattices(S):
        theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
        lf = np.stack([rng.choice(D, S, replace=False) for _ in range(T)]).astype(np.int32)
        return torch.from_numpy(theta).to(dev), torch.from_numpy(lf).to(dev)

    theta8, lfeats8 = lattices(LS)
    xl = rng.uniform(size=(8000, D)).astype(np.float32)
    xl[:300] = np.round(xl[:300])  # corners
    xl_cal = torch.from_numpy(xl).to(dev)
    check.equal(
        "lattice_scores", "calibration 8000x500 S=8",
        lattice_scores_kernel(theta8, lfeats8, xl_cal),
        lattice_scores_plain(theta8, lfeats8, xl_cal),
    )
    xl_buf = xl_cal[:257].contiguous()  # 257: the trash row at index 256
    n_cases = 1
    for S in (1, 4, LS):
        th, lf = (theta8, lfeats8) if S == LS else lattices(S)
        for label, kw in [
            ("stage slab", dict(t0=9, t1=17, rows=rows, n_valid=nv(256))),
            ("ragged nv=100", dict(t0=1, t1=9, rows=rows, n_valid=nv(100))),
            ("nv=0", dict(t0=0, t1=8, rows=rows, n_valid=nv(0))),
            ("sort key, host nv", dict(t0=0, t1=1, n_valid=200)),
            ("last lattices, ragged rows", dict(t0=T - 5, rows=rows[:131])),
        ]:
            check.equal(
                "lattice_scores", f"S={S} {label}",
                lattice_scores_kernel(th, lf, xl_buf, block_n=64, **kw),
                lattice_scores_plain(th, lf, xl_buf, block_n=64, **kw),
            )
            n_cases += 1
    log(f"[phase 3] B5 lattice_scores == plain ({n_cases} cases)")

    # B4 lattice: the exp4 plan geometry, thresholds that retire rows
    # mid-block, the ragged last stage's ±inf padded columns
    lplan = DevicePlan.from_plan(random_plan(rng, T, 8, 1, lo=0.3, hi=1.5))
    lattice = lattice_stage_scorer(
        lplan, theta8.cpu().numpy(), lfeats8.cpu().numpy(), block_n=64, device=dev
    )
    leps = (torch.from_numpy(lplan.eps_pos).to(dev), torch.from_numpy(lplan.eps_neg).to(dev))
    xr = xl_buf[rows].contiguous()
    n_cases, mid_block = 0, 0
    for stage in (0, 5, 63):
        for n_valid in (nv(256), nv(0), nv(100), nv(200)):
            t0 = int(lplan.stage_t0[stage])
            args = (lattice.slabs, xr, g_buf, stage, t0, n_valid, *leps)
            got = mega_stage_kernel(*args, block_n=64)
            want = mega_stage_plain(*args, block_n=64)
            for k, (a, b) in enumerate(zip(got, want)):
                check.equal("mega_stage_lattice", f"stage {stage} output {k}", a, b)
            live = got[3][: int(n_valid)]
            mid_block += int(bool((live > 0).any() and (live == 0).any()))
            n_cases += 1
    if not mid_block:
        raise AssertionError("B4 lattice check: no case retired rows mid-block")
    log(f"[phase 3] B4 mega_stage lattice == plain ({n_cases} cases, "
        f"{mid_block} retiring rows mid-block)")

    # B1 at (2000, 500): T not a multiple of chunk_t, rows that never exit,
    # the ±inf "full evaluation" thresholds
    Fb = rng.normal(scale=0.3, size=(2000, T)).astype(np.float32)
    Fb[:64] = 0.0  # never exit
    Fb_t = torch.from_numpy(Fb).to(dev)
    b_ep = torch.from_numpy(rng.uniform(1.0, 4.0, size=T).astype(np.float32)).to(dev)
    b_en = -torch.from_numpy(rng.uniform(1.0, 4.0, size=T).astype(np.float32)).to(dev)
    inf = torch.full((T,), float("inf"), device=dev)
    for label, (F_, p_, n_, beta, ct) in [
        ("qwyc-like", (Fb_t, b_ep, b_en, 0.0, 8)),
        ("full evaluation ±inf", (Fb_t, inf, -inf, 0.0, 8)),
        ("T=499, chunk 7, beta 0.1", (Fb_t[:, :499].contiguous(), b_ep[:499], b_en[:499], 0.1, 7)),
    ]:
        got = cascade_kernel(F_, p_, n_, beta, chunk_t=ct)
        want = cascade_plain(F_, p_, n_, beta, chunk_t=ct)
        for k, (a, b) in enumerate(zip(got, want)):
            check.equal("cascade", f"{label} output {k}", a, b)
        Tl = F_.shape[1]
        if not bool((got[1][:64] == Tl).all()):
            raise AssertionError(f"B1 {label}: a zero row exited")
    log("[phase 3] B1 cascade == plain (3 cases)")

    # B6 at (256, 8): each lane's threshold row gathered at its own stage of
    # exp1's plan geometry (the ragged last stage's ±inf padded columns
    # included, their scores zeroed as the executor zeroes them)
    S = dplan.S
    stage = torch.from_numpy(rng.integers(0, S, size=256).astype(np.int32)).to(dev)
    stage[:S] = torch.arange(S, dtype=torch.int32, device=dev)  # every stage in block 0
    col_valid = torch.from_numpy(dplan.col_valid).to(dev)
    lane_scores = torch.where(col_valid[stage], chunk, 0.0)
    lep, len_ = eps_pos[stage], eps_neg[stage]
    n_cases = 0
    for label, n_valid in [("nv=256", nv(256)), ("nv=0", nv(0)), ("ragged nv=200", nv(200)),
                           ("host nv", 131), ("all", None)]:
        got = cascade_lane_kernel(g0, lane_scores, lep, len_, block_n=64, n_valid=n_valid)
        want = cascade_lane_plain(g0, lane_scores, lep, len_, n_valid=n_valid)
        for k, (a, b) in enumerate(zip(got, want)):
            check.equal("cascade_lane", f"{label} output {k}", a, b)
        n_cases += 1
    if not bool((got[3] > 0).any() and (got[1] > 0).any()):
        raise AssertionError("B6 check: no lane exited, or every lane exited")
    log(f"[phase 3] B6 cascade_lane == plain ({n_cases} cases)")

    # B7 at cap 256, W 8, block 64: lanes over all S stages in block 0,
    # last-stage (stop) lanes, rows retiring mid-block, trash rows past
    # n_valid, the ragged last stage; tree and matrix on exp1's geometry,
    # lattice on exp4's
    stop = stage >= S - 1
    n_cases, mid_block = 0, 0
    for variant, slabs, xop, (ep_t, en_t) in (
        ("tree", tree.slabs, x_buf, (eps_pos, eps_neg)),
        ("matrix", matrix.slabs, F, (eps_pos, eps_neg)),
        ("lattice", lattice.slabs, xl_buf, leps),
    ):
        for n_valid in (nv(256), nv(0), nv(100), nv(200), 64):
            args = (slabs, xop, rows, g_buf, stage, stop, n_valid, ep_t, en_t)
            got = mega_lane_kernel(*args, block_n=64)
            want = mega_lane_plain(*args, block_n=64)
            for k, (a, b) in enumerate(zip(got, want)):
                check.equal(f"mega_lane_{variant}", f"nv {int(n_valid)} output {k}", a, b)
            live = got[3][: int(n_valid)]
            mid_block += int(bool((live > 0).any() and (live == 0).any()))
            n_cases += 1
        stop_ran_out = bool(((got[1] == 1) & stop[:256]).any())
        if not stop_ran_out:
            raise AssertionError(f"B7 {variant} check: no last-stage lane ran out active")
    if mid_block < 9:
        raise AssertionError(f"B7 check: only {mid_block} cases retired rows mid-block")
    log(f"[phase 3] B7 mega_lane tree + matrix + lattice == plain ({n_cases} cases, "
        f"{mid_block} retiring rows mid-block)")
    torch.cuda.synchronize()
    return dict(
        chunk=(g0, chunk, ep, en), forest=(feats, thrs, leaves), x_cal=x_cal,
        x_buf=x_buf, rows=rows, dplan=dplan, tree=tree, matrix=matrix, F=F,
        eps=(eps_pos, eps_neg), g_buf=g_buf, lat=(theta8, lfeats8), xl_cal=xl_cal,
        xl_buf=xl_buf, lplan=lplan, lattice=lattice, leps=leps,
        lanes=dict(stage=stage, stop=stop, scores=lane_scores, eps=(lep, len_)),
    )


def serve(server, x) -> list[dict]:
    for row in x:
        server.submit(row)
    return server.drain()


def phase_main_path(report: dict, launches: dict) -> dict:
    """Phase 4: exp1_adult end to end on the card, held against the CPU.
    Fills ``launches`` with each path's own launch counts."""
    import numpy as np
    import torch

    from repro_torch.api.scorers import TreeScorer
    from repro_torch.core import evaluate_cascade, fit_qwyc
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.ensembles.gbt import train_gbt
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import QWYCServer

    t = time.perf_counter()
    ds = make_dataset("adult", scale=1.0)
    gbt = train_gbt(ds.x_train, ds.y_train, n_trees=500, depth=5, device="cuda")
    log(f"[phase 4] adult {ds.x_train.shape}/{ds.x_test.shape}; train_gbt T=500 "
        f"depth=5 in {time.perf_counter() - t:.1f}s")
    feats, thrs, leaves = gbt.feats, gbt.thrs, gbt.leaves
    beta = -gbt.base_score

    def score_fn(x):
        return ops.gbt_scores(feats, thrs, leaves, x)

    def matrices():
        return tuple(
            score_fn(torch.from_numpy(x).cuda()).cpu().numpy().astype(np.float64)
            for x in (ds.x_train, ds.x_test)
        )

    t = time.perf_counter()
    F_train, F_test = counted(launches, "calibration", matrices)
    log(f"[phase 4] calibration matrix {F_train.shape} with B3 in "
        f"{time.perf_counter() - t:.2f}s; launches {launches['calibration']}")
    fits = {}
    for mode in GBT_MODES:
        t = time.perf_counter()
        fits[mode] = fit_qwyc(F_train, beta=beta, alpha=0.005, mode=mode)
        log(f"[phase 4] fit_qwyc(alpha=0.005, mode={mode}) in "
            f"{time.perf_counter() - t:.1f}s: train mean models "
            f"{fits[mode].train_mean_models:.2f}/500")

    def server(mode, device, **kw):
        kw.setdefault("scorer", TreeScorer(feats, thrs, leaves))
        kw.setdefault("batch_size", 256)
        return QWYCServer(
            fits[mode], exec_backend="device", device=device, backend="sorted-kernel",
            chunk_t=8, **kw,
        )

    out, per_flush, batch_g = {}, {}, {}

    def served(path, srv):
        res = counted(launches, path, lambda: serve(srv, ds.x_test))
        n = srv.stats.n_batches
        per_flush[path] = {k: v / n for k, v in launches[path].items()}
        log(f"[phase 4] launches {path}: {launches[path]} over {n} flushes")
        return res

    for mode in GBT_MODES:
        t = time.perf_counter()
        card = server(mode, "cuda")
        res_card = served(f"fused/{mode}", card)
        wall = time.perf_counter() - t
        cpu = server(mode, "cpu")
        res_cpu = served(f"cpu/{mode}", cpu)
        if res_card != res_cpu:  # verdicts, models evaluated, full scores
            raise AssertionError(f"{mode}: card results != CPU (plain) results")
        off = server(mode, "cuda", backend_opts={"megakernel": False})
        res_off = served(f"unfused/{mode}", off)
        if res_off != res_card:
            raise AssertionError(f"{mode}: megakernel off != on")
        for k in ("scores_computed", "chunk_survivors", "models_evaluated"):
            a, b, c = (getattr(s.stats, k) for s in (card, off, cpu))
            if not a == b == c:
                raise AssertionError(f"{mode}: {k} differs: on {a}, off {b}, cpu {c}")
        ev = evaluate_cascade(fits[mode], F_test)
        dec = np.array([r["decision"] for r in res_card])
        ex = np.array([r["models_evaluated"] for r in res_card])
        if not (np.array_equal(dec, ev["decisions"]) and np.array_equal(ex, ev["exit_step"])):
            raise AssertionError(f"{mode}: served verdicts != evaluate_cascade oracle")
        fs = [r["full_score"] for r in res_card if "full_score" in r]
        if not np.isfinite(fs).all() or len(res_card) != 2000:
            raise AssertionError(f"{mode}: non-finite full scores or missing results")
        st = card.stats
        acc = float(np.mean(dec == (ds.y_test > 0)))
        batch_g[mode] = np.concatenate([r.g_final for r in card.flush_results])
        out[mode] = dict(
            mean_models=st.mean_models, speedup=st.speedup,
            scores_computed=st.scores_computed, scores_possible=st.scores_possible,
            n_batches=st.n_batches, test_acc=acc, wall_s=wall,
            stages_run=len(st.chunk_survivors), full_scores=len(fs),
            train_mean_models=fits[mode].train_mean_models,
        )
        log(f"[phase 4] serve {mode}: {st.n_requests} requests in {st.n_batches} "
            f"flushes, mean models {st.mean_models:.3f}/500, scores computed "
            f"{st.scores_computed}/{st.scores_possible}, test acc {acc:.4f}; "
            f"== CPU plain, == megakernel off, == evaluate_cascade")

    # the eager path: the score matrix per flush through the matrix variant
    eager = server("both", "cuda", scorer=None, score_fn=score_fn)
    res_eager = served("eager/both", eager)
    ev = evaluate_cascade(fits["both"], F_test)
    if [r["models_evaluated"] for r in res_eager] != ev["exit_step"].tolist() or [
        r["decision"] for r in res_eager
    ] != ev["decisions"].tolist():
        raise AssertionError("eager (matrix megakernel) verdicts != oracle")
    log(f"[phase 4] eager serve (matrix variant): == oracle, diff vs full "
        f"{eager.stats.diff_rate:.4f} (alpha=0.005)")
    report["main_path"] = out
    report["launches"] = launches
    report["launches_per_flush"] = per_flush
    return dict(ds=ds, fits=fits, gbt=gbt, score_fn=score_fn, server=server,
                F_test=F_test, batch_g=batch_g)


def phase_lattice_path(report: dict, launches: dict) -> dict:
    """Phase 4b: exp4_rw2_joint end to end on the card, eager (B5 + B1) and
    served (fused and unfused), held against the CPU and against each
    other.  Fills ``launches`` with each path's own launch counts."""
    import numpy as np
    import torch

    from repro_torch.api.scorers import LatticeScorer
    from repro_torch.core import evaluate_cascade, fit_qwyc
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.ensembles.lattice import init_lattice_ensemble, train_lattice_ensemble
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import QWYCServer

    T, S, mode = 500, 8, "neg_only"
    t = time.perf_counter()
    ds = make_dataset("rw2", scale=1.0)
    lat = init_lattice_ensemble(T, ds.D, S=S, seed=0, device="cuda")
    lat = train_lattice_ensemble(lat, ds.x_train, ds.y_train, mode="joint", steps=300)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    log(f"[phase 4b] rw2 {ds.x_train.shape}/{ds.x_test.shape}; train_lattice_ensemble "
        f"T={T} S={S} joint, 300 steps on the card in {train_s:.1f}s")
    theta, feats = lat["theta"], lat["feats"]
    if not bool(torch.isfinite(theta).all()):
        raise AssertionError("lattice training gave non-finite vertex values")
    x_train = torch.from_numpy(ds.x_train).cuda()
    x_test = torch.from_numpy(ds.x_test).cuda()

    t = time.perf_counter()
    F_train = counted(
        launches, "lattice_calibration",
        lambda: ops.lattice_scores(theta, feats, x_train).cpu().numpy().astype(np.float64),
    )
    log(f"[phase 4b] calibration matrix {F_train.shape} with B5 in "
        f"{time.perf_counter() - t:.2f}s; launches {launches['lattice_calibration']}")
    t = time.perf_counter()
    fit = fit_qwyc(F_train, beta=0.0, alpha=0.005, mode=mode)
    fit_s = time.perf_counter() - t
    log(f"[phase 4b] fit_qwyc(alpha=0.005, mode={mode}) in {fit_s:.1f}s: train mean "
        f"models {fit.train_mean_models:.2f}/{T}, train diff {fit.train_diff_rate:.4f}")

    # eager Filter-and-Score: score the test matrix, order it, decide it whole
    order = torch.as_tensor(fit.order, device="cuda")
    # thresholds are by cascade position; B1 casts them to f32
    eps_pos = torch.as_tensor(fit.eps_pos, device="cuda")
    eps_neg = torch.as_tensor(fit.eps_neg, device="cuda")

    def eager():
        F = ops.lattice_scores(theta, feats, x_test)
        dec, ex = ops.cascade_decide(F[:, order].contiguous(), eps_pos, eps_neg, fit.beta)
        return F.cpu().numpy(), dec.cpu().numpy(), ex.cpu().numpy()

    F_test, dec_eager, ex_eager = counted(launches, "lattice_eager/neg_only", eager)
    ev = evaluate_cascade(fit, F_test.astype(np.float64))
    if not (np.array_equal(dec_eager.astype(bool), ev["decisions"])
            and np.array_equal(ex_eager, ev["exit_step"])):
        raise AssertionError("eager B1 verdicts != evaluate_cascade")
    y = ds.y_test > 0
    log(f"[phase 4b] eager B5 + B1: == evaluate_cascade; mean models "
        f"{ex_eager.mean():.3f}/{T}, diff vs full {ev['diff_rate']:.4f}, test acc "
        f"{np.mean(dec_eager.astype(bool) == y):.4f}; launches "
        f"{launches['lattice_eager/neg_only']}")

    def server(device, **kw):
        kw.setdefault("batch_size", 256)
        return QWYCServer(
            fit, scorer=LatticeScorer(theta, feats), exec_backend="device",
            device=device, backend="sorted-kernel", chunk_t=8, **kw,
        )

    per_flush = report.setdefault("launches_per_flush", {})
    res, srvs = {}, {}
    for path, device, opts in (
        ("lattice_fused", "cuda", {}),
        ("lattice_unfused", "cuda", {"megakernel": False}),
        ("lattice_cpu", "cpu", {}),
    ):
        key = f"{path}/{mode}"
        t = time.perf_counter()
        srv = srvs[path] = server(device, backend_opts=opts)
        res[path] = counted(launches, key, lambda: serve(srv, ds.x_test))
        nb, n_stages = srv.stats.n_batches, srv._dev[0].dplan.S
        per_flush[key] = {k: v / nb for k, v in launches[key].items()}
        want = {
            "lattice_fused": {"lattice_scores": nb, "mega_stage_lattice": nb * n_stages},
            "lattice_unfused": {"lattice_scores": nb * (1 + n_stages),
                                "cascade_chunk": nb * n_stages},
            "lattice_cpu": {},
        }[path]
        if launches[key] != want:
            raise AssertionError(f"{key}: launched {launches[key]}, expected {want}")
        log(f"[phase 4b] serve {key}: {nb} flushes of {n_stages} stages in "
            f"{time.perf_counter() - t:.1f}s; launches {launches[key]}")
    if not res["lattice_fused"] == res["lattice_unfused"] == res["lattice_cpu"]:
        raise AssertionError("lattice: fused, unfused and CPU results differ")
    for k in ("scores_computed", "chunk_survivors", "models_evaluated"):
        vals = [getattr(srvs[p].stats, k) for p in ("lattice_fused", "lattice_unfused", "lattice_cpu")]
        if not vals[0] == vals[1] == vals[2]:
            raise AssertionError(f"lattice: {k} differs (fused, unfused, cpu): {vals}")
    got = res["lattice_fused"]
    dec = np.array([r["decision"] for r in got])
    ex = np.array([r["models_evaluated"] for r in got])
    if not (np.array_equal(dec, dec_eager.astype(bool)) and np.array_equal(ex, ex_eager)):
        raise AssertionError("lattice: served verdicts != eager B1 verdicts")
    fs = [r["full_score"] for r in got if "full_score" in r]
    if len(got) != len(ds.y_test) or not np.isfinite(fs).all() or len(fs) != int(dec.sum()):
        raise AssertionError("lattice: missing results or non-finite full scores")
    st = srvs["lattice_fused"].stats
    acc = float(np.mean(dec == y))
    report["lattice_path"] = dict(
        config="exp4_rw2_joint", T=T, S=S, mode=mode, alpha=0.005,
        train_s=train_s, fit_s=fit_s, train_mean_models=fit.train_mean_models,
        mean_models=st.mean_models, speedup=st.speedup,
        scores_computed=st.scores_computed, scores_possible=st.scores_possible,
        n_batches=st.n_batches, stages_run=len(st.chunk_survivors),
        test_acc=acc, full_scores=len(fs), diff_vs_full=ev["diff_rate"],
    )
    log(f"[phase 4b] served {mode}: mean models {st.mean_models:.3f}/{T}, scores "
        f"computed {st.scores_computed}/{st.scores_possible}, {len(fs)} positives "
        f"with full scores, test acc {acc:.4f}; fused == unfused == CPU plain == "
        f"eager B1 == evaluate_cascade")
    return dict(ds=ds, fit=fit, theta=theta, feats=feats, server=server,
                F_ordered=torch.from_numpy(F_test).cuda()[:, order].contiguous(),
                eps=(eps_pos, eps_neg), steps=int(ex_eager.sum()),
                F_test=F_test.astype(np.float64),
                batch_g=np.concatenate([r.g_final for r in srvs["lattice_fused"].flush_results]))


def stream_serve(server, x, arrivals) -> list[dict]:
    for row, a in zip(x, arrivals):
        server.submit(row, arrival=a)
    return server.drain()


def poisson_arrivals(n: int, rate: float):
    """The streaming protocol's arrival trace: cumulative exponential
    inter-arrivals at ``rate`` requests per stage step, seed 2028."""
    import numpy as np

    return np.cumsum(np.random.default_rng(ARRIVAL_SEED).exponential(1.0 / rate, size=n))


def flush_occupancy(executor, x, cap: int) -> float:
    """Mean occupancy of the flush server at capacity ``cap`` on the same
    executor (batch b = rows [b cap, (b + 1) cap)): rows entering each stage
    over stages run x cap, as the streaming benchmark models it."""
    num = den = 0
    for b0 in range(0, x.shape[0], cap):
        nb = min(cap, x.shape[0] - b0)
        res = executor.run(x[b0 : b0 + nb], nb, capacity=cap)
        num += sum(c.n_in for c in res.chunk_stats)
        den += len(res.chunk_stats) * cap
    return num / max(den, 1)


def phase_streaming(report: dict, launches: dict, main: dict, lmain: dict) -> dict:
    """Phase 4c: both cells served by ``StreamingServer`` at full width
    (capacity 256, window 1024, chunk_t 8, block 64) under the seed-2028
    Poisson trace at 256 and 4.0 requests per step, fused (B7), unfused
    (lane_fn + B6), eager (exp1: the B3 score matrix + B7 matrix) and on
    the CPU, each path's launches counted on their own.  No new fit: the
    ensembles and cascades of phases 4 and 4b."""
    import numpy as np

    from repro_torch.api.scorers import LatticeScorer, TreeScorer
    from repro_torch.core import evaluate_cascade
    from repro_torch.serving.engine import StreamingServer

    gbt = main["gbt"]
    cells = {
        "exp1_adult": dict(
            prefix="stream", mode="both", ds=main["ds"], fit=main["fits"]["both"],
            scorer=TreeScorer(gbt.feats, gbt.thrs, gbt.leaves), score_fn=main["score_fn"],
            F_test=main["F_test"], batch_g=main["batch_g"]["both"], fused="mega_lane_tree",
        ),
        "exp4_rw2_joint": dict(
            prefix="lattice_stream", mode="neg_only", ds=lmain["ds"], fit=lmain["fit"],
            scorer=LatticeScorer(lmain["theta"], lmain["feats"]), score_fn=None,
            F_test=lmain["F_test"], batch_g=lmain["batch_g"], fused="mega_lane_lattice",
        ),
    }

    def server(cell, device, opts=None, eager=False):
        c = cells[cell]
        kw = {"score_fn": c["score_fn"]} if eager else {"scorer": c["scorer"]}
        return StreamingServer(
            c["fit"], exec_backend="device", device=device, batch_size=STREAM_CAP,
            window=STREAM_WINDOW, chunk_t=8, block_n=64, backend_opts=opts or {}, **kw,
        )

    out = {}
    for cell, c in cells.items():
        x = c["ds"].x_test
        n, T = x.shape[0], c["fit"].T
        ev = evaluate_cascade(c["fit"], c["F_test"])
        paths = [("fused", "cuda", {}, False), ("unfused", "cuda", {"megakernel": False}, False),
                 ("cpu", "cpu", {}, False)]
        if c["score_fn"] is not None:
            paths.append(("eager", "cuda", {}, True))
        for rate in STREAM_RATES:
            arrivals = poisson_arrivals(n, rate)
            res, srvs = {}, {}
            for path, device, opts, eager in paths:
                key = f"{c['prefix']}_{path}/{c['mode']}/r{rate:g}"
                t = time.perf_counter()
                srv = srvs[path] = server(cell, device, opts, eager)
                res[path] = counted(launches, key, lambda: stream_serve(srv, x, arrivals))
                waves = srv.stream_results
                enq = sum(w.steps_enqueued for w in waves)
                want = {
                    "fused": {c["fused"]: enq}, "unfused": {"cascade_lane": enq},
                    "eager": {"gbt_scores": len(waves), "mega_lane_matrix": enq}, "cpu": {},
                }[path]
                if launches[key] != want:
                    raise AssertionError(f"{key}: launched {launches[key]}, expected {want}")
                log(f"[phase 4c] {key}: {len(waves)} waves, {srv.stats.stream_steps} steps run, "
                    f"{enq} enqueued, {sum(w.syncs for w in waves)} syncs in "
                    f"{time.perf_counter() - t:.1f}s; launches {launches[key]}")
            ref_srv = srvs["fused"]
            for path, srv in srvs.items():
                if res[path] != res["fused"]:
                    raise AssertionError(f"{cell} r{rate:g}: {path} results != fused")
                if len(srv.stream_results) != len(ref_srv.stream_results):
                    raise AssertionError(f"{cell} r{rate:g}: {path} wave count differs")
                for a, b in zip(srv.stream_results, ref_srv.stream_results):
                    for k in ("decisions", "exit_step", "g_final", "admit_step", "done_step",
                              "latency_steps", "occupancy"):
                        if not np.array_equal(getattr(a, k), getattr(b, k)):
                            raise AssertionError(f"{cell} r{rate:g}: {path} {k} != fused")
                    if a.steps_run != b.steps_run or (
                        path != "eager" and a.scores_computed != b.scores_computed
                    ):
                        raise AssertionError(f"{cell} r{rate:g}: {path} steps or billing differ")
                if path != "eager" and srv.stats.latency_steps != ref_srv.stats.latency_steps:
                    raise AssertionError(f"{cell} r{rate:g}: {path} latency_steps differ")
            waves = ref_srv.stream_results
            dec = np.concatenate([w.decisions for w in waves])
            ex = np.concatenate([w.exit_step for w in waves])
            g = np.concatenate([w.g_final for w in waves])
            if not (np.array_equal(dec, ev["decisions"]) and np.array_equal(ex, ev["exit_step"])):
                raise AssertionError(f"{cell} r{rate:g}: streamed verdicts != evaluate_cascade")
            if g.view(np.int32).tolist() != c["batch_g"].view(np.int32).tolist():
                raise AssertionError(f"{cell} r{rate:g}: streamed g_final != batch g_final")
            st = ref_srv.stats
            flush_occ = flush_occupancy(ref_srv._dev[0], x, STREAM_CAP)
            if rate == STREAM_RATES[0] and not st.mean_occupancy > flush_occ:
                raise AssertionError(
                    f"{cell}: streaming occupancy {st.mean_occupancy:.4f} <= flush "
                    f"server's {flush_occ:.4f} at capacity {STREAM_CAP}"
                )
            out[f"{cell}/r{rate:g}"] = dict(
                rate=rate, waves=len(waves), steps_run=st.stream_steps,
                steps_enqueued=sum(w.steps_enqueued for w in waves),
                syncs=sum(w.syncs for w in waves), mean_occupancy=st.mean_occupancy,
                flush_occupancy=flush_occ, latency_p50=st.latency_p50,
                latency_p95=st.latency_p95, latency_p99=st.latency_p99,
                latency_mean=st.latency_mean, mean_models=st.mean_models,
                scores_computed=st.scores_computed, scores_possible=st.scores_possible,
            )
            log(f"[phase 4c] {cell} rate {rate:g}: fused == unfused == CPU"
                f"{' == eager' if 'eager' in srvs else ''} == evaluate_cascade, g_final == "
                f"batch; {len(waves)} waves, {st.stream_steps} steps, occupancy "
                f"{st.mean_occupancy:.4f} (flush server {flush_occ:.4f}), latency p50/p95/p99 "
                f"{st.latency_p50:.0f}/{st.latency_p95:.0f}/{st.latency_p99:.0f} steps, "
                f"mean models {st.mean_models:.3f}/{T}, scores {st.scores_computed}")
    report["streaming"] = out
    return dict(server=server, cells=cells)


def flush_latency(make_server, x, label: str) -> dict:
    """Median and p90 flush latency at batch 128 / 256 / 1024, fused
    (megakernel on, the default) and unfused, for the servers
    ``make_server(batch_size=, backend_opts=)`` builds."""
    lat = {}
    for batch in (128, 256, 1024):
        for megakernel in (None, False):
            srv = make_server(batch_size=batch, backend_opts={"megakernel": megakernel})
            times = []
            for k in range(N_WARM + N_FLUSH):
                start = (k * batch) % (x.shape[0] - batch)
                rows = x[start : start + batch]
                for row in rows[:-1]:
                    srv.submit(row)
                t = time.perf_counter()
                srv.submit(rows[-1])  # fills the batch: one flush, ending in
                times.append((time.perf_counter() - t) * 1e3)  # its one transfer
            times = times[N_WARM:]
            key = f"batch{batch}" + ("" if megakernel is None else "_unfused")
            # p90 of 100 samples has 10 beyond it
            lat[key] = dict(
                median_ms=statistics.median(times),
                p90_ms=statistics.quantiles(times, n=10)[-1],
                min_ms=min(times), max_ms=max(times), n=len(times),
            )
            log(f"[phase 5] {label} flush latency batch {batch} "
                f"({'fused' if megakernel is None else 'unfused'}): median "
                f"{lat[key]['median_ms']:.3f} ms, p90 {lat[key]['p90_ms']:.3f} ms "
                f"over {len(times)} flushes")
    return lat


def busy_share(srv, x, median_ms: float, label: str) -> dict:
    """Device busy share of one steady batch-256 flush of ``srv``: the
    profiler's device time over the unprofiled median flush ``median_ms``
    (the profiler slows the host, so its own wall would understate it)."""
    serve(srv, x[:256])
    wall = {}

    def fill():  # 255 rows queued: the next submit flushes
        for row in x[256:511]:
            srv.submit(row)

    def flush():
        t = time.perf_counter()
        srv.submit(x[511])  # the 256th row: one flush
        wall["us"] = (time.perf_counter() - t) * 1e6

    by_name = profile_device(flush, prepare=fill)
    busy = sum(v[0] for v in by_name.values())
    wall_unprofiled_us = median_ms * 1e3
    log(f"[phase 5] {label} one flush (batch 256, fused): device busy {busy:.0f} us = "
        f"{busy / wall_unprofiled_us:.2%} of the unprofiled median flush "
        f"{wall_unprofiled_us:.0f} us (wall under the profiler {wall['us']:.0f} us)")
    return dict(
        device_busy_us=busy, wall_unprofiled_median_us=wall_unprofiled_us,
        busy_share=busy / wall_unprofiled_us, wall_profiled_us=wall["us"],
        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
    )


class OpCount:
    """Counts the PyTorch operator calls (aten ops: allocations, gathers,
    scatters, elementwise ops, copies) made while it is entered."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def stream_timing(make_server, x, label: str) -> dict:
    """Streaming at the heavy rate (phase 4c's first): ``N_DRAINS`` drains of
    the test rows after one warm-up drain, each wave timed on the host clock
    (a wave ends in its results' transfer); then one wave's PyTorch
    operator calls, and one wave profiled for the device busy share over
    the unprofiled median wave."""
    import numpy as np

    arrivals = poisson_arrivals(x.shape[0], STREAM_RATES[0])
    srv = make_server()
    walls, drains, per_step = [], [], []
    orig = srv.flush

    def timed_flush():
        t = time.perf_counter()
        out = orig()
        dt = time.perf_counter() - t
        if out:
            walls.append(dt * 1e3)
            per_step.append(dt * 1e3 / srv.stream_results[-1].steps_enqueued)
        return out

    srv.flush = timed_flush

    def later(a):
        # the trace again, after every arrival the server has seen (its
        # arrival clock only moves forward)
        return a + (math.ceil(srv._clock) + 1.0 if srv.stats.n_requests else 0.0)

    stream_serve(srv, x, later(arrivals))  # warm-up
    walls.clear()
    per_step.clear()
    n0 = len(srv.stream_results)
    for _ in range(N_DRAINS):
        t = time.perf_counter()
        stream_serve(srv, x, later(arrivals))
        drains.append(time.perf_counter() - t)
    waves = srv.stream_results[n0:]
    med_drain = statistics.median(drains)
    st = srv.stats
    out = dict(
        requests_per_s=x.shape[0] / med_drain, drain_median_s=med_drain, drains=drains,
        wave_median_ms=statistics.median(walls),
        wave_p90_ms=statistics.quantiles(walls, n=10)[-1],
        step_median_ms=statistics.median(per_step),
        step_p90_ms=statistics.quantiles(per_step, n=10)[-1],
        waves=len(walls), steps_run_per_wave=float(np.mean([w.steps_run for w in waves])),
        steps_enqueued_per_wave=float(np.mean([w.steps_enqueued for w in waves])),
        syncs_per_wave=float(np.mean([w.syncs for w in waves])),
        latency_p50=st.latency_p50, latency_p95=st.latency_p95, latency_p99=st.latency_p99,
    )
    # one full wave (the window's first 1024 rows): its operator calls, then
    # its device time under the profiler
    w = STREAM_WINDOW
    first = {}

    def fill():
        first["a"] = later(arrivals[:w])
        for row, a in zip(x[: w - 1], first["a"]):
            srv.submit(row, arrival=a)

    def wave():
        srv.submit(x[w - 1], arrival=first["a"][-1])  # the window's last row: one wave

    fill()
    with OpCount() as ops:
        wave()
    enq = srv.stream_results[-1].steps_enqueued
    out["torch_ops_per_step"] = ops.n / enq
    by_name = profile_device(wave, prepare=fill)
    busy = sum(v[0] for v in by_name.values())
    med_us = out["wave_median_ms"] * 1e3
    out.update(
        device_busy_us=busy, busy_share=busy / med_us,
        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
    )
    log(f"[phase 5] {label} streaming (rate {STREAM_RATES[0]:g}, cap {STREAM_CAP}, window "
        f"{w}): {out['requests_per_s']:.0f} requests/s over a drain of {x.shape[0]}; wave "
        f"median {out['wave_median_ms']:.3f} ms, p90 {out['wave_p90_ms']:.3f} ms over "
        f"{len(walls)} waves; step median {out['step_median_ms']:.4f} ms, p90 "
        f"{out['step_p90_ms']:.4f} ms; {out['steps_run_per_wave']:.1f} steps run, "
        f"{out['steps_enqueued_per_wave']:.1f} enqueued, {out['syncs_per_wave']:.1f} syncs "
        f"per wave; latency p50/p95/p99 {st.latency_p50:.0f}/{st.latency_p95:.0f}/"
        f"{st.latency_p99:.0f} steps; {out['torch_ops_per_step']:.1f} PyTorch ops per "
        f"step; one wave's device busy {busy:.0f} us = {out['busy_share']:.2%} of the "
        f"median wave")
    return out


def phase_times(ctx: dict, main: dict, lmain: dict, smain: dict, launches: dict,
                check: Check, report: dict) -> list:
    """Phase 5: flush latency, streaming wave times and per-kernel device
    times."""
    import torch

    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.cascade_kernel import (
        cascade_chunk_kernel,
        cascade_chunk_plain,
        cascade_kernel,
        cascade_lane_kernel,
        cascade_lane_plain,
        cascade_plain,
    )
    from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
    from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain

    ds, server = main["ds"], main["server"]
    lat = flush_latency(lambda **kw: server("both", "cuda", **kw), ds.x_test, "exp1_adult")
    report["flush_latency"] = lat
    report["profile_flush256"] = busy_share(
        server("both", "cuda"), ds.x_test, lat["batch256"]["median_ms"], "exp1_adult"
    )
    lds, lserver = lmain["ds"], lmain["server"]
    llat = flush_latency(lambda **kw: lserver("cuda", **kw), lds.x_test, "exp4_rw2_joint")
    report["lattice_flush_latency"] = llat
    report["lattice_profile_flush256"] = busy_share(
        lserver("cuda"), lds.x_test, llat["batch256"]["median_ms"], "exp4_rw2_joint"
    )
    report["stream_timing"] = {
        cell: stream_timing(lambda c=cell: smain["server"](c, "cuda"),
                            smain["cells"][cell]["ds"].x_test, cell)
        for cell in smain["cells"]
    }

    g0, chunk, ep, en = ctx["chunk"]
    feats, thrs, leaves = ctx["forest"]
    x_cal, x_buf, rows = ctx["x_cal"], ctx["x_buf"], ctx["rows"]
    dplan, tree, matrix, F = ctx["dplan"], ctx["tree"], ctx["matrix"], ctx["F"]
    eps_pos, eps_neg = ctx["eps"]
    g_buf = ctx["g_buf"]
    nv = torch.tensor(256, dtype=torch.int32, device="cuda")
    m, ct = chunk.shape
    W, d, depth, L = dplan.W, x_buf.shape[1], feats.shape[1], leaves.shape[1]
    rows_all = torch.arange(256, device="cuda")
    xr_tree = x_buf[rows_all].contiguous()
    xr_mat = F[rows_all].contiguous()
    stage, t0 = 5, int(dplan.stage_t0[5])
    kernels = []

    def entry(name, fn, plain, nbytes, ops, shape, extra=None):
        # device time per launch, the plain version's per call
        ms, plain_ms = device_time_ms(fn), device_time_ms(plain)
        b, by = bound(nbytes, ops)
        src, replaces, path = KERNELS[name]
        e = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[path][name], max_abs_err=check.max_err[name],
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
            path=path,
            launches_by_path={p: c[name] for p, c in launches.items() if name in c},
            shape=shape, **(extra or {}),
        )
        kernels.append(e)
        log(f"[phase 5] {name} {shape}: device {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us), "
            f"bound {b * 1e3:.4f} us ({by})")

    def calibration(name, fn, plain, nbytes, ops, shape):
        # the one-off calibration shape, beside the serving shape's entry
        ms = device_time_ms(fn, reps=20)
        plain_ms = device_time_ms(plain, reps=5)
        b, by = bound(nbytes, ops)
        log(f"[phase 5] {name} calibration {shape}: device {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {b * 1e3:.2f} us ({by})")
        return dict(calib_shape=shape, calib_ms=ms, calib_plain_ms=plain_ms,
                    calib_bound_ms=b, calib_bound_by=by)

    entry(
        "cascade_chunk",
        lambda: cascade_chunk_kernel(g0, chunk, ep, en, 0, block_n=64, n_valid=nv),
        lambda: cascade_chunk_plain(g0, chunk, ep, en, 0, n_valid=nv),
        nbytes=4 * (m + m * ct + 2 * ct) + 16 * m, ops=3 * m * ct,
        shape=f"m={m} ct={ct}",
    )
    N, T = x_cal.shape[0], feats.shape[0]
    extra = calibration(
        "gbt_scores", lambda: gbt_scores_kernel(feats, thrs, leaves, x_cal),
        lambda: gbt_scores_plain(feats, thrs, leaves, x_cal),
        4 * N * d + T * (8 * depth + 4 * L) + 4 * N * T, N * T * depth, f"{N}x{T}",
    )
    entry(
        "gbt_scores",
        lambda: gbt_scores_kernel(feats, thrs, leaves, x_buf, block_n=64, t0=t0,
                                  t1=t0 + W, rows=rows_all, n_valid=nv),
        lambda: gbt_scores_plain(feats, thrs, leaves, x_buf, block_n=64, t0=t0,
                                 t1=t0 + W, rows=rows_all, n_valid=nv),
        nbytes=256 * (4 * d + 8) + W * (8 * depth + 4 * L) + 4 * 256 * W,
        ops=256 * W * depth, shape=f"stage: rows=256 trees={W}", extra=extra,
    )
    out_bytes = 20 * 256 + 4 * 4
    entry(
        "mega_stage_tree",
        lambda: mk.mega_stage_kernel(tree.slabs, xr_tree, g_buf, stage, t0, nv,
                                     eps_pos, eps_neg, block_n=64),
        lambda: mk.mega_stage_plain(tree.slabs, xr_tree, g_buf, stage, t0, nv,
                                    eps_pos, eps_neg, block_n=64),
        nbytes=256 * 4 * (d + 1) + W * (8 * depth + 4 * L + 8) + out_bytes,
        ops=256 * W * (depth + 3), shape=f"cap=256 W={W} d={d} depth={depth}",
    )
    entry(
        "mega_stage_matrix",
        lambda: mk.mega_stage_kernel(matrix.slabs, xr_mat, g_buf, stage, t0, nv,
                                     eps_pos, eps_neg, block_n=64),
        lambda: mk.mega_stage_plain(matrix.slabs, xr_mat, g_buf, stage, t0, nv,
                                    eps_pos, eps_neg, block_n=64),
        nbytes=256 * 4 * (W + 1) + 8 * W + 4 + out_bytes,
        ops=256 * W * 3, shape=f"cap=256 W={W} T_pad={F.shape[1]}",
    )

    # the lattice path: exp4's trained ensemble and fitted cascade
    theta, lfeats = lmain["theta"], lmain["feats"]
    Tl, S = lfeats.shape
    P = 1 << S
    flops = 3 * (P - 1)  # per (row, lattice): S halvings, 2 mul + 1 add each
    xl_cal = torch.from_numpy(lds.x_train).cuda()
    Nl, Dl = xl_cal.shape
    extra = calibration(
        "lattice_scores", lambda: lattice_scores_kernel(theta, lfeats, xl_cal),
        lambda: lattice_scores_plain(theta, lfeats, xl_cal),
        4 * Nl * Dl + Tl * 4 * (P + S) + 4 * Nl * Tl, Nl * Tl * flops, f"{Nl}x{Tl} S={S}",
    )
    xl_buf = torch.from_numpy(lds.x_test[:257]).cuda()
    entry(
        "lattice_scores",
        lambda: lattice_scores_kernel(theta, lfeats, xl_buf, block_n=64, t0=t0,
                                      t1=t0 + W, rows=rows_all, n_valid=nv),
        lambda: lattice_scores_plain(theta, lfeats, xl_buf, block_n=64, t0=t0,
                                     t1=t0 + W, rows=rows_all, n_valid=nv),
        nbytes=256 * (4 * Dl + 8) + W * 4 * (P + S) + 4 * 256 * W,
        ops=256 * W * flops, shape=f"stage: rows=256 lattices={W} S={S}", extra=extra,
    )
    lattice, (lep, len_) = ctx["lattice"], ctx["leps"]
    xr_lat = xl_buf[rows_all].contiguous()
    entry(
        "mega_stage_lattice",
        lambda: mk.mega_stage_kernel(lattice.slabs, xr_lat, g_buf, stage, t0, nv,
                                     lep, len_, block_n=64),
        lambda: mk.mega_stage_plain(lattice.slabs, xr_lat, g_buf, stage, t0, nv,
                                    lep, len_, block_n=64),
        nbytes=256 * 4 * (Dl + 1) + W * (4 * S + 4 * P + 8) + out_bytes,
        ops=256 * W * (flops + 3), shape=f"cap=256 W={W} d={Dl} S={S}",
    )
    # B6 and B7 on phase 3's mixed-stage buffer: lanes over every stage,
    # per-lane threshold rows; a slab is read once per distinct stage
    lanes = ctx["lanes"]
    stage, stop = lanes["stage"], lanes["stop"]
    lep_, len_l = lanes["eps"]
    n_st = int(torch.unique(stage).numel())
    entry(
        "cascade_lane",
        lambda: cascade_lane_kernel(g0, lanes["scores"], lep_, len_l, block_n=64, n_valid=nv),
        lambda: cascade_lane_plain(g0, lanes["scores"], lep_, len_l, n_valid=nv),
        nbytes=4 * (m + 3 * m * ct) + 16 * m, ops=3 * m * ct,
        shape=f"m={m} ct={ct}, lanes at {n_st} stages",
    )
    lane_in = 256 * (8 + 4 + 4 + 1) + out_bytes + n_st * W * 8  # rows, g0, stage, stop
    entry(
        "mega_lane_tree",
        lambda: mk.mega_lane_kernel(tree.slabs, x_buf, rows_all, g_buf, stage, stop, nv,
                                    eps_pos, eps_neg, block_n=64),
        lambda: mk.mega_lane_plain(tree.slabs, x_buf, rows_all, g_buf, stage, stop, nv,
                                   eps_pos, eps_neg, block_n=64),
        nbytes=lane_in + 256 * 4 * d + n_st * W * (8 * depth + 4 * L),
        ops=256 * W * (depth + 3), shape=f"cap=256 W={W} d={d} depth={depth}, {n_st} stages",
    )
    entry(
        "mega_lane_matrix",
        lambda: mk.mega_lane_kernel(matrix.slabs, F, rows_all, g_buf, stage, stop, nv,
                                    eps_pos, eps_neg, block_n=64),
        lambda: mk.mega_lane_plain(matrix.slabs, F, rows_all, g_buf, stage, stop, nv,
                                   eps_pos, eps_neg, block_n=64),
        nbytes=lane_in + 256 * 4 * W + n_st * 8, ops=256 * W * 3,
        shape=f"cap=256 W={W} T_pad={F.shape[1]}, {n_st} stages",
    )
    entry(
        "mega_lane_lattice",
        lambda: mk.mega_lane_kernel(lattice.slabs, xl_buf, rows_all, g_buf, stage, stop, nv,
                                    lep, len_, block_n=64),
        lambda: mk.mega_lane_plain(lattice.slabs, xl_buf, rows_all, g_buf, stage, stop, nv,
                                   lep, len_, block_n=64),
        nbytes=lane_in + 256 * 4 * Dl + n_st * W * (4 * S + 4 * P),
        ops=256 * W * (flops + 3), shape=f"cap=256 W={W} d={Dl} S={S}, {n_st} stages",
    )

    # B1 on the eager path's own inputs; a row reads the scores up to its
    # exit, so the bound counts this run's steps
    Fo, (bep, ben), steps = lmain["F_ordered"], lmain["eps"], lmain["steps"]
    beta = lmain["fit"].beta
    Nb, Tb = Fo.shape
    entry(
        "cascade",
        lambda: cascade_kernel(Fo, bep, ben, beta),
        lambda: cascade_plain(Fo, bep, ben, beta),
        nbytes=4 * steps + 8 * Tb + 8 * Nb, ops=3 * steps,
        shape=f"{Nb}x{Tb} chunk_t=8, {steps} steps walked",
    )
    return kernels


def main() -> int:
    import os

    if not (SRC / "repro_torch" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    report: dict = {}
    # phase 1: environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    log(f"[phase 1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    report["card"] = smi[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t = time.perf_counter()
    secs = _build.build_all()
    log(f"[phase 2] nvcc build in {time.perf_counter() - t:.1f}s wall: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for name in _build.SOURCES:
        for line in _build._library_path(name).with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line or "stack frame" in line:
                log(f"[phase 2]   {name}: {line.strip()}")
    report["build_s"] = secs

    phase_s = report["phase_s"] = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"[phase {name}] done in {phase_s[name]:.1f}s")
        return out

    # phase 3: kernels against their plain versions
    check = Check()
    ctx = timed("3", phase_kernels, check)

    # phase 4: the main paths; each path's counts from just before to just after it
    launches: dict = {}
    main_ctx = timed("4", phase_main_path, report, launches)
    lattice_ctx = timed("4b", phase_lattice_path, report, launches)
    stream_ctx = timed("4c", phase_streaming, report, launches, main_ctx, lattice_ctx)

    # phase 5: times
    kernels = timed("5", phase_times, ctx, main_ctx, lattice_ctx, stream_ctx, launches,
                    check, report)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_all
    out_dir = ROOT / "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[done] {report['total_s']:.1f}s")
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
