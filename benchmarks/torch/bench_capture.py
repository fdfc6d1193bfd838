#!/usr/bin/env python3
"""Flush, wave and drain walls of the captured stage loops (one CUDA graph
a program key) against the eager loop (``capture=False``), for the
``repro_torch`` of one source tree, in one process.

    python benchmarks/torch/bench_capture.py [--src DIR]
    python benchmarks/torch/bench_capture.py --paths --parent DIR [--pairs N]

exp1_adult (GBT T = 500, depth 5; the fitted cascade cached in
``build/bench_matrix_exp1.npz`` by the first process, as
``bench_matrix_step.py`` caches it), served on the card:

* ``batch``: ``QWYCServer`` (sorted-kernel, chunk_t 8), fused (B4) and
  unfused (B3 + B2's step form) at batch 128 / 256 / 1024, median and p90
  of 100 flushes after 5 (``chip_smoke.flush_latency``), and one
  batch-256 flush's device busy share (``chip_smoke.busy_share``);
* ``stream``: ``StreamingServer`` (capacity 256, window 1024, fused B7) at
  256 requests a step: wave walls, PyTorch calls a step, one wave's busy
  share (``chip_smoke.stream_timing``);
* ``rank``: the ranking server (k 10, alpha 0.05, its operand pinned to
  ``chip_smoke.RANK_DOCS`` rows) over the 126 test queries: the first
  drain (each bucket shape's program eager), the second (captured), then
  20 drains of the same queries; then one drain of each of 20 sets of 126
  never-seen queries (train rows cut anew, ``chip_smoke.fresh_queries``);
  PyTorch calls a grouped stage, one drain's busy share
  (``chip_smoke.rank_timing``).

Each path runs captured and with ``capture=False``.  A tree whose
``DeviceExecutor`` has no ``capture`` option (the parent of the change
that brought it) runs its eager loop only, reported as ``default``.

``--paths`` runs the tree at ``--parent`` (its ``src``) against this one,
one process each, in turns: parent, change, change, parent, for ``--pairs``
pairs (default 2), and prints each process's medians side by side.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line
``{"src": ..., "card": ..., "modes": {...}}``; ``--paths --out FILE``
writes every process's line to ``FILE``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def walls() -> dict:
    """Every path of the module docstring, in each mode the tree has."""
    import numpy as np
    import torch

    from bench_matrix_step import exp1_eager
    from chip_smoke import (
        N_RANK_DRAINS, RANK_ALPHA, RANK_BATCH, RANK_DOCS, RANK_GROUP_MEAN, RANK_K, STREAM_CAP,
        STREAM_WINDOW, busy_share, flush_latency, fresh_queries, rank_twin, rank_timing,
        stream_timing,
    )
    from repro_torch import api
    from repro_torch.api.scorers import TreeScorer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.device_executor import DeviceExecutor
    from repro_torch.launch.serve import GROUPS_SEED, _ragged_sizes
    from repro_torch.ranking import GroupedRankServer, group_offsets
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
    has_capture = "capture" in inspect.signature(DeviceExecutor).parameters
    modes = {"captured": {}, "eager": {"capture": False}} if has_capture else {"default": {}}
    # a tree without capacity_docs keeps each flush's operand as it is
    docs = ({"capacity_docs": RANK_DOCS}
            if "capacity_docs" in inspect.signature(GroupedRankServer).parameters else {})
    fresh = fresh_queries(ds.x_train, N_RANK_DRAINS, GROUPS_SEED + 1)

    def rank_server(capture=True):
        srv = fitted.compile("device", device="cuda").serve(
            score_fn=score_fn, batch_size=RANK_BATCH, **docs)
        return srv if capture else rank_twin(srv)

    out = {}
    for mode, opts in modes.items():

        def batch_server(opts=opts, **kw):
            kw.setdefault("batch_size", 256)
            kw["backend_opts"] = {**kw.get("backend_opts", {}), **opts}
            return QWYCServer(fit, exec_backend="device", device="cuda",
                              backend="sorted-kernel", chunk_t=8, scorer=TreeScorer(*params),
                              **kw)

        label = f"exp1_adult {mode}"
        lat = flush_latency(batch_server, x_test, label)
        busy = busy_share(batch_server(), x_test, lat["batch256"]["median_ms"], label)
        stream = stream_timing(
            lambda opts=opts: StreamingServer(
                fit, exec_backend="device", device="cuda", batch_size=STREAM_CAP,
                window=STREAM_WINDOW, chunk_t=8, block_n=64, scorer=TreeScorer(*params),
                backend_opts=dict(opts),
            ), x_test, label)
        rank = rank_timing(dict(server=rank_server, x=ds.x_test, offsets=group_offsets(sizes_te),
                                S=fitted.grouped.S, fresh=fresh), capture=mode != "eager")
        out[mode] = dict(
            batch={k: {q: v[q] for q in ("median_ms", "p90_ms")} for k, v in lat.items()},
            batch256_busy={k: busy[k] for k in (
                "device_busy_us", "busy_share", "port_events", "launches", "device_span_us")},
            stream={k: stream[k] for k in (
                "wave_median_ms", "wave_p90_ms", "step_median_ms", "torch_ops_per_step",
                "steps_enqueued_per_wave", "syncs_per_wave", "device_busy_us", "busy_share")},
            rank={k: rank[k] for k in (
                "first_drain_ms", "second_drain_ms", "drain_median_ms", "drain_p90_ms",
                "fresh_drain_median_ms", "fresh_drain_p90_ms", "fresh_new_programs",
                "torch_ops_per_stage", "device_busy_us", "busy_share")},
        )
    return out


def summary(line: dict) -> str:
    parts = []
    for mode, r in line["modes"].items():
        parts.append(
            f"{mode}: flush256 fused {r['batch']['batch256']['median_ms']:.3f} ms, unfused "
            f"{r['batch']['batch256_unfused']['median_ms']:.3f} ms (busy "
            f"{r['batch256_busy']['busy_share']:.1%}); wave {r['stream']['wave_median_ms']:.3f}"
            f" ms (busy {r['stream']['busy_share']:.1%}); drain "
            f"{r['rank']['drain_median_ms']:.3f} ms (busy {r['rank']['busy_share']:.1%}), "
            f"never-seen {r['rank']['fresh_drain_median_ms']:.3f} ms")
    return f"{line['src']}: " + " | ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--parent", help="the parent tree's src directory (--paths)")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", help="--paths: a JSON file for every process's line")
    args = ap.parse_args(argv)
    if args.paths:
        if not args.parent:
            ap.error("--paths needs --parent")
        order = [args.parent, args.src, args.src, args.parent] * ((args.pairs + 1) // 2)
        lines = []
        for src in order[: 2 * args.pairs]:
            proc = subprocess.run([sys.executable, __file__, "--src", src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(summary(lines[-1]), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(lines, indent=1))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_capture: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    line = dict(src=args.src, card=card(), modes=walls())
    print(line["card"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
