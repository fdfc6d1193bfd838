"""Serving launcher: batched QWYC serving end to end, the counterpart of
``repro.launch.serve`` for the ported slice (``--ensemble gbt`` and
``--ensemble lattice``).

Trains the ensemble (GBT on the host, lattices with AdamW on ``--device``),
fits QWYC ordering + thresholds on the train split's score matrix (computed
with the tree kernel B3 or the lattice kernel B5), then serves the test
split through ``QWYCServer`` and reports speedup and faithfulness.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset adult \
        --T 500 --alpha 0.005 --backend device --policy sorted-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset rw2 \
        --ensemble lattice --T 500 --scale 1.0 --alpha 0.005 --mode neg_only

``--backend`` names the execution backend: ``auto`` (the default: the
device backend, never the host loop), ``device`` or ``host``.
``--device`` picks the torch device: ``cuda`` (the default, an error
without a card) or ``cpu``, which runs every kernel's plain version.
``--streaming`` serves through ``StreamingServer`` (continuous batching)
under a seeded Poisson arrival trace of ``--arrival-rate`` requests per
stage step:

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset adult \
        --T 500 --alpha 0.005 --streaming --arrival-rate 4

``--groups N`` ranks instead: the train and test rows are cut into ragged
query groups (Poisson sizes around N, seed 2031), group-level exit
thresholds are fitted for top-``--topk`` stability (``api.fit(groups=)``),
and the test queries are served by a ``GroupedRankServer`` (B3 scores,
the group decide B8), reporting mean exit stage, scores computed and
NDCG@k against the test labels.  With ``--streaming`` the test queries
arrive on the seed-2028 Poisson trace at ``--arrival-rate`` queries per
stage step and stream through the grouped admission ring:

    PYTHONPATH=src python -m repro_torch.launch.serve --groups 16 --topk 10 \
        --T 500 --scale 1.0 --alpha 0.05 [--streaming]

Guarded serving: ``--chaos-seed S`` arms a seeded ``FaultPlan`` around the
serving loop (``--chaos-poison F`` poisons that fraction of the test rows,
which the quarantine answers; ``--chaos-wave-failures K`` fails the first
K device waves, which the degradation ladder retries, then falls to the
host), ``--watchdog`` runs the drift watchdog over the audit stream, and
``--no-quarantine`` turns the admission guard off.  A SIGINT or SIGTERM
during the submit loop stops admission, drains the queue and still prints
the final stats.
"""

from __future__ import annotations

import argparse
import signal

import numpy as np
import torch

from repro_torch import api
from repro_torch.api import scorers
from repro_torch.api.registry import backend_names, resolve_backend
from repro_torch.core import fit_qwyc
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.ensembles.gbt import train_gbt
from repro_torch.ensembles.lattice import init_lattice_ensemble, train_lattice_ensemble
from repro_torch.kernels import ops
from repro_torch.ranking import group_offsets, ndcg_at_k
from repro_torch.serving.engine import BACKENDS as POLICIES
from repro_torch.serving.engine import QWYCServer, StreamingServer
from repro_torch.testing import FaultPlan

# row-block size for the lazy chunked score kernels: survivors are padded
# up to a multiple of this (billed honestly via score_block_n below)
SCORE_BLOCK_N = 64
# the streaming protocol's fixed arrival-trace seed
ARRIVAL_SEED = 2028
# the seed that cuts rows into ragged query groups (--groups)
GROUPS_SEED = 2031


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="adult", choices=["adult", "nomao", "rw1", "rw2"])
    ap.add_argument("--ensemble", default="gbt", choices=["gbt", "lattice"])
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.005)
    ap.add_argument("--mode", default="both", choices=["both", "neg_only"])
    ap.add_argument(
        "--backend", default="auto", choices=("auto",) + backend_names(),
        help="execution backend (auto = device, never host)",
    )
    ap.add_argument("--policy", default="sorted-kernel", choices=POLICIES)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--chunk-t", type=int, default=8)
    ap.add_argument(
        "--eager", action="store_true",
        help="precompute the full (N, T) score matrix per batch instead of "
        "the lazy chunked producer",
    )
    ap.add_argument(
        "--audit", action="store_true",
        help="recompute early-exited rows' full scores to measure diff vs "
        "full ensemble (extra work, billed apart)",
    )
    ap.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="torch device (cpu runs the kernels' plain versions)",
    )
    ap.add_argument(
        "--streaming", action="store_true",
        help="continuous batching: requests wait in an arrival-order queue "
        "and the device admission ring refills freed survivor slots "
        "mid-cascade; needs an on-device --backend",
    )
    ap.add_argument(
        "--max-wait", type=float, default=None,
        help="streaming admission deadline in stage steps: launch a partial "
        "wave once the oldest queued request has waited this long "
        "(default: wait for a full window)",
    )
    ap.add_argument(
        "--stream-window", type=int, default=None,
        help="streaming admission-ring size per device wave (default: 4x the "
        "slot capacity)",
    )
    ap.add_argument(
        "--arrival-rate", type=float, default=4.0,
        help="streaming Poisson arrival rate in requests per stage step "
        "(fixed seed, so the trace and the billing are deterministic)",
    )
    ap.add_argument(
        "--groups", type=int, default=None,
        help="ranking mode: cut the train/test rows into seeded ragged query "
        "groups with this mean document count, fit GROUP-level exit "
        "thresholds (api.fit(groups=...)) and serve per-query top-k verdicts",
    )
    ap.add_argument(
        "--topk", type=int, default=10,
        help="ranking depth k for --groups serving (default 10)",
    )
    # guarded serving
    ap.add_argument(
        "--chaos-seed", type=int, default=None,
        help="arm a deterministic fault-injection plan (repro_torch.testing."
        "faults) around the serving loop; combine with the other --chaos-* "
        "flags to pick the faults",
    )
    ap.add_argument(
        "--chaos-poison", type=float, default=0.0,
        help="fraction of test rows poisoned with non-finite values under "
        "--chaos-seed (quarantine should catch every one)",
    )
    ap.add_argument(
        "--chaos-wave-failures", type=int, default=0,
        help="number of device waves to fail under --chaos-seed (exercises the "
        "retry/degradation ladder)",
    )
    ap.add_argument(
        "--chaos-drop-device", action="store_true",
        help="report a mesh device of the sharded backend as lost (not "
        "ported: raises, ROADMAP A15)",
    )
    ap.add_argument(
        "--watchdog", action="store_true",
        help="run the sequential drift watchdog over the audit stream and "
        "widen the thresholds on alarm (implies --audit)",
    )
    ap.add_argument(
        "--no-quarantine", dest="quarantine", action="store_false",
        help="disable the submit-time validation guard (bad rows then raise "
        "instead of draining with a quarantined verdict)",
    )
    return ap


def _ragged_sizes(n: int, mean: int, rng) -> np.ndarray:
    """Partition ``n`` rows into ragged group sizes (Poisson around
    ``mean``, min 1, last group takes the remainder)."""
    sizes = []
    left = n
    while left > 0:
        s = int(min(left, max(1, rng.poisson(mean))))
        sizes.append(s)
        left -= s
    return np.asarray(sizes, dtype=np.int64)


def _serve_ranking(args, ds, score_fn, F_train, beta, backend, device) -> None:
    """``--groups`` mode: ragged ranking queries through the grouped
    cascade (fit group thresholds -> compile -> GroupedRankServer)."""
    rng = np.random.default_rng(GROUPS_SEED)
    sizes_tr = _ragged_sizes(len(ds.y_train), args.groups, rng)
    fitted = api.fit(
        F_train, groups=sizes_tr, topk=args.topk,
        alpha=args.alpha, beta=beta, mode=args.mode, chunk_t=args.chunk_t,
    )
    gp = fitted.grouped
    print(
        f"[serve] grouped fit: {sizes_tr.size} train queries "
        f"(mean {sizes_tr.mean():.1f} docs), S={gp.S}, k={gp.k}, "
        f"train disagreement {gp.train_disagreement:.4f} (alpha={args.alpha})"
    )
    compiled = fitted.compile(backend, device=device)
    server = compiled.serve(
        score_fn=score_fn, streaming=args.streaming, batch_size=args.batch_size
    )
    sizes_te = _ragged_sizes(len(ds.y_test), args.groups, rng)
    offsets = group_offsets(sizes_te)
    # streaming: each query at its seeded Poisson arrival (stage steps)
    arrivals = np.cumsum(
        np.random.default_rng(ARRIVAL_SEED).exponential(
            1.0 / args.arrival_rate, size=sizes_te.size
        )
    )
    for i in range(sizes_te.size):
        docs = ds.x_test[offsets[i] : offsets[i + 1]]
        if args.streaming:
            server.submit(docs, arrival=float(arrivals[i]))
        else:
            server.submit(docs)
    results = server.drain()
    st = server.stats
    # NDCG against the binary test labels as graded relevance (the
    # synthetic splits have no per-document grades)
    verd = np.full((sizes_te.size, gp.k), -1, dtype=np.int64)
    for i, r in enumerate(results):
        ids = np.asarray(r["ranking"], dtype=np.int64) + offsets[i]
        verd[i, : ids.size] = ids
    ndcg = ndcg_at_k(ds.y_test, verd, sizes_te, gp.k)
    print(
        f"[serve] ranking: {st.n_queries} queries / {st.n_docs} docs in "
        f"{st.n_waves} wave(s) ({compiled.backend_name} backend, "
        f"{'streaming' if args.streaming else 'batch'})\n"
        f"        mean exit stage {st.mean_exit_stage:.2f}/{gp.S}  "
        f"scores computed {st.scores_computed}/{st.scores_possible} "
        f"({st.compute_fraction:.1%} of eager)\n"
        f"        NDCG@{gp.k} {ndcg:.4f}"
    )


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    chaos = None
    if args.chaos_seed is not None:
        # every fault derives from --chaos-seed, so a run reproduces
        chaos = FaultPlan(
            seed=args.chaos_seed,
            poison_fraction=args.chaos_poison,
            poison_mode="mix",
            wave_failures=args.chaos_wave_failures,
            drop_device=args.chaos_drop_device,
        )
    elif args.chaos_drop_device:
        FaultPlan(drop_device=True)  # raises, naming its ROADMAP item
    device = resolve_device(args.device)
    backend = resolve_backend(args.backend, device=device)
    on_device = backend.capabilities.on_device
    if args.streaming and not backend.capabilities.streaming:
        ap.error(
            f"--streaming needs an on-device backend (resolved {backend.name!r}; "
            "see BackendCapabilities.streaming)"
        )

    ds = make_dataset(args.dataset, scale=args.scale)
    print(f"[serve] dataset={args.dataset} train={len(ds.y_train)} test={len(ds.y_test)}")

    if args.ensemble == "gbt":
        gbt = train_gbt(
            ds.x_train, ds.y_train, n_trees=args.T, depth=args.depth, device=device
        )
        beta = -gbt.base_score
        feats, thrs, leaves = gbt.feats, gbt.thrs, gbt.leaves

        def score_fn(x):
            return ops.gbt_scores(feats, thrs, leaves, x)

        def make_chunk_score_fn(order):
            # params permuted to cascade order once, so a cascade range is a
            # contiguous slab for the model-range kernel
            idx = torch.as_tensor(order, device=device)
            of, ot, ol = feats[idx], thrs[idx], leaves[idx]

            def chunk_score_fn(x, rows, t0, t1):
                return ops.gbt_scores(
                    of, ot, ol, x, t0=t0, t1=t1, rows=rows, block_n=SCORE_BLOCK_N
                )

            return chunk_score_fn

        def make_scorer():
            return scorers.TreeScorer(feats, thrs, leaves, block_n=SCORE_BLOCK_N)

    else:
        lat = init_lattice_ensemble(args.T, ds.D, S=min(8, ds.D), seed=0, device=device)
        lat = train_lattice_ensemble(lat, ds.x_train, ds.y_train, mode="joint", steps=300)
        beta = 0.0
        theta, lfeats = lat["theta"], lat["feats"]

        def score_fn(x):
            return ops.lattice_scores(theta, lfeats, x)

        def make_chunk_score_fn(order):
            idx = torch.as_tensor(order, device=device)
            th, fe = theta[idx], lfeats[idx]

            def chunk_score_fn(x, rows, t0, t1):
                return ops.lattice_scores(
                    th, fe, x, t0=t0, t1=t1, rows=rows, block_n=SCORE_BLOCK_N
                )

            return chunk_score_fn

        def make_scorer():
            return scorers.LatticeScorer(theta, lfeats, block_n=SCORE_BLOCK_N)

    x_train = torch.from_numpy(ds.x_train).to(device)
    F_train = score_fn(x_train).cpu().numpy().astype(np.float64)
    if args.groups is not None:
        _serve_ranking(args, ds, score_fn, F_train, beta, backend, device)
        return
    qwyc = fit_qwyc(F_train, beta=beta, alpha=args.alpha, mode=args.mode)
    print(
        f"[serve] QWYC fit: train mean models {qwyc.train_mean_models:.2f}/{args.T} "
        f"diff {qwyc.train_diff_rate:.4f}"
    )

    producer_kw = (
        {"score_fn": score_fn}
        if args.eager
        else {"chunk_score_fn": make_chunk_score_fn(qwyc.order)}
    )
    if on_device and not args.eager:
        # fully lazy device path; chunk_score_fn stays as the audit reader
        producer_kw["scorer"] = make_scorer()
    audit = args.audit or args.eager or args.watchdog
    common_kw = dict(
        batch_size=args.batch_size,
        chunk_t=args.chunk_t,
        audit_full_scores=audit,
        score_block_n=1 if args.eager else SCORE_BLOCK_N,
        exec_backend=backend,
        device=device,
        quarantine=args.quarantine,
        watchdog=True if args.watchdog else None,
        **producer_kw,
    )
    if args.streaming:
        server = StreamingServer(
            qwyc, window=args.stream_window, max_wait=args.max_wait, **common_kw
        )
        # deterministic Poisson arrival trace (stage-step units): the seed of
        # the streaming protocol, so the CLI's numbers repeat run to run
        arr_rng = np.random.default_rng(ARRIVAL_SEED)
        arrivals = np.cumsum(
            arr_rng.exponential(1.0 / args.arrival_rate, size=len(ds.y_test))
        )
    else:
        server = QWYCServer(qwyc, backend=args.policy, **common_kw)
        arrivals = None
    x_test = ds.x_test
    if chaos is not None:
        if args.chaos_poison > 0:
            x_test, poisoned = chaos.poison(x_test)
            print(
                f"[serve] chaos seed {args.chaos_seed}: poisoned "
                f"{int(poisoned.sum())}/{len(x_test)} rows"
            )
        chaos.__enter__()

    # a SIGINT/SIGTERM during the submit loop stops admission, drains the
    # queue (partial final flush) and still prints the final ServeStats
    stop: dict = {}
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop["sig"] = signal.Signals(signum).name

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread: run unguarded
            pass
    try:
        for i in range(len(ds.y_test)):
            if stop:
                print(
                    f"[serve] caught {stop['sig']} after {i} submit(s): "
                    "draining queued requests"
                )
                break
            if arrivals is None:
                server.submit(x_test[i])
            else:
                server.submit(x_test[i], arrival=arrivals[i])
        results = server.drain()
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if chaos is not None:
            chaos.__exit__(None, None, None)

    st = server.stats
    served = [(r, y) for r, y in zip(results, ds.y_test) if not r.get("quarantined", False)]
    acc = np.mean([r["decision"] == bool(y) for r, y in served]) if served else float("nan")
    if args.streaming:
        print(
            f"[serve] streaming: {st.admitted_rows} admitted over "
            f"{st.stream_steps} stage steps in {st.n_batches} wave(s)  "
            f"mean occupancy {st.mean_occupancy:.1%}\n"
            f"        latency (steps) mean {st.latency_mean:.1f}  "
            f"p50 {st.latency_p50:.0f}  p95 {st.latency_p95:.0f}  "
            f"p99 {st.latency_p99:.0f}"
            + (f"  (max_wait={args.max_wait})" if args.max_wait is not None else "")
        )
    print(
        f"[serve] {st.n_requests} requests in {st.n_batches} batches "
        f"({server.exec.name} backend, "
        f"{'streaming' if args.streaming else args.policy + ' policy'}, "
        f"{'eager' if args.eager else 'lazy'})\n"
        f"        mean models {st.mean_models:.2f}/{args.T}  "
        f"modeled speedup {st.speedup:.2f}x\n"
        f"        scores computed {st.scores_computed}/{st.scores_possible} "
        f"({st.compute_fraction:.1%} of eager; +{st.audit_scores} audit)\n"
        f"        diff vs full "
        + (f"{st.diff_rate:.4f}" if audit else "n/a (pass --audit)")
        + f" (alpha={args.alpha})  test acc {acc:.4f}"
    )
    # guarded-serving counters (outside the billing gate's keys)
    guard_bits = []
    if st.quarantined:
        guard_bits.append(f"quarantined {st.quarantined}")
    if st.degradation_events:
        falls = [
            f"{e.from_backend}->{e.to_backend}"
            for e in st.degradation_events
            if e.from_backend != e.to_backend
        ]
        recoveries = len(st.degradation_events) - len(falls)
        guard_bits.append(
            "ladder "
            + ", ".join(falls + ([f"{recoveries} same-rung recovery(ies)"] if recoveries else []))
        )
    if args.watchdog:
        guard_bits.append(
            f"watchdog {st.watchdog_state} (alarms {st.watchdog_alarms}, "
            f"llr {st.watchdog_stat:.2f}"
            + (
                f", recovered at flush {st.watchdog_recovery_step}"
                if st.watchdog_recovery_step is not None
                else ""
            )
            + ")"
        )
    if guard_bits:
        print("[serve] guards: " + "  |  ".join(guard_bits))


if __name__ == "__main__":
    main()
