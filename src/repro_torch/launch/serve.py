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
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import scorers
from repro_torch.api.registry import backend_names, resolve_backend
from repro_torch.core import fit_qwyc
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.ensembles.gbt import train_gbt
from repro_torch.ensembles.lattice import init_lattice_ensemble, train_lattice_ensemble
from repro_torch.kernels import ops
from repro_torch.serving.engine import BACKENDS as POLICIES
from repro_torch.serving.engine import QWYCServer

# row-block size for the lazy chunked score kernels: survivors are padded
# up to a multiple of this (billed honestly via score_block_n below)
SCORE_BLOCK_N = 64


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
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    backend = resolve_backend(args.backend, device=device)
    on_device = backend.capabilities.on_device

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
    audit = args.audit or args.eager
    server = QWYCServer(
        qwyc,
        backend=args.policy,
        batch_size=args.batch_size,
        chunk_t=args.chunk_t,
        audit_full_scores=audit,
        score_block_n=1 if args.eager else SCORE_BLOCK_N,
        exec_backend=backend,
        device=device,
        **producer_kw,
    )
    for i in range(len(ds.y_test)):
        server.submit(ds.x_test[i])
    results = server.drain()

    st = server.stats
    acc = np.mean([r["decision"] == bool(y) for r, y in zip(results, ds.y_test)])
    print(
        f"[serve] {st.n_requests} requests in {st.n_batches} batches "
        f"({server.exec.name} backend, {args.policy} policy, "
        f"{'eager' if args.eager else 'lazy'})\n"
        f"        mean models {st.mean_models:.2f}/{args.T}  "
        f"modeled speedup {st.speedup:.2f}x\n"
        f"        scores computed {st.scores_computed}/{st.scores_possible} "
        f"({st.compute_fraction:.1%} of eager; +{st.audit_scores} audit)\n"
        f"        diff vs full "
        + (f"{st.diff_rate:.4f}" if audit else "n/a (pass --audit)")
        + f" (alpha={args.alpha})  test acc {acc:.4f}"
    )


if __name__ == "__main__":
    main()
