"""Training launcher: end-to-end LM training, the counterpart of
``repro.launch.train`` with its flags, defaults and printed lines.

Trains a reduced variant of any registered architecture (``--arch`` plus
the scale flags) on the synthetic token stream, then prints whether the
loss fell: ``loss a -> b (OK | NO PROGRESS)``, comparing the means of the
first and last tenth of the steps.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --layers 4 --d-model 256 --steps 200 --batch 8 --seq 256

``--device`` picks the torch device: ``cuda`` (the default, an error
without a card) or ``cpu``.  The weights are drawn from a
``torch.Generator`` seeded 0 on that device, not bit-equal to the
reference's ``jax.random`` draw.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batches
from repro_torch.device import resolve_device
from repro_torch.models.config import param_count
from repro_torch.models.steps import init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device (cuda needs a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_config(args.arch)
    cfg = base.scaled(
        n_layers=args.layers,
        d_model=args.d_model,
        d_ff=args.d_ff,
        n_heads=args.heads,
        n_kv_heads=min(args.kv_heads, args.heads),
        head_dim=args.d_model // args.heads,
        vocab_size=args.vocab,
        n_experts=min(base.n_experts, 8),
        n_shared_experts=min(base.n_shared_experts, 1),
        top_k=min(base.top_k, 2),
        moe_d_ff=min(base.moe_d_ff, 256) if base.moe_d_ff else 0,
        sliding_window=min(base.sliding_window, 64) if base.sliding_window else 0,
        rnn_heads=min(base.rnn_heads, 8) if base.rnn_heads else 0,
        n_frontend_tokens=min(base.n_frontend_tokens, 16),
    )
    print(f"[train] {cfg.name} reduced: ~{param_count(cfg)/1e6:.1f}M params")

    params, opt = init_train_state(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
    step_fn = make_train_step(cfg, lr=args.lr, microbatch=args.microbatch)
    batches = make_batches(
        cfg.vocab_size,
        args.batch,
        args.seq,
        n_frontend_tokens=cfg.n_frontend_tokens,
        d_model=cfg.d_model,
    )
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(batches).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            print(
                f"[train] step {i+1:5d} loss={losses[-1]:.4f} "
                f"grad_norm={float(metrics['grad_norm']):.3f} {dt:.2f}s/step"
            )
            t0 = time.time()
    first = np.mean(losses[: max(1, args.steps // 10)])
    last = np.mean(losses[-max(1, args.steps // 10) :])
    print(f"[train] loss {first:.4f} -> {last:.4f} ({'OK' if last < first else 'NO PROGRESS'})")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, params)
        print(f"[train] checkpoint -> {path}")


if __name__ == "__main__":
    main()
