#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run on failure:

1. Environment: Python, torch and CUDA versions, the card and its power
   limit (``nvidia-smi``).
2. Build: ``nvcc`` compiles every kernel source of ``src/repro_torch/csrc``
   (one process per source, all at once) into ``build/repro_torch_kernels``,
   and fails unless every tree and lattice instantiation of
   ``mega_stage.cu``'s step kernel, and every instantiation of its matrix
   step kernel, holds 0 bytes of stack and spills none.
3. Each kernel (B1 cascade, B2 cascade_chunk and its step form, B3
   gbt_scores, B4 mega_stage
   tree, matrix and lattice, B5 lattice_scores, B6 cascade_lane, B7
   mega_lane tree, matrix and lattice, B8 cascade_group) against its plain
   PyTorch version on
   the card, at the main paths' shapes and at the edges (n_valid 0, a
   ragged last block, ±inf padded columns, rows retiring mid-block, lattice
   inputs at the cube's corners, rows that never exit, the ±inf "full
   evaluation" thresholds; for B6 and B7 lanes at every stage in one
   block and last-stage lanes; for B8 tied scores, groups of at most k
   documents, n_live 0): every output ``torch.equal``.  Then B4 and B7
   at quantised slabs (tree and lattice at bf16 and int8, matrix at bf16:
   ten variants) on the same plans and buffers, with raw payloads off the
   grid: every output ``torch.equal`` to the plain version.  Then B4 and
   B7 lattice at S 1-8 and tree at depths 1-12 (``LATTICE_DIMS``,
   ``TREE_DEPTHS``), every storage, blocks of 64 and of 50 rows, B7's lanes
   over every stage or all at the ragged last one.  Then B4 and B7 matrix
   at W 1, 8 and 13 (misaligned stage starts), f32 and bf16, B4 both
   gathered and reading the operand in place through ``rows``.  B3 at
   every tile shape (tk 1, 7, 8, 33, 500) and depth (1-9, 12, 15, 16;
   leaf tables staged or read in place), rows clamped at both ends, n = 0
   and n not a multiple of the block, and one tree at depth 30 (a 4 GiB
   table read in place); B5 at S 1-8 on both sides of its regime switch
   (team form and one thread a pair).  B6 in its step form (the unfused
   streaming step's: stage tables read in place, masked columns, stop
   lanes, the pack written) at 256, 1024 and 1300 lanes, all six outputs
   equal; B2's step form (the unfused batch stage's: partial sums read
   through the row ids, the stage's tables read in place, the pack
   written, the last stage's survivors kept) at caps 1, 31, 256, 1024,
   1025 and 1300, W 8 (aligned and misaligned rows), 3 and 12, n_valid
   mid-block, NaN scores, all six outputs equal; B1 at (2000, 500)
   qwyc-like and at ±inf, (1, 1), (33, 7), T = 499 with chunk 7, T odd
   (rows not 16-byte aligned) and 4096 x 512 / 513; B8 with ``rows``
   (its top-k picks) at B 1, 4, 31, 32, 33, 64 and 256, k 1, 10 and B + 3, on integer ties, -0.0 / +0.0 ties, -inf on valid
   lanes and groups with a valid NaN or -NaN, n_live None, a device scalar
   and a host int: picks and exits equal, margins equal by their bits (a
   zero margin between a -0.0 and a +0.0 by value, and counted); and B8 as
   the grouped streaming step launches it, each group's threshold its own
   slot's stage value (S = 8 values, 0 and +inf among them, in every
   launch), n_live a device scalar, B 4, 32 and 64, k 1 and 10.
4. The first main path, paper experiment 1 (exp1_adult) at full width: the
   adult dataset (8000 train / 2000 test rows, D = 14), ``train_gbt`` with
   T = 500 depth-5 trees, the calibration matrix with B3, ``fit_qwyc`` at
   alpha = 0.005 (mode ``both``), then ``QWYCServer`` (device backend,
   sorted-kernel, batch 256, chunk_t 8) over the test rows.  The verdicts, models
   evaluated and full scores equal the same server run with device="cpu"
   (the plain versions) and the ``evaluate_cascade`` oracle; megakernel on
   equals off (results and billing; off is B3 + B2's step form, once a
   stage).  The same cascade on the host rung with the kernel decide
   (``compile("host", decide="kernel")``: B2 in the reference's form once
   a stage) equals ``evaluate_cascade`` on the test score matrix.
4b. The second main path, paper experiment 4 (exp4_rw2_joint) at full
   width: rw2 (8000 / 2000 rows, D = 30), T = 500 lattices over S = 8
   features trained jointly (300 AdamW steps on the card), the calibration
   matrix with B5, ``fit_qwyc`` (alpha 0.005, neg_only).  Eager: B5 on the
   test rows, the columns ordered, ``ops.cascade_decide`` (B1), equal to
   ``evaluate_cascade``.  Served: the lattice server fused (B4 lattice) and
   unfused (B5 + B2's step form), both equal to the same server on the CPU
   and to the eager B1 verdicts.
4c. Streaming admission: both cells' ensembles and cascades (no new fit)
   served by ``StreamingServer`` (capacity 256, window 1024, chunk_t 8,
   block 64) over the test rows under the seed-2028 Poisson trace at 256
   and 4.0 requests per stage step: fused (B7), unfused (lane_fn + B6),
   eager for exp1 (B3 score matrix + B7 matrix) and on the CPU, all equal
   in results and every wave's timeline, verdicts equal to
   ``evaluate_cascade``, ``g_final`` equal bit for bit to phase 4/4b's
   batch server, and (at the heavy rate) occupancy above the flush
   server's at the same capacity.
4d. Query-level ranking exit: exp1's GBT and phase 4's calibration matrix
   and order, the rows cut into ragged query groups (Poisson mean 16, seed
   2031), ``api.fit(groups=, topk=10)`` at alpha 0.05, the test queries
   served by ``compile(...).serve(score_fn=B3, batch_size=256)`` on the card
   (B3 + B8 per stage, B8 picking each query's top k), with
   device="cpu", on the host rung and by ``run_grouped_host``: verdicts,
   exit stages and margins equal bit for bit; the margin-inf run equals
   ``full_cascade_topk``.  The server pins its operand to ``RANK_DOCS``
   rows, so a bucket shape is one program across flushes: the first drain
   runs each eagerly, the second captures it, the third replays it, and a
   drain of 126 never-seen (train) queries replays the same graphs, equal
   to ``capture=False`` and to ``run_grouped_host``.
4e. Quantised parameter slabs: phase 4's and 4b's ensembles and fits (no
   new fit) at bf16 and int8 slabs, the test rows served by ``QWYCServer``
   (batch 256, policy ``kernel``, ``megakernel=True``: B4 at the slabs'
   storage) and ``StreamingServer`` (256 requests/step, capacity 256,
   window 1024: B7), and exp1's test score matrix at bf16 through
   ``DeviceExecutor`` (B4 and B7 matrix): card == CPU bit for bit
   (verdicts, exits, g_final, billing), batch == streaming, and on the
   weights rounded onto the grid quantised serving == f32 serving exactly;
   on the raw weights g within ``tolerance_bound`` of f32 serving wherever
   the exit did not move (moved verdicts and exits are reported).
   In phases 4-4e and 4h-4m the launch counts are set to 0 just before each path and
   read just after it: each path must have launched exactly its own kernels
   (a streaming path its B6 or B7 once per step enqueued; the ranking path
   one B8 per stage and per epilogue of each bucket wave, and one B3 per
   flush).  Every served path on the card runs its loop as a CUDA graph
   (one a program key: a key's first flush or wave runs eagerly, its
   second captures the graph and every later one replays it; a replay
   counts the launches its capture recorded), and is held against the
   same server with ``capture=False``: results, every flush's or wave's
   verdicts, exits, ``g_final`` bits, live counts and timeline, billing
   and launch counts equal; one graph a server (one a bucket shape for
   ranking), none recaptured.
4f. The port's billing gate (``benchmarks/torch/perf_gate.py --device
   cuda --check``): the reference gate's fixtures on the card, the 51
   reachable keys (the ``*.traces`` keys among them) equal to
   ``benchmarks/results/baseline_billing.json``, the 76 others pending
   (``*.sharded*``).
4g. Grouped streaming: phase 4d's fit (no new fit) serves the 126 test
   queries through ``serve(streaming=True)`` under ``skip-ahead`` and
   ``wait``, each query at its seed-2028 Poisson arrival at 4.0 queries a
   stage step (B3 once a flush, B8 once a step enqueued at each slot's own
   stage threshold), equal to the same server with ``capture=False``
   (every wave's verdicts, exit stages, margin bits, admit / done
   timeline, bill, launches), to ``device="cpu"`` and to
   ``run_grouped_host``; the second drain captures what the first ran
   eagerly, the third replays and recaptures nothing; and
   ``run_stream_grouped`` alone on the largest bucket at 8 slots (groups
   refill freed slots mid-cascade), eager, captured and replayed, equal
   to its CPU run and to the batch ``run_grouped``.
4h. The paper's baselines and variants on exp1 (phase 4's trees, matrices
   and QWYC fit): ``gbt_order``, ``random_order``, ``individual_mse_order``,
   ``greedy_mse_order`` and the QWYC order, each with
   ``fit_thresholds_for_order`` (the QWYC fit's own thresholds for its
   order), the test matrix decided by B1 (equal to ``evaluate_cascade``)
   and by the masked walk ``cascade_from_scores`` on the card (equal to
   B1, its ``g_final`` equal to the CPU walk's bit for bit); Fan et al. on
   the individual-MSE order; ``fit_qwyc_sharded`` on the card equal to its
   CPU run on the first ``SWEEP_ROWS`` rows and ``SWEEP_T`` trees; and
   ``expert_contributions`` at Qwen3-30B-A3B's MoE widths (``MOE_WIDTHS``,
   2.4 GB of seeded f32 weights) on the card against the CPU: the same
   experts routed, within ``1e-5 * max|c| + 1e-6``.  Mean models per
   ordering and for Fan are printed.
4i. Guarded serving on exp1: rows poisoned with NaN, +inf and -inf through
   B1, B2 (both forms), B6, B4 and B7 (tree, matrix, lattice) at the main
   paths' shapes equal the plain version on the card, their clean lanes
   the clean call bit for bit; the captured batch-256 server over the test
   rows with 5 % poisoned (``FaultPlan``) quarantines exactly those rows
   and keeps phase 4's other verdicts; one injected wave fault recovers on
   the device rung; with every device wave failing, the eager server falls
   to the host (B3 + B2's reference form), verdicts unchanged.  Every
   other phase fails if the ladder records any event (``LadderWatch``).
4j. The neural depth cascade at Qwen3-1.7B's published widths (28 layers,
   d_model 2048, 16 / 8 heads of 128, d_ff 6144, vocab 151936, qk_norm,
   an exit head every 2 layers: 14 exits), f32 weights drawn on the card
   from ``NEURAL_SEED``, seeded uniform tokens of 128: the calibration of
   1024 sequences with the chunked ``exit_scores``, ``api.fit`` at alpha
   0.02 (order ``arange(14)``, cost 2 a stage, W 2: 7 stages; the
   calibration disagreement within alpha), then 256 test sequences
   through ``QWYCServer(scorer=NeuralScorer)`` at batch 64, captured and
   ``capture=False`` (equal in every result, B2's step form 7 times a
   flush), verdicts equal to ``evaluate_cascade`` on the test exit scores
   outside a 1e-4 band, mean layers paid below 28; the captured and eager
   flush walls against a full-depth forward at the same batch; an 8-layer
   cut of the same widths through ``StreamingServer`` (B6 once a step
   enqueued) equal to the batch path on the same rows outside the band;
   B2's and B6's step forms equal to their plain versions on the neural
   stages' own scores; the cut's query groups through ``run_grouped`` (B8
   once a stage and for the epilogue) and ``run_stream_grouped`` (B8 once
   a step enqueued), eager, captured and replayed equal to
   ``capture=False`` bit for bit, and the card equal to the CPU and the
   streaming loop to the batch loop outside the band; a 2-layer cut's exit
   scores on the card within ``NEURAL_TOL`` of the CPU's (TF32 off);
   ``torch.cuda.max_memory_allocated``.
4k. The neural depth cascade over the other model families, f32 with TF32
   off, seeded tokens of 128, weights drawn on the card from
   ``FAMILY_SEED``.  Qwen3-MoE-30B-A3B at its published widths (d_model
   2048, 32 / 4 heads of 128, 128 experts top-8 of d_ff 768, vocab 151936,
   qk_norm), its depth cut to 16 of 48 layers, an exit every 2 layers (8
   exits, W 2: 4 stages): 512 calibration sequences (each MoE layer over
   all 65,536 tokens in one call), ``api.fit`` at alpha 0.02, 256 test
   sequences through ``QWYCServer(scorer=NeuralScorer)`` at batch 64,
   captured == ``capture=False`` (B2's step form 4 times a flush), the
   flush walls and layers paid, the share of (token, slot) assignments the
   capacity dropped in the calibration and in one flush; an 8-layer cut
   through ``StreamingServer`` (B6 once a step enqueued, captured ==
   ``capture=False``); a 2-layer cut through the batch loop at cap 16 on
   the card and the CPU, equal outside a 1e-4 band on the rows before the
   first token whose k-th and (k+1)-th router probabilities lie within
   1e-5 (counted).  RWKV6-1.6B whole (24 layers, 12 exits, 6 stages): 1024
   calibration sequences, the fit, batch serving captured == eager,
   verdicts equal to ``evaluate_cascade`` outside the band, a 2-layer cut's
   exit scores card vs CPU.  Then ``exit_scores`` card vs CPU on 2-layer
   cuts at full widths of DeepSeek-V2-Lite (MLA, a dense first layer, 64
   routed + 2 shared experts top-6), gemma2-2B (L, G, softcaps) and
   musicgen-large (64 frontend embeddings), and RecurrentGemma-2B at 3
   layers (R, R, L: the hybrid loop); ``max_memory_allocated`` a family.
   To run it alone, build (``_build.build_all()``) and call
   ``chip_smoke.phase_families({"card": ...}, {})``.
4l. Decode at Qwen3-1.7B's published widths, f32 weights drawn on the
   card from ``DECODE_SEED``, TF32 off: 8 prompts of 512 tokens of the
   seed's ``TokenStream``, ``make_prefill_step`` into an f32
   ``init_cache`` of 544 positions, 32 greedy ``make_decode_step`` calls;
   every step's logits (and the prefill's last) within ``DECODE_TOL``
   of the largest of the cache-less ``forward(serve=True)`` over the 544
   tokens, each greedy token its argmax wherever the top-2 gap exceeds
   twice that; the same tokens through a bf16 cache within
   ``DECODE_BF16_TOL``, the greedy tokens that differ counted; the
   prefill wall, the decode step wall (median, p90), tokens/s,
   ``max_memory_allocated`` and one decode step profiled (device time,
   launches, busy share, the leading kernels).  Then cuts at published widths of gemma2-2B,
   DeepSeek-V2-Lite (``mla_absorb`` off and on), Qwen3-MoE-30B-A3B,
   RWKV6-1.6B, RecurrentGemma-2B (3 layers), musicgen-large and
   InternVL2-26B (frontend embeddings in the prefill): 4 rows, a prefill
   and 8 decode steps on the card and the CPU, logits and caches within
   ``NEURAL_TOL`` on the rows before any token routed apart.
4m. Training at Qwen3-1.7B's published widths: ``init_train_state``
   from ``TRAIN_SEED``, ``make_batches(vocab, 4, 256, seed=0)``, lr 3e-4,
   clip 1.0.  From the first state and batch: remat (loss within 1e-6
   relative), ``microbatch=2`` (within 1e-5) and the plain step's params
   equal under tests/test_torch_train.py's rule (within 1e-6 outside the
   band of near-zero gradients, 2 lr inside it, the moved elements
   counted); ``compute_dtype=bfloat16`` within ``TRAIN_BF16_LOSS``.  Six
   plain and two remat steps timed (wall, TFLOP/s at 6 N tokens, peak
   memory of the step and of a forward and backward alone, one plain step
   profiled), every loss and ``grad_norm`` finite; a 2-layer cut card against CPU (loss,
   ``grad_norm``, gradients, params) and its checkpoint round trip bit
   for bit; ``python -m repro_torch.launch.train`` at its defaults in a
   process of its own, which must print ``OK``.  To run 4l and 4m alone,
   call ``chip_smoke.phase_decode({"card": ...}, {})`` and
   ``chip_smoke.phase_train({"card": ...}, {})`` (no kernel build needed).
5. Times, after a warm-up, each served path captured and (beside it) with
   ``capture=False``: the per-flush latency of both servers at batch
   128 / 256 / 1024, fused and unfused (host clock, median and p90 of 100
   flushes), the device's busy share of a batch-256 flush (profiler device
   time over the unprofiled median flush; the profile must see as many of
   the port's kernels as the flush launched); the streaming servers' drains
   (requests/s, wave and step wall times, steps and syncs per wave,
   PyTorch operator calls per step, one wave's busy share), fused and
   unfused (lane_fn + B6); the ranking server's drains of the test queries
   (the first and second drain, then median and p90 wall, PyTorch calls
   per grouped stage, one drain's busy share; no sort kernel may appear)
   and of 20 sets of never-seen queries (median and p90 wall); the
   streaming ranking server's drains (five a loop: drain and wave walls,
   steps run, enqueued and syncs a wave, one drain's busy share); exp1's eager path (B3 + B4
   matrix: flush latency at batch 128 / 256 / 1024 and one flush's busy
   share; B3 + B7 matrix: streaming waves at both rates); the PyTorch
   calls of an unfused batch-256 flush, by stage, both cells (no cumsum
   and no per-stage gather may remain: B2's step form does the decide's);
   exp1's trees
   served fused at f32 and at bf16 slabs (a batch-256 flush, a streaming
   wave); and each
   kernel's device time per launch (profiler) at its main-path shape beside
   its plain version's and its bound (B3 and B5 also at the sort key, the
   eager matrix and the calibration matrix; B8 with its picks beside B8
   and ``group_topk_rows``, and the stable sort alone; B6's step form
   beside the chain of gathers, B6 and compaction it replaces; B2's step
   form beside the gather, mask, B2 and cumsum pack it replaces).

Prints the card, then the ``kernels`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import math
import re
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
# profiled calls of a kernel's plain version (a kernel's own: 50)
N_PLAIN_REPS = 10
# phase 4c's streaming servers: lane capacity, admission ring, arrival rates
# (requests per stage step: the streaming benchmark's heavy traffic at the
# capacity, and the CLI's default), the protocol's trace seed; phase 5
# times N_DRAINS drains of the test rows at the heavy rate
STREAM_CAP, STREAM_WINDOW, STREAM_RATES = 256, 1024, (256.0, 4.0)
ARRIVAL_SEED = 2028
N_DRAINS = 5
# phase 4d's ranking configuration (the CLI's --groups 16 --topk 10, at the
# middle of benchmarks/bench_ranking.py's alphas), queries per flush, and
# phase 5's timed drains of the test queries
RANK_GROUP_MEAN, RANK_K, RANK_ALPHA, RANK_BATCH = 16, 10, 0.05, 256
N_RANK_DRAINS = 20
# the ranking server's pinned operand rows (a flush of up to RANK_DOCS docs
# runs one program a bucket shape) and the never-seen queries a drain
# serves (train queries, as many as the test set has)
RANK_DOCS, RANK_FRESH = 4096, 126
# phase 4g's grouped streaming: the test queries' Poisson arrival rate
# (queries a stage step, the CLI's default), the admission policies, and the
# slot count of the executor-level run (below the largest bucket's group
# count, so slots refill mid-cascade)
RANK_STREAM_RATE, RANK_POLICIES, RANK_STREAM_CAP = 4.0, ("skip-ahead", "wait"), 8
# phase 4h: the device candidate sweep's cut of exp1's calibration matrix
# (its first rows and trees), and the MoE layer of Qwen3-30B-A3B
# (src/repro/configs/qwen3_moe_30b_a3b.py: d_model, experts, top-k, expert
# d_ff) over a few hundred tokens, its weights drawn from MOE_SEED
SWEEP_ROWS, SWEEP_T = 2000, 64
MOE_WIDTHS, MOE_SEED = (2048, 128, 8, 768, 320), 2048
# phase 4i: the buffer rows poisoned with NaN, +inf, -inf, NaN
GUARD_POISON_ROWS = (3, 77, 150, 201)
# exp1's cascade modes: Filter-and-Score (neg_only) is served by the lattice
# phase, and exp1's own neg_only fit (a host fit_qwyc of about 25 s) is left
# out to keep the run near 300 s
GBT_MODES = ("both",)
# quantised slab storages (phases 3, 4e, 5): trees and lattices at both,
# the matrix variant at bf16 only
QUANTS = ("bf16", "int8")
QUANT_VARIANTS = [(v, q) for v in ("tree", "lattice") for q in QUANTS] + [("matrix", "bf16")]
# lattice input counts phase 3 holds B4 and B7 lattice to their plain
# versions at: every team shape of the warp-cooperative interpolation
LATTICE_DIMS = (1, 2, 4, 5, 6, 8)
# phase 4j: the neural depth cascade at Qwen3-1.7B's published widths
# (src/repro_torch/configs/qwen3_1_7b.py) with an exit head every 2 layers
# (14 exits), f32 weights drawn on the card from NEURAL_SEED; seeded
# uniform tokens of NEURAL_SEQ; calibration and test sequences; the fit's
# alpha and stage width (W 2: 7 stages); the servers' batch (lanes); the
# streaming cut's depth (8 layers, 4 exits) and its Poisson arrival rate
# (sequences a stage step) and ring; the card-vs-CPU cut's depth and rows;
# the tolerance the card's exit scores are held to against the CPU's
# (|card - cpu| <= NEURAL_TOL * max(1, max|cpu|), TF32 off); the band
# within which a verdict may move between a served path and the oracle on
# the calibration-route scores (other cuBLAS shapes sum in other orders)
NEURAL_SEED, NEURAL_SEQ, NEURAL_CALIB, NEURAL_TEST = 2030, 128, 1024, 256
NEURAL_ALPHA, NEURAL_CHUNK_T, NEURAL_BATCH = 0.02, 2, 64
NEURAL_STREAM_LAYERS, NEURAL_STREAM_RATE, NEURAL_WINDOW = 8, 16.0, 256
NEURAL_CPU_LAYERS, NEURAL_CPU_ROWS, NEURAL_TOL, NEURAL_BAND = 2, 8, 1e-4, 1e-4
# the grouped loops on the streaming cut: query groups of the test
# sequences in a bucket of width 2 (group 0 holds k documents: its margin
# is +inf), the ranking depth, and the groups' arrival steps in the
# streaming grouped loop (later groups join as rookies beside groups a
# stage further on).  The CPU runs the same loops over 8 group slots:
# 16 lanes of 8 layers at full width, 8 steps in the streaming loop
NEURAL_GROUPS, NEURAL_GROUP_B, NEURAL_K = 6, 2, 1
NEURAL_GROUP_ARRIVALS = (0, 0, 0, 1, 1, 2)
# phase 4k: the neural depth cascade over the other families.  Qwen3-MoE-
# 30B-A3B (src/repro_torch/configs/qwen3_moe_30b_a3b.py) at its published
# widths, cut to FAMILY_MOE_LAYERS of its 48 layers (a layer is 623e6 f32
# weights, 2.49 GB: the cut and the tied embedding are 41 GB), and
# RWKV6-1.6B whole (24 layers, 6.8 GB), each with an exit head every 2
# layers, weights drawn on the card from FAMILY_SEED, seeded tokens of
# NEURAL_SEQ; the calibration sequences (the MoE's in one call a layer:
# 65,536 tokens, 5120 slots an expert) and the test sequences; the MoE
# streaming cut's depth and sequences; the sequences of each card-vs-CPU
# cut; the other families' cuts (layers, an exit after each) held card
# against CPU through exit_scores; the router gap within which a token may
# route apart on the card and the CPU (a flip moves the queue places of the
# tokens after it in the call, so only the rows before it are held)
FAMILY_SEED = 2032
FAMILY_MOE_LAYERS, FAMILY_MOE_CALIB, FAMILY_RWKV_CALIB, FAMILY_TEST = 16, 512, 1024, 256
FAMILY_STREAM_LAYERS, FAMILY_STREAM_ROWS = 8, 128
FAMILY_CPU_ROWS, FAMILY_ROUTE_TIE = 16, 1e-5
FAMILY_CUTS = {"deepseek-v2-lite-16b": 2, "recurrentgemma-2b": 3, "gemma2-2b": 2,
               "musicgen-large": 2}
# phase 4l: decode at Qwen3-1.7B's published widths, f32 weights drawn on
# the card from DECODE_SEED: prompts of the seed's token stream, the
# cache's positions (prompt + greedy steps), the logits' tolerance against
# the cache-less forward (|decode - full| <= DECODE_TOL * max|full|) and a
# bf16 cache's against the f32 cache's; the families' card-vs-CPU cuts
# (prefill of DECODE_CUT_PROMPT tokens after any frontend embeddings, then
# DECODE_CUT_STEPS decode steps, the next tokens of the stream), held to
# NEURAL_TOL * max(1, max|cpu|)
DECODE_SEED, DECODE_B, DECODE_PROMPT, DECODE_STEPS = 2033, 8, 512, 32
DECODE_TOL, DECODE_BF16_TOL = 1e-4, 5e-3
DECODE_CUT_ROWS, DECODE_CUT_PROMPT, DECODE_CUT_STEPS = 4, 64, 8
DECODE_CUTS = [("gemma2-2b", 2, {}), ("deepseek-v2-lite-16b", 2, {}),
               ("deepseek-v2-lite-16b", 2, {"mla_absorb": True}), ("qwen3-moe-30b-a3b", 2, {}),
               ("rwkv6-1.6b", 2, {}), ("recurrentgemma-2b", 3, {}), ("musicgen-large", 2, {}),
               ("internvl2-26b", 2, {})]
# phase 4m: training at Qwen3-1.7B's published widths (init_train_state
# from TRAIN_SEED), make_batches(vocab, 4, 256, seed=0), steps timed plain
# and with remat; the 2-layer cut's batch held card against CPU; the
# updated-params rule of tests/test_torch_train.py (within 1e-6 outside the
# band |g| < TRAIN_BAND * max|g| of a leaf, within 2 lr + 1e-6 inside it,
# the elements there past 1e-6 under TRAIN_MOVED_SHARE of the tree: ten
# times the CPU test's, since most of the tied 151936-row embedding takes
# only the softmax's small gradients, which clipping puts within a few eps
# of 0: 167041 of 1.72e9 moved under microbatch 2 on one H100) and the
# bf16-compute step's loss within TRAIN_BF16_LOSS (relative) of f32's
TRAIN_SEED, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_REMAT_STEPS = 2034, 4, 256, 6, 2
TRAIN_LR, TRAIN_CLIP, TRAIN_CUT_B, TRAIN_CUT_S = 3e-4, 1.0, 2, 128
TRAIN_BAND, TRAIN_MOVED_SHARE, TRAIN_BF16_LOSS = 1e-4, 1e-3, 1e-2
# tree depths phase 3 holds B4 and B7 tree to their plain versions at:
# depths 1 and 10 (B3's old limit), exp1's and exp2_nomao's depths (5, 9), either
# side of the scorer's unrolled group of 10 levels (8, 12; 12 is reached by
# streaming only, and is where a B4 chunk holds fewer than W trees)
TREE_DEPTHS = (1, 2, 3, 5, 8, 9, 10, 12)
# B3's tree widths and depths in phase 3: every tile shape (one tile of tk
# trees, 17 + 16, 16 tiles of at most 32), every depth with a kernel of its
# own (1-8), the any-depth kernel with leaf tables staged (9, 12) and read
# in place (15, 16); then one tree at the new limit
B3_WIDTHS = (1, 7, 8, 33, 500)
B3_DEPTHS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16)
MAX_TREE_DEPTH_B3 = 30

KERNELS = {
    # name: (source, TPU kernel it replaces, the served path whose launches
    # the kernels line reports)
    "cascade": ("src/repro_torch/csrc/cascade.cu",
                "src/repro/kernels/cascade_kernel.py:127", "lattice_eager/neg_only"),
    "cascade_chunk": ("src/repro_torch/csrc/cascade_chunk.cu",
                      "src/repro/kernels/cascade_kernel.py:346", "host_kernel/both"),
    "cascade_chunk_step": ("src/repro_torch/csrc/cascade_chunk.cu",
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
    "cascade_group": ("src/repro_torch/csrc/cascade_group.cu",
                      "src/repro/kernels/cascade_kernel.py:474", "rank/both"),
}
# B4 and B7 at quantised slabs: phase 4e's batch and streaming paths
for _v, _q in QUANT_VARIANTS:
    _cell = "exp4" if _v == "lattice" else "exp1"
    KERNELS[f"mega_stage_{_v}_{_q}"] = ("src/repro_torch/csrc/mega_stage.cu",
                                        "src/repro/kernels/megakernel.py:556",
                                        f"q_batch_{_v}_{_q}/{_cell}")
    KERNELS[f"mega_lane_{_v}_{_q}"] = ("src/repro_torch/csrc/mega_stage.cu",
                                       "src/repro/kernels/megakernel.py:724",
                                       f"q_stream_{_v}_{_q}/{_cell}/r256")
# the kernels each path of phase 4 must launch; no other kernel may
PATH_KERNELS = {
    "calibration": {"gbt_scores"},  # the (N, 500) score matrices
    "fused": {"gbt_scores", "mega_stage_tree"},  # default: sort key + B4 tree
    "unfused": {"gbt_scores", "cascade_chunk_step"},  # megakernel=False: B3 + B2 step form
    "host_kernel": {"cascade_chunk"},  # the host rung's kernel decide: B2
    "cpu": set(),  # device="cpu": the plain versions only
    "eager": {"gbt_scores", "mega_stage_matrix"},  # score_fn matrix + B4 matrix
    "lattice_calibration": {"lattice_scores"},  # the (N, 500) score matrix
    "lattice_eager": {"lattice_scores", "cascade"},  # B5 test matrix + B1
    "lattice_fused": {"lattice_scores", "mega_stage_lattice"},  # sort key + B4
    "lattice_unfused": {"lattice_scores", "cascade_chunk_step"},  # B5 + B2 step form
    "lattice_cpu": set(),
    # phase 4c, streaming admission
    "stream_fused": {"mega_lane_tree"},  # B7 tree
    "stream_unfused": {"cascade_lane"},  # lane_fn (plain PyTorch) + B6
    "stream_eager": {"gbt_scores", "mega_lane_matrix"},  # score_fn matrix + B7 matrix
    "stream_cpu": set(),
    "lattice_stream_fused": {"mega_lane_lattice"},  # B7 lattice
    "lattice_stream_unfused": {"cascade_lane"},  # lane_fn + B6
    "lattice_stream_cpu": set(),
    # phase 4d, ranking: score_fn's B3 matrix per flush + B8 per stage and
    # per wave's epilogue; rank(margin_inf=True) over precomputed scores
    "rank": {"gbt_scores", "cascade_group"},
    "rank_inf": {"cascade_group"},
    # phase 4g, grouped streaming: score_fn's B3 matrix per flush + B8 per
    # step enqueued; run_stream_grouped alone over a score matrix: B8
    "rank_stream": {"gbt_scores", "cascade_group"},
    "rank_stream_exec": {"cascade_group"},
    # phase 4e, quantised slabs: each path its own kernel at its own storage
    # (grid: the same servers on weights rounded onto the grid, f32 and quantised)
    "q_cpu": set(),
    # phase 4h: B1 over each ordering's test matrix; the masked walk and the
    # MoE contributions are PyTorch ops (no kernel of the port)
    "orderings": {"cascade"},
    "walk": set(),
    "moe": set(),
    # phase 4i: the fused server (sort key B3 + B4 tree) poisoned and with a
    # recovered wave; the eager server fallen to the host (score_fn's B3 +
    # B2's reference form)
    "guard_quarantine": {"gbt_scores", "mega_stage_tree"},
    "guard_recover": {"gbt_scores", "mega_stage_tree"},
    "guard_fall": {"gbt_scores", "cascade_chunk"},
    # phase 4j: exit_scores (calibration, test scores, the full-depth
    # forward) runs PyTorch ops only; the neural batch loop decides through
    # B2's step form once a stage, the streaming loop through B6 once a step
    "neural_scores": set(),
    "neural_batch": {"cascade_chunk_step"},
    "neural_stream": {"cascade_lane"},
    # the grouped loops on the streaming cut: B8 once a stage and once for
    # the epilogue (batch), once a step enqueued (streaming)
    "neural_grouped": {"cascade_group"},
    "neural_stream_grouped": {"cascade_group"},
    # phase 4k: the other families' exit scores (calibration, test, full
    # depth, the card-vs-CPU cuts) run PyTorch ops only; the MoE and RWKV6
    # batch loops decide through B2's step form once a stage, the MoE
    # streaming cut through B6 once a step
    "family_scores": set(),
    "moe_batch": {"cascade_chunk_step"},
    "moe_stream": {"cascade_lane"},
    "rwkv_batch": {"cascade_chunk_step"},
    # phases 4l and 4m: decode and training run PyTorch ops only
    "decode": set(),
    "train": set(),
}
for _v, _q in QUANT_VARIANTS:
    PATH_KERNELS[f"q_batch_{_v}_{_q}"] = {f"mega_stage_{_v}_{_q}"}
    PATH_KERNELS[f"q_stream_{_v}_{_q}"] = {f"mega_lane_{_v}_{_q}"}
    PATH_KERNELS[f"q_grid_{_v}_{_q}"] = {f"mega_stage_{_v}_{_q}"}
    PATH_KERNELS[f"q_grid_f32_{_v}"] = {f"mega_stage_{_v}"}


class LadderWatch(logging.Handler):
    """Collects the degradation ladder's warnings (one a recorded event)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.events: list[str] = []

    def emit(self, record) -> None:
        self.events.append(record.getMessage())


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


def _runs_of(srv) -> list:
    """A server's executor results: each wave of a streaming server, each
    flush of a batch server."""
    return srv.stream_results if hasattr(srv, "stream_results") else srv.flush_results


def eager_twin(launches: dict, path: str, srv, res, twin, feed) -> None:
    """Holds the captured server ``srv`` (``res = feed(srv)``, counted as
    ``path``) against ``twin``, the same server with ``capture=False``:
    ``feed(twin)`` counted as ``path + "/eager"``.  Results, every flush's
    or wave's decisions, exits, g_final bits, live counts and timeline,
    billing and the launches are equal; each executor ran one program key
    (a server pins its capacity), the captured one holds its one graph (not
    recaptured across the flushes or waves), the eager one none."""
    import numpy as np

    got = counted(launches, f"{path}/eager", lambda: feed(twin))
    if got != res:
        raise AssertionError(f"{path}: captured results != capture=False results")
    if launches[f"{path}/eager"] != launches[path]:
        raise AssertionError(f"{path}: captured launches {launches[path]} != capture=False "
                             f"{launches[f'{path}/eager']}")
    runs, twins = _runs_of(srv), _runs_of(twin)
    if len(runs) != len(twins):
        raise AssertionError(f"{path}: {len(runs)} captured runs, {len(twins)} eager")
    for a, b in zip(runs, twins):
        for k in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
            if hasattr(a, k) and not np.array_equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"{path}: captured {k} != capture=False")
        if not np.array_equal(a.g_final.view(np.int32), b.g_final.view(np.int32)):
            raise AssertionError(f"{path}: captured g_final bits != capture=False")
        for k in ("chunk_stats", "scores_computed", "steps_run", "steps_enqueued", "syncs"):
            if getattr(a, k, None) != getattr(b, k, None):
                raise AssertionError(f"{path}: captured {k} != capture=False")
    for k in ("scores_computed", "models_evaluated", "chunk_survivors", "stream_steps",
              "latency_steps"):
        if getattr(srv.stats, k) != getattr(twin.stats, k):
            raise AssertionError(f"{path}: captured stats.{k} != capture=False")
    ex, tw = srv._dev[0], twin._dev[0]
    if not (ex.capture and not tw.capture and ex.traces == tw.traces == len(ex._graphs) == 1
            and not tw._graphs):
        raise AssertionError(f"{path}: traces {ex.traces} / {tw.traces}, graphs "
                             f"{len(ex._graphs)} / {len(tw._graphs)}, expected 1")


def device_work(prof) -> dict:
    """{name: (device us, count)} of the kernels and copies a profile saw
    (not the profiler's own step annotation, which spans the window on the
    device)."""
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and e.device_type.name == "CUDA" and not e.key.startswith("ProfilerStep"):
            out[e.key] = (float(dt), int(e.count))
    return out


def profile_device(window, prepare=None, tries: int = 3) -> dict:
    """``device_work`` of one profiled run of ``window()`` (after
    ``prepare()``, unprofiled).  The profiler gets a warm-up step first
    (``prepare()`` and ``window()`` once more, their events dropped):
    without it the first launches of a window went unrecorded on this card
    (44 of 50 kernel events, 14 of 20).  The profiler also now and then
    returns no device events for a window (seen once in a phase-5 window
    that the run before had timed): the window is profiled again, at most
    ``tries`` times in all, and the run fails if no attempt sees device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for step in range(2):  # the warm-up step, then the recorded one
                if prepare is not None:
                    prepare()
                torch.cuda.synchronize()
                if step == 1:
                    prof.step()
                window()
                torch.cuda.synchronize()
        work = device_work(prof)
        if work:
            return work
        log(f"[phase 5] profiler attempt {attempt + 1}/{tries} saw no device time")
    raise AssertionError(f"the profiler saw no device time in {tries} attempts")


# the port's own kernels (every __global__ of src/repro_torch/csrc) by name
PORT_KERNEL = re.compile(r"\b(?:cascade|cascade_chunk|chunk_step|cascade_lane|cascade_group|gbt_scores|"
                         r"lattice_scores|lattice_scores_team|step|matrix_step)_kernel\b")


def port_kernels(by_name: dict) -> dict:
    """The entries of a ``device_work`` dict that are the port's kernels."""
    return {k: v for k, v in by_name.items() if PORT_KERNEL.search(k)}


def device_time_ms(fn, reps: int = 50, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the profiler's sum over every
    kernel and copy it launched, over ``reps`` calls, per call, after a
    warm-up.  The host's time between launches is left out: at serving
    shapes a call costs the host tens of times what it costs the card.
    Every call launches the same kernels, so each kernel's event count is a
    multiple of ``reps``; a profile that is short is taken again, up to
    ``tries`` in all, and failing that each kernel's mean time counts once
    for every launch a call makes (its count over ``reps``, rounded).  A
    plain version's thousands of launches a call are profiled once
    (``tries=1``)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(reps):
            fn()

    for attempt in range(tries):
        work = profile_device(window)
        if all(c % reps == 0 for _, c in work.values()):
            return sum(us for us, _ in work.values()) / reps / 1e3
        log(f"[phase 5] profile {attempt + 1}/{tries} of {reps} calls: event counts "
            f"{sorted({c for _, c in work.values()})} are not all multiples of {reps}")
    return sum(us / c * max(1, round(c / reps)) for us, c in work.values()) / 1e3


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


def group_case(rng, G: int, B: int, kind: str):
    """(g, valid, rows) numpy arrays of G query groups in bucket width B for
    B8 with rows: integer scores (ties), ties of -0.0 and +0.0, -inf on
    valid lanes, or drawn scores with a valid NaN in group 2 and a valid
    -NaN in group 5; ragged sizes, an empty group 0 and a full group 1."""
    import numpy as np

    g = rng.integers(-3, 4, size=(G, B)).astype(np.float32)
    if kind == "signed zeros":
        g = np.where(g == 0, np.where(rng.uniform(size=(G, B)) < 0.5, -0.0, 0.0), g)
    elif kind == "-inf":
        g[rng.uniform(size=(G, B)) < 0.3] = -np.inf
    elif kind == "nan":
        g += rng.normal(scale=0.3, size=(G, B))
        g[2, rng.integers(B)] = np.nan
        g[5, rng.integers(B)] = -np.float32(np.nan)
    sizes = rng.integers(1, B + 1, size=G)
    sizes[:2] = [0, B]
    if kind == "nan":
        sizes[2] = sizes[5] = B
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    rows = rng.integers(0, 1 << 30, size=(G, B)).astype(np.int64)
    return g.astype(np.float32), valid, rows


def check_lane_step(check: Check, dev, eps_pos, eps_neg, col_valid, cascade_lane_step) -> None:
    """Phase 3: B6's step form against ``cascade_lane_step_plain``, as the
    unfused streaming step calls it: raw scores, the (S, W) tables read at
    each lane's stage (the ragged last stage's columns masked), stop lanes
    at the last stage, -0.0 partial sums; one CTA up to 1024 lanes, block
    prefixes and a combine past that."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_lane_step_plain

    def nv(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    S = eps_pos.shape[0]
    rng_s = np.random.default_rng(22)
    n_cases, kept = 0, 0
    for cap in (256, 1024, 1300):
        st = torch.from_numpy(rng_s.integers(0, S, size=cap).astype(np.int32)).to(dev)
        st[:S] = torch.arange(S, dtype=torch.int32, device=dev)
        sc = torch.from_numpy(rng_s.normal(size=(cap, 8)).astype(np.float32)).to(dev)
        gs = torch.from_numpy(rng_s.normal(size=cap).astype(np.float32)).to(dev)
        gs[::5] = -0.0
        for label, n_valid in [("all", None), ("nv=0", nv(0)), ("nv=cap", nv(cap)),
                               ("ragged nv", nv(cap - 57)), ("host nv", cap // 3)]:
            args = (gs, sc, st, eps_pos, eps_neg, col_valid)
            got = cascade_lane_step(*args, n_valid=n_valid, block_n=64)
            want = cascade_lane_step_plain(*args, n_valid=n_valid)
            check.equal("cascade_lane", f"step cap {cap} {label} g bits",
                        got[0].view(torch.int32), want[0].view(torch.int32))
            for k, (a, b) in enumerate(zip(got[1:], want[1:])):
                check.equal("cascade_lane", f"step cap {cap} {label} output {k + 1}", a, b)
            kept += int(got[5])
            n_cases += 1
        if not bool((want[3] > 0).any() and ((want[1] == 1) & (st == S - 1)).any()):
            raise AssertionError(f"B6 step check (cap {cap}): no exit or no active stop lane")
    # W 2, the neural cascade's stage width (scalar loads, each lane's own
    # table row): tables of 2 stages (phase 4j's streaming cut) and 7 (its
    # full depth), the last stage ragged, at phase 4j's 64 lanes and past
    # one CTA
    rng_2 = np.random.default_rng(24)
    for S2 in (2, 7):
        tables = w2_tables(rng_2, S2, dev)
        for cap in (64, 1300):
            st = torch.from_numpy(rng_2.integers(0, S2, size=cap).astype(np.int32)).to(dev)
            st[:S2] = torch.arange(S2, dtype=torch.int32, device=dev)
            sc = torch.from_numpy(rng_2.normal(size=(cap, 2)).astype(np.float32)).to(dev)
            gs = torch.from_numpy(rng_2.normal(size=cap).astype(np.float32)).to(dev)
            gs[::5] = -0.0
            for label, n_valid in [("all", None), ("nv=0", nv(0)), ("ragged nv", nv(cap - 9)),
                                   ("host nv", cap // 3)]:
                args = (gs, sc, st, *tables)
                got = cascade_lane_step(*args, n_valid=n_valid, block_n=64)
                want = cascade_lane_step_plain(*args, n_valid=n_valid)
                what = f"step W 2 S {S2} cap {cap} {label}"
                check.equal("cascade_lane", f"{what} g bits",
                            got[0].view(torch.int32), want[0].view(torch.int32))
                for k, (a, b) in enumerate(zip(got[1:], want[1:])):
                    check.equal("cascade_lane", f"{what} output {k + 1}", a, b)
                kept += int(got[5])
                n_cases += 1
            if not bool((want[3] > 0).any()):
                raise AssertionError(f"B6 step check (W 2, S {S2}, cap {cap}): no exit")
    if not kept:
        raise AssertionError("B6 step check: no lane was kept")
    log(f"[phase 3] B6 cascade_lane step form (W 8 caps 256, 1024, 1300; W 2 at 2 and 7 "
        f"stages, caps 64, 1300) == plain ({n_cases} cases, {kept} lanes kept)")


def w2_tables(rng, S: int, dev) -> tuple:
    """(eps_pos, eps_neg, col_valid) tables of ``S`` stages of width 2 on
    ``dev``: drawn thresholds, stage 1 at ±inf, the last stage ragged (its
    second column masked, at ±inf)."""
    import numpy as np
    import torch

    ep = rng.uniform(0.3, 2.0, size=(S, 2)).astype(np.float32)
    en = -rng.uniform(0.3, 2.0, size=(S, 2)).astype(np.float32)
    col = np.ones((S, 2), bool)
    ep[1], en[1] = np.inf, -np.inf
    col[S - 1, 1], ep[S - 1, 1], en[S - 1, 1] = False, np.inf, -np.inf
    return tuple(torch.from_numpy(a).to(dev) for a in (ep, en, col))


def check_chunk_step(check: Check, dev, eps_pos, eps_neg, col_valid, cascade_chunk_step) -> None:
    """Phase 3: B2's step form against ``cascade_chunk_step_plain``, as the
    unfused batch stage calls it: the partial sums read through the row
    ids from a (cap + 1,) buffer (-0.0 entries; the trash slot for the
    lanes past n_valid), the (S, W) tables read at a stage, NaN scores.
    W 8 on exp1's plan geometry (the lead stage, a full stage, the ragged
    last stage) with the rows 16-byte aligned and misaligned; W 3 and 12
    (scalar loads, a partial group) on tables of 5 stages (a full stage, a
    ±inf one, a ragged last one); W 2, the neural cascade's, on tables of
    7 stages (the first, a ±inf one, the ragged last one), at phase 4j's
    64 rows too.  Caps 1 to 1300: one CTA up to 1024 lanes, block
    prefixes and a combine past that.  All six outputs equal, ``g`` by
    its bits; the last stage's survivors are kept."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_chunk_step_plain

    def nv(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng_s = np.random.default_rng(23)
    n_cases, kept, exits = 0, 0, 0
    for form in ("8", "8 misaligned", "3", "12", "2"):
        W = int(form.split()[0])
        caps = (1, 31, 64, 256, 1300) if W == 2 else (1, 31, 256, 1024, 1025, 1300)
        if W == 8:
            tables, stages = (eps_pos, eps_neg, col_valid), (0, 5, eps_pos.shape[0] - 1)
        elif W == 2:
            tables, stages = w2_tables(rng_s, 7, dev), (0, 1, 6)
        else:
            ep = rng_s.uniform(0.3, 2.0, size=(5, W)).astype(np.float32)
            en = -rng_s.uniform(0.3, 2.0, size=(5, W)).astype(np.float32)
            col = np.ones((5, W), bool)
            ep[1], en[1] = np.inf, -np.inf
            col[4, W - 2:], ep[4, W - 2:], en[4, W - 2:] = False, np.inf, -np.inf
            tables, stages = (t(ep), t(en), t(col)), (2, 1, 4)
        for cap in caps:
            g = rng_s.normal(scale=0.5, size=cap + 1).astype(np.float32)
            g[::7] = -0.0
            g = t(g)
            raw = rng_s.normal(size=(cap, W)).astype(np.float32)
            raw[rng_s.integers(cap), rng_s.integers(W)] = np.nan
            if form == "8 misaligned":  # rows 4 bytes past a 16-byte boundary
                scores = torch.empty(cap * W + 1, device=dev)[1:].view(cap, W)
                scores.copy_(t(raw))
            else:
                scores = t(raw)
            for label, n_valid in [("all", None), ("nv=0", nv(0)), ("nv=cap", nv(cap)),
                                   ("mid-block nv", nv(min(cap, cap // 2 + 5))),
                                   ("host nv", cap // 3)]:
                live = cap if n_valid is None else min(cap, int(n_valid))
                rows = np.full(cap, cap, np.int64)
                rows[:live] = rng_s.permutation(cap)[:live]
                rows = t(rows)
                for s in stages:
                    args = (g, rows, scores, s, *tables)
                    got = cascade_chunk_step(*args, n_valid=n_valid, block_n=64)
                    want = cascade_chunk_step_plain(*args, n_valid=n_valid)
                    what = f"W {form} cap {cap} {label} stage {s}"
                    check.equal("cascade_chunk_step", f"{what} g bits",
                                got[0].view(torch.int32), want[0].view(torch.int32))
                    for k, (a, b) in enumerate(zip(got[1:], want[1:])):
                        check.equal("cascade_chunk_step", f"{what} output {k + 1}", a, b)
                    kept += int(got[5])
                    exits += int((got[3] > 0).sum())
                    n_cases += 1
    if not (kept and exits):
        raise AssertionError(f"B2 step check: {kept} lanes kept, {exits} exits")
    log(f"[phase 3] B2 cascade_chunk step form (caps 1-1300, W 8 / 8 misaligned / 3 / 12 / 2) "
        f"== plain ({n_cases} cases, {kept} lanes kept, {exits} exits)")


def check_group_rows(check: Check, dev, cascade_group_kernel, G: int = 37) -> None:
    """Phase 3: B8 with rows (the grouped loop's form): picks, exits and
    margins against ``cascade_group_plain`` + ``group_topk_rows`` over every
    bucket-width regime (one warp a group up to 32 lanes, one CTA past
    that), k 1, 10 and past B, the four kinds of ``group_case`` and n_live
    None, a device scalar and a host int."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_group_plain, group_topk_rows

    def nv(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    rng_g = np.random.default_rng(23)
    n_cases, picked, zero_signs = 0, 0, 0
    for B in (1, 4, 31, 32, 33, 64, 256):
        for k in (1, 10, B + 3):
            for kind in ("ties", "signed zeros", "-inf", "nan"):
                gg, valid, rows_g = group_case(rng_g, G, B, kind)
                eps = rng_g.uniform(0.0, 2.0, size=G).astype(np.float32)
                eps[3], eps[4] = np.inf, 0.0
                args = [torch.from_numpy(a).to(dev) for a in (gg, valid, eps)] + [k]
                rows_t = torch.from_numpy(rows_g).to(dev)
                for n_live in (None, nv(0), nv(20), 29):
                    m, e, p = cascade_group_kernel(*args, n_live=n_live, rows=rows_t)
                    wm, we = cascade_group_plain(*args, n_live=n_live)
                    wp = group_topk_rows(args[0], args[1], rows_t, k)
                    what = f"rows B={B} k={k} {kind} n_live {n_live}"
                    check.equal("cascade_group", f"{what} picks", p, wp)
                    check.equal("cascade_group", f"{what} exit", e, we)
                    # margins by their bits; a zero between a -0.0 and a
                    # +0.0 may take either sign (the plain max returns
                    # either zero of a tie): counted, compared by value
                    zero = (m == 0) & (wm == 0)
                    zero_signs += int((zero & (m.view(torch.int32) != wm.view(torch.int32))).sum())
                    check.equal("cascade_group", f"{what} margin bits",
                                torch.where(zero, 0, m.view(torch.int32)),
                                torch.where(zero, 0, wm.view(torch.int32)))
                    if kind == "nan" and not bool((p[2] == -1).all() and (p[5] == -1).all()):
                        raise AssertionError(f"B8 {what}: a NaN group picked a lane")
                    picked += int((p >= 0).sum())
                    n_cases += 1
    log(f"[phase 3] B8 cascade_group with rows == plain + group_topk_rows ({n_cases} cases, "
        f"{picked} picks, {zero_signs} zero margins of another sign)")


def check_group_stages(check: Check, dev, cascade_group_kernel, G: int = 256,
                       S: int = 8) -> None:
    """Phase 3: B8 as the grouped streaming step launches it: each slot at
    its own stage, so each group's threshold is ``eps_g[stage]``, gathered
    on the card from S stage values (drawn, 0 and +inf), differing within
    the launch; ``n_live`` a device scalar (0, 100, G); with ``rows``.
    Picks, exits and margins' bits equal the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_group_plain, group_topk_rows

    rng = np.random.default_rng(29)
    n_cases, exits, eps_values = 0, 0, 0
    for B in (4, 32, 64):
        for k in (1, 10):
            for kind in ("ties", "nan"):
                gg, valid, rows_g = group_case(rng, G, B, kind)
                eps_g = np.sort(rng.uniform(0.0, 2.0, size=S)).astype(np.float32)
                eps_g[0], eps_g[-1] = 0.0, np.inf
                stage = torch.from_numpy(rng.integers(0, S, size=G).astype(np.int32)).to(dev)
                eps = torch.from_numpy(eps_g).to(dev)[stage]
                eps_values = max(eps_values, int(torch.unique(eps).numel()))
                g_t, v_t, r_t = (torch.from_numpy(a).to(dev) for a in (gg, valid, rows_g))
                for nl in (0, 100, G):
                    n_live = torch.tensor(nl, dtype=torch.int32, device=dev)
                    m, e, p = cascade_group_kernel(g_t, v_t, eps, k, n_live=n_live, rows=r_t)
                    torch.cuda.synchronize()
                    wm, we = cascade_group_plain(g_t, v_t, eps, k, n_live=n_live)
                    wp = group_topk_rows(g_t, v_t, r_t, k)
                    what = f"per-slot eps B={B} k={k} {kind} n_live {nl}"
                    check.equal("cascade_group", f"{what} picks", p, wp)
                    check.equal("cascade_group", f"{what} exit", e, we)
                    check.equal("cascade_group", f"{what} margin bits",
                                m.view(torch.int32), wm.view(torch.int32))
                    exits += int(e.sum())
                    n_cases += 1
    if not exits or eps_values < S:
        raise AssertionError(f"B8 per-slot eps: {exits} exits, {eps_values} thresholds a launch")
    log(f"[phase 3] B8 cascade_group at per-slot stage thresholds (S = {S} values, +inf "
        f"among them, in each launch; n_live a device scalar) == plain ({n_cases} cases, "
        f"{exits} exits)")


def phase_kernels(check: Check) -> dict:
    """Phase 3: every kernel against its plain version on the card.
    Returns the main-path-shaped inputs phase 5 times."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import (
        cascade_chunk_kernel,
        cascade_chunk_plain,
        cascade_chunk_step,
        cascade_group_kernel,
        cascade_group_plain,
        cascade_kernel,
        cascade_lane_kernel,
        cascade_lane_plain,
        cascade_lane_step,
        cascade_plain,
    )
    from repro_torch.kernels.device_executor import (
        DevicePlan,
        lattice_stage_scorer,
        matrix_stage_scorer,
        tree_stage_scorer,
    )
    from repro_torch.kernels import lattice_kernel
    from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
    from repro_torch.kernels.megakernel import (
        build_tree_slabs,
        mega_lane_kernel,
        mega_lane_plain,
        mega_stage_kernel,
        mega_stage_plain,
    )
    from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain

    def synced(kernel):
        """``kernel`` followed by a device sync: a fault it makes is raised
        at its own call, not at the plain version's or a later kernel's."""

        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            torch.cuda.synchronize()
            return out

        return call

    cascade_chunk_kernel = synced(cascade_chunk_kernel)
    cascade_chunk_step = synced(cascade_chunk_step)
    cascade_group_kernel = synced(cascade_group_kernel)
    cascade_kernel = synced(cascade_kernel)
    cascade_lane_kernel = synced(cascade_lane_kernel)
    cascade_lane_step = synced(cascade_lane_step)
    gbt_scores_kernel = synced(gbt_scores_kernel)
    lattice_scores_kernel = synced(lattice_scores_kernel)
    mega_lane_kernel = synced(mega_lane_kernel)
    mega_stage_kernel = synced(mega_stage_kernel)

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

    # B3 at every tile shape (tk 1, 7, 8: one tile of tk trees; 33: 17 + 16;
    # 500: 16 tiles) and depth (B3_DEPTHS), rows clamped at both ends, n = 0
    # and n not a multiple of block_n; then one tree at the limit
    # (their own generator, so the later checks' inputs stay as they were)
    rng_b = np.random.default_rng(21)
    x_rows = torch.from_numpy(rng_b.integers(-3, 260, size=257)).to(dev)
    x_rows[:2] = torch.tensor([-3, 259])
    n_cases = 0
    for depth in B3_DEPTHS:
        Tg = 503
        fg = torch.from_numpy(rng_b.integers(0, d, size=(Tg, depth)).astype(np.int32)).to(dev)
        tg = torch.from_numpy(rng_b.uniform(size=(Tg, depth)).astype(np.float32)).to(dev)
        lg = torch.from_numpy(rng_b.normal(size=(Tg, 1 << depth)).astype(np.float32)).to(dev)
        for tk in B3_WIDTHS:
            for label, kw in [
                ("all rows", dict()),
                ("clamped rows, nv=130", dict(rows=x_rows, n_valid=nv(130))),
                ("ragged n=100, host nv", dict(rows=x_rows[:100], n_valid=100)),
                ("n=0", dict(rows=x_rows[:0])),
            ]:
                check.equal(
                    "gbt_scores", f"depth {depth} tk {tk} {label}",
                    gbt_scores_kernel(fg, tg, lg, x_buf, block_n=64, t0=3, t1=3 + tk, **kw),
                    gbt_scores_plain(fg, tg, lg, x_buf, block_n=64, t0=3, t1=3 + tk, **kw),
                )
                n_cases += 1
        del fg, tg, lg
    depth = MAX_TREE_DEPTH_B3
    fg = torch.from_numpy(rng_b.integers(0, d, size=(1, depth)).astype(np.int32)).to(dev)
    tg = torch.from_numpy(rng_b.uniform(size=(1, depth)).astype(np.float32)).to(dev)
    lg = torch.arange(1 << depth, dtype=torch.float32, device=dev)[None]  # 4 GiB, in place
    check.equal(
        "gbt_scores", f"depth {depth}",
        gbt_scores_kernel(fg, tg, lg, x_buf, rows=x_rows, n_valid=nv(200), block_n=64),
        gbt_scores_plain(fg, tg, lg, x_buf, rows=x_rows, n_valid=nv(200), block_n=64),
    )
    del fg, tg, lg
    log(f"[phase 3] B3 gbt_scores at depths {B3_DEPTHS} x tk {B3_WIDTHS} == plain "
        f"({n_cases} cases), and at depth {depth}")

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
                want = mega_stage_plain(*args, block_n=64)
                # the matrix variant also reads the operand in place (rows=)
                forms = [(args, {})] + ([((scorer.slabs, xop) + args[2:], dict(rows=rows))]
                                        if variant == "matrix" else [])
                for a_, kw in forms:
                    got = mega_stage_kernel(*a_, block_n=64, **kw)
                    for k, (a, b) in enumerate(zip(got, want)):
                        check.equal(f"mega_stage_{variant}", f"stage {stage} {sorted(kw)} "
                                    f"output {k}", a, b)
                    n_cases += 1
    log(f"[phase 3] B4 mega_stage tree + matrix (gathered, rows=) == plain ({n_cases} cases)")

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

    # B5 on both sides of its regime switch at every S: at the last row
    # count whose team threads fit one wave of the card (team form) and one
    # row more (one thread a pair), rows clamped at both ends, n_valid
    # partial; the sort key and a stage slab (team form)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_cases, regimes = 0, collections.Counter()
    for S in range(1, 9):
        th = torch.from_numpy(rng_b.normal(size=(T, 1 << S)).astype(np.float32)).to(dev)
        lf = torch.from_numpy(np.stack([rng_b.choice(D, S, replace=False) for _ in range(T)])
                              .astype(np.int32)).to(dev)
        n_sw = sms * lattice_kernel.TEAM_THREADS_PER_SM // (8 * min(32, 1 << S))
        for n in (n_sw, n_sw + 1, 256):
            lrows = torch.from_numpy(rng_b.integers(-3, 8003, size=n)).to(dev)
            for label, kw in [
                ("slab", dict(t0=9, t1=17, rows=lrows, n_valid=nv(n - 77))),
                ("sort key", dict(t0=0, t1=1, rows=lrows, n_valid=n)),
            ]:
                reg = lattice_kernel.lattice_regime(n, kw["t1"] - kw["t0"], S, sms)
                regimes["team" if reg.team else "thread"] += 1
                check.equal(
                    "lattice_scores", f"S={S} n={n} {label} ({'team' if reg.team else 'thread'})",
                    lattice_scores_kernel(th, lf, xl_cal, block_n=64, **kw),
                    lattice_scores_plain(th, lf, xl_cal, block_n=64, **kw),
                )
                n_cases += 1
    if set(regimes) != {"team", "thread"}:
        raise AssertionError(f"B5 regime cases: {dict(regimes)}")
    log(f"[phase 3] B5 lattice_scores at S 1-8 on both sides of the regime switch == plain "
        f"({n_cases} cases: {dict(regimes)})")

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
    # B1 at the edges of its tiles and warps: (1, 1), (33, 7), T odd (rows
    # not 16-byte aligned: 4-byte copies), 4096 rows on a tile multiple
    # (tensor-map tiles) and past one, each at drawn and at ±inf thresholds
    # (their own generator, so the checks after them draw what they drew
    # before)
    rng_b = np.random.default_rng(13)
    n_b1 = 3
    for (nb, Tb, ct, bn) in [(1, 1, 8, 256), (33, 7, 8, 64), (2000, 501, 8, 256),
                             (77, 37, 3, 32), (4096, 512, 8, 256), (4096, 513, 8, 256)]:
        Fe = torch.from_numpy(rng_b.normal(scale=0.3, size=(nb, Tb)).astype(np.float32)).to(dev)
        pe = torch.from_numpy(rng_b.uniform(0.5, 3.0, size=Tb).astype(np.float32)).to(dev)
        ne = -torch.from_numpy(rng_b.uniform(0.5, 3.0, size=Tb).astype(np.float32)).to(dev)
        infe = torch.full((Tb,), float("inf"), device=dev)
        for label, (p_, n_) in [("drawn", (pe, ne)), ("±inf", (infe, -infe))]:
            got = cascade_kernel(Fe, p_, n_, 0.05, block_n=bn, chunk_t=ct)
            want = cascade_plain(Fe, p_, n_, 0.05, chunk_t=ct)
            for k, (a, b) in enumerate(zip(got, want)):
                check.equal("cascade", f"({nb}, {Tb}) {label} output {k}", a, b)
            n_b1 += 1
    log(f"[phase 3] B1 cascade == plain ({n_b1} cases)")

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
    check_lane_step(check, dev, eps_pos, eps_neg, col_valid, cascade_lane_step)
    check_chunk_step(check, dev, eps_pos, eps_neg, col_valid, cascade_chunk_step)

    # B7 at cap 256, W 8, block 64: lanes over all S stages in block 0,
    # last-stage (stop) lanes, rows retiring mid-block, trash rows past
    # n_valid, the ragged last stage; tree and matrix on exp1's geometry,
    # lattice on exp4's
    stop = stage >= S - 1
    stage_l = stage
    last_st = torch.full_like(stage, S - 1)  # every lane at the ragged last stage
    last_stop = torch.arange(256, device=dev) % 2 == 0
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

    # B4 and B7 at quantised slabs: the same plans, ensembles (raw normal
    # leaves and vertex values, off every grid) and buffers as above
    quant = {}
    for q in QUANTS:
        quant[("tree", q)] = tree_stage_scorer(dplan, fo, to, lo, block_n=64, quant=q, device=dev)
        quant[("lattice", q)] = lattice_stage_scorer(
            lplan, theta8.cpu().numpy(), lfeats8.cpu().numpy(), block_n=64, quant=q, device=dev
        )
    quant[("matrix", "bf16")] = matrix_stage_scorer(dplan, quant="bf16", device=dev)
    F_bf16 = F.to(torch.bfloat16)
    operands = {"tree": (x_buf, (eps_pos, eps_neg)), "matrix": (F_bf16, (eps_pos, eps_neg)),
                "lattice": (xl_buf, leps)}
    n_cases, mid_block, off_grid = 0, 0, 0
    for (variant, q), scorer in quant.items():
        name, slabs = f"{variant}_{q}", scorer.slabs
        payload = slabs.data.get("payload")
        if payload is not None:  # the payload really is off the grid
            off_grid += int(slabs.eps_position.max() > 0)
        xop, (ep_t, en_t) = operands[variant]
        xr_q = xop[rows].contiguous()
        plan_q = lplan if variant == "lattice" else dplan
        for stage in (0, 5, 63):
            for n_valid in (nv(256), nv(0), nv(100), nv(200)):
                args = (slabs, xr_q, g_buf, stage, int(plan_q.stage_t0[stage]), n_valid, ep_t, en_t)
                want = mega_stage_plain(*args, block_n=64)
                forms = [(args, {})] + ([((slabs, xop) + args[2:], dict(rows=rows))]
                                        if variant == "matrix" else [])
                for a_, kw in forms:
                    got = mega_stage_kernel(*a_, block_n=64, **kw)
                    for k, (a, b) in enumerate(zip(got, want)):
                        check.equal(f"mega_stage_{name}", f"stage {stage} {sorted(kw)} "
                                    f"output {k}", a, b)
                    n_cases += 1
        for n_valid in (nv(256), nv(0), nv(100), nv(200), 64):
            args = (slabs, xop, rows, g_buf, stage_l, stop, n_valid, ep_t, en_t)
            got = mega_lane_kernel(*args, block_n=64)
            want = mega_lane_plain(*args, block_n=64)
            for k, (a, b) in enumerate(zip(got, want)):
                check.equal(f"mega_lane_{name}", f"nv {int(n_valid)} output {k}", a, b)
            live = got[3][: int(n_valid)]
            mid_block += int(bool((live > 0).any() and (live == 0).any()))
            n_cases += 1
        if not bool(((got[1] == 1) & stop[:256]).any()):
            raise AssertionError(f"B7 {name} check: no last-stage lane ran out active")
    if off_grid != 4 or mid_block < 10:
        raise AssertionError(f"quantised checks: {off_grid} payloads off the grid, "
                             f"{mid_block} cases retiring rows mid-block")
    log(f"[phase 3] B4 + B7 at bf16/int8 (tree, lattice; matrix bf16) == plain "
        f"({n_cases} cases, {mid_block} B7 cases retiring rows mid-block)")

    # B4 and B7 lattice at every team shape of the warp-cooperative
    # interpolation (S < 5: sub-warp teams; 5: one warp; 6 and 8: values
    # held in registers), every storage, blocks of 64 and of 50 rows, B7's
    # lanes over all 64 stages or all at the ragged last one (its own
    # generator: the checks after it draw what they drew before)
    geo_rng = np.random.default_rng(18)
    n_cases, mid_block = 0, 0
    for dims in LATTICE_DIMS:
        th = geo_rng.normal(size=(T, 1 << dims)).astype(np.float32)
        lf = np.stack([geo_rng.choice(D, dims, replace=False) for _ in range(T)]).astype(np.int32)
        for q in ("f32",) + QUANTS:
            slabs = lattice_stage_scorer(lplan, th, lf, block_n=64, quant=q, device=dev).slabs
            name = "lattice" if q == "f32" else f"lattice_{q}"
            for bn in (64, 50):
                for n_valid in (nv(0), nv(151), nv(256)):
                    for st in (0, 5, 63):
                        args = (slabs, xr, g_buf, st, int(lplan.stage_t0[st]), n_valid, *leps)
                        got = mega_stage_kernel(*args, block_n=bn)
                        want = mega_stage_plain(*args, block_n=bn)
                        for k, (a, b) in enumerate(zip(got, want)):
                            check.equal(f"mega_stage_{name}", f"S={dims} bn={bn} stage {st} "
                                        f"output {k}", a, b)
                        n_cases += 1
                    for layout, st_l, stop_l in (("all stages", stage_l, stop),
                                                 ("one stage", last_st, last_stop)):
                        args = (slabs, xl_buf, rows, g_buf, st_l, stop_l, n_valid, *leps)
                        got = mega_lane_kernel(*args, block_n=bn)
                        want = mega_lane_plain(*args, block_n=bn)
                        for k, (a, b) in enumerate(zip(got, want)):
                            check.equal(f"mega_lane_{name}", f"S={dims} bn={bn} {layout} "
                                        f"output {k}", a, b)
                        live = got[3][: int(n_valid)]
                        mid_block += int(bool((live > 0).any() and (live == 0).any()))
                        n_cases += 1
    if mid_block < len(LATTICE_DIMS) * 3 * 2:
        raise AssertionError(f"lattice geometry checks: only {mid_block} B7 cases retired "
                             "rows mid-block")
    log(f"[phase 3] B4 + B7 lattice at S {LATTICE_DIMS}, f32/bf16/int8, blocks 64 and 50 "
        f"== plain ({n_cases} cases, {mid_block} B7 cases retiring rows mid-block)")

    # B4 and B7 tree at every depth of TREE_DEPTHS (the scorer's group of
    # 10 levels, a predicated remainder, a second group), every storage,
    # blocks of 64 and of 50 rows, B7's lanes over all 64 stages or all at
    # the ragged last one, on exp1's features and exp4's thresholds (leaves
    # small enough that stop lanes run out active, large enough that rows
    # retire mid-block); its own generator, as above
    tree_rng = np.random.default_rng(19)
    xr_tree = x_buf[rows].contiguous()
    n_cases, mid_block, ran_out = 0, 0, set()
    for depth in TREE_DEPTHS:
        tf = tree_rng.integers(0, d, size=(T, depth)).astype(np.int32)
        tt = tree_rng.uniform(size=(T, depth)).astype(np.float32)
        tl = tree_rng.normal(scale=0.3, size=(T, 1 << depth)).astype(np.float32)
        for q in ("f32",) + QUANTS:
            slabs = build_tree_slabs(lplan, tf, tt, tl, quant=q, device=dev)
            name = "tree" if q == "f32" else f"tree_{q}"
            for bn in (64, 50):
                for n_valid in (nv(0), nv(151), nv(256)):
                    for st in (0, 5, 63):
                        args = (slabs, xr_tree, g_buf, st, int(lplan.stage_t0[st]), n_valid, *leps)
                        got = mega_stage_kernel(*args, block_n=bn)
                        want = mega_stage_plain(*args, block_n=bn)
                        for k, (a, b) in enumerate(zip(got, want)):
                            check.equal(f"mega_stage_{name}", f"depth {depth} bn={bn} stage {st} "
                                        f"output {k}", a, b)
                        n_cases += 1
                    for layout, st_l, stop_l in (("all stages", stage_l, stop),
                                                 ("one stage", last_st, last_stop)):
                        args = (slabs, x_buf, rows, g_buf, st_l, stop_l, n_valid, *leps)
                        got = mega_lane_kernel(*args, block_n=bn)
                        want = mega_lane_plain(*args, block_n=bn)
                        for k, (a, b) in enumerate(zip(got, want)):
                            check.equal(f"mega_lane_{name}", f"depth {depth} bn={bn} {layout} "
                                        f"output {k}", a, b)
                        live = got[3][: int(n_valid)]
                        mid_block += int(bool((live > 0).any() and (live == 0).any()))
                        if bool(((got[1] == 1) & stop_l).any()):
                            ran_out.add(depth)
                        n_cases += 1
    if mid_block < len(TREE_DEPTHS) * 3 * 2 or ran_out != set(TREE_DEPTHS):
        raise AssertionError(f"tree depth checks: {mid_block} B7 cases retired rows mid-block, "
                             f"a stop lane ran out active at depths {sorted(ran_out)} only")
    log(f"[phase 3] B4 + B7 tree at depth {TREE_DEPTHS}, f32/bf16/int8, blocks 64 and 50 "
        f"== plain ({n_cases} cases, {mid_block} B7 cases retiring rows mid-block, a stop "
        "lane running out active at every depth)")

    # B4 and B7 matrix (one step kernel) at W 1, 8 and 13 (T 61 after a
    # lead model: stage starts 1 + W k, misaligned; a ragged last stage),
    # f32 and bf16, blocks of 64 and 50 rows: B4 gathered and through rows=
    # (the trash row id, ids past the operand), B7's lanes over every stage
    # or all at the ragged last one, stop lanes; its own generator, as above
    mat_rng = np.random.default_rng(20)
    n_cases, mid_block = 0, 0
    for W_m in (1, 8, 13):
        mplan = random_plan(mat_rng, 61, W_m, 1, lo=0.3, hi=1.5)
        for q in ("f32", "bf16"):
            mdp = DevicePlan.from_plan(mplan, quant=q)
            msc = matrix_stage_scorer(mdp, device=dev)
            Fm = msc.prepare(mat_rng.normal(scale=0.4, size=(300, 61)).astype(np.float32))
            Fm = Fm.to(msc.slabs.x_dtype or torch.float32)
            mrows = torch.from_numpy(mat_rng.permutation(300)[:256]).to(dev)
            mrows[-9:] = 256
            mrows[-2:] = torch.tensor([300, 10**6])
            Fg = Fm[torch.clamp(mrows, 0, 299)].contiguous()
            meps = (torch.from_numpy(mdp.eps_pos).to(dev), torch.from_numpy(mdp.eps_neg).to(dev))
            S_m = mdp.S
            spread = torch.from_numpy(mat_rng.integers(0, S_m, size=256).astype(np.int32)).to(dev)
            spread[:S_m] = torch.arange(S_m, dtype=torch.int32, device=dev)
            last = torch.full_like(spread, S_m - 1)
            name = "matrix" if q == "f32" else f"matrix_{q}"
            for bn in (64, 50):
                for n_valid in (nv(0), nv(151), nv(256)):
                    for st in (0, S_m // 2, S_m - 1):
                        t0 = int(mdp.stage_t0[st])
                        want = mega_stage_plain(msc.slabs, Fg, g_buf, st, t0, n_valid, *meps,
                                                block_n=bn)
                        for xs, kw in ((Fg, {}), (Fm, dict(rows=mrows))):
                            got = mega_stage_kernel(msc.slabs, xs, g_buf, st, t0, n_valid,
                                                    *meps, block_n=bn, **kw)
                            for k, (a, b) in enumerate(zip(got, want)):
                                check.equal(f"mega_stage_{name}", f"W={W_m} bn={bn} stage {st} "
                                            f"{sorted(kw)} output {k}", a, b)
                            n_cases += 1
                    for layout, st_l, stop_l in (("all stages", spread, spread >= S_m - 1),
                                                 ("one stage", last, last_stop)):
                        args = (msc.slabs, Fm, mrows, g_buf, st_l, stop_l, n_valid, *meps)
                        got = mega_lane_kernel(*args, block_n=bn)
                        want = mega_lane_plain(*args, block_n=bn)
                        for k, (a, b) in enumerate(zip(got, want)):
                            check.equal(f"mega_lane_{name}", f"W={W_m} bn={bn} {layout} "
                                        f"output {k}", a, b)
                        live = got[3][: int(n_valid)]
                        mid_block += int(bool((live > 0).any() and (live == 0).any()))
                        n_cases += 1
    if mid_block < 3 * 2 * 2:
        raise AssertionError(f"matrix checks: only {mid_block} B7 cases retired rows mid-block")
    log(f"[phase 3] B4 (gathered, rows=) + B7 matrix at W (1, 8, 13), f32/bf16, blocks 64 and "
        f"50 == plain ({n_cases} cases, {mid_block} B7 cases retiring rows mid-block)")

    # B8 over (G 37, B) bucket layouts: integer scores (ties), groups of at
    # most k documents, eps +inf and 0 beside drawn thresholds, n_live 0,
    # below G and all (a device scalar and a host int)
    G = 37
    n_cases, exits = 0, 0
    for B in (4, 64, 256):
        for k in (1, 10):
            gg = rng.integers(-3, 4, size=(G, B)).astype(np.float32)
            gg[1::2] += rng.normal(scale=0.3, size=(G, B))[1::2].astype(np.float32)
            sizes = rng.integers(1, B + 1, size=G)
            sizes[:3] = [1, min(k, B), min(k + 1, B)]
            valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
            eps = rng.uniform(0.0, 2.0, size=G).astype(np.float32)
            eps[3], eps[4] = np.inf, 0.0
            args = [torch.from_numpy(a).to(dev) for a in (gg, valid, eps)] + [k]
            for n_live in (None, nv(0), nv(20), 29):
                got = cascade_group_kernel(*args, n_live=n_live)
                want = cascade_group_plain(*args, n_live=n_live)
                for j, (a, b) in enumerate(zip(got, want)):
                    check.equal("cascade_group", f"B={B} k={k} output {j}", a, b)
                exits += int(got[1].sum())
                n_cases += 1
    if not exits:
        raise AssertionError("B8 check: no group exited")
    log(f"[phase 3] B8 cascade_group == plain ({n_cases} cases, {exits} exits)")
    check_group_rows(check, dev, cascade_group_kernel)
    check_group_stages(check, dev, cascade_group_kernel)
    torch.cuda.synchronize()
    return dict(
        chunk=(g0, chunk, ep, en), forest=(feats, thrs, leaves), x_cal=x_cal,
        x_buf=x_buf, rows=rows, dplan=dplan, tree=tree, matrix=matrix, F=F,
        eps=(eps_pos, eps_neg), g_buf=g_buf, lat=(theta8, lfeats8), xl_cal=xl_cal,
        xl_buf=xl_buf, lplan=lplan, lattice=lattice, leps=leps,
        lanes=dict(stage=stage_l, stop=stop, scores=lane_scores, eps=(lep, len_), raw=chunk,
                   col_valid=col_valid),
        quant=quant, F_bf16=F_bf16,
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

    from repro_torch.api.pipeline import FittedCascade
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

    out, per_flush, batch_g, results = {}, {}, {}, {}

    def served(path, srv, twin):
        """``srv`` over the test rows, counted as ``path``, then held
        against ``twin`` (the same server with capture=False)."""
        res = counted(launches, path, lambda: serve(srv, ds.x_test))
        n = srv.stats.n_batches
        per_flush[path] = {k: v / n for k, v in launches[path].items()}
        log(f"[phase 4] launches {path}: {launches[path]} over {n} flushes")
        if twin is not None:
            eager_twin(launches, path, srv, res, twin, lambda s: serve(s, ds.x_test))
            log(f"[phase 4] {path}: one CUDA graph over {n} flushes == capture=False "
                f"(results, g_final bits, billing, launches)")
        return res

    def eager_opts(opts=None):
        return {**(opts or {}), "capture": False}

    for mode in GBT_MODES:
        t = time.perf_counter()
        card = server(mode, "cuda")
        res_card = served(f"fused/{mode}", card, server(mode, "cuda", backend_opts=eager_opts()))
        wall = time.perf_counter() - t
        cpu = server(mode, "cpu")
        res_cpu = served(f"cpu/{mode}", cpu, None)
        if res_card != res_cpu:  # verdicts, models evaluated, full scores
            raise AssertionError(f"{mode}: card results != CPU (plain) results")
        results[mode] = res_card
        off = server(mode, "cuda", backend_opts={"megakernel": False})
        res_off = served(f"unfused/{mode}", off, server(
            mode, "cuda", backend_opts=eager_opts({"megakernel": False})))
        if res_off != res_card:
            raise AssertionError(f"{mode}: megakernel off != on")
        # the unfused stage is B2's step form once a stage, never its
        # reference form
        n_stages = off._dev[0].dplan.S
        if per_flush[f"unfused/{mode}"].get("cascade_chunk_step") != n_stages:
            raise AssertionError(f"unfused/{mode}: {per_flush[f'unfused/{mode}']} a flush, "
                                 f"expected cascade_chunk_step {n_stages}")
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

    # the host rung with the kernel decide: B2's reference form, once a
    # stage that runs, over the test score matrix
    hosted = FittedCascade(model=fits["both"]).compile("host", decide="kernel", device="cuda")
    res_host = counted(launches, "host_kernel/both", lambda: hosted.evaluate(scores=F_test))
    ev = evaluate_cascade(fits["both"], F_test)
    if not (np.array_equal(res_host.decisions, ev["decisions"])
            and np.array_equal(res_host.exit_step, ev["exit_step"])):
        raise AssertionError("host rung, kernel decide: verdicts != evaluate_cascade")
    if launches["host_kernel/both"]["cascade_chunk"] != len(res_host.chunk_stats):
        raise AssertionError(f"host rung: {launches['host_kernel/both']} launches for "
                             f"{len(res_host.chunk_stats)} stages")
    log(f"[phase 4] host rung, kernel decide (B2): == evaluate_cascade over "
        f"{len(res_host.chunk_stats)} stages; launches {launches['host_kernel/both']}")

    # the eager path: the score matrix per flush through the matrix variant
    eager = server("both", "cuda", scorer=None, score_fn=score_fn)
    res_eager = served("eager/both", eager, server(
        "both", "cuda", scorer=None, score_fn=score_fn, backend_opts=eager_opts()))
    n_stages = 1 + math.ceil((500 - 1) / 8)  # a lead model, then chunks of 8
    if per_flush["eager/both"] != {"gbt_scores": 1.0, "mega_stage_matrix": float(n_stages)}:
        raise AssertionError(f"eager: launched {per_flush['eager/both']} a flush, expected one "
                             f"B3 and {n_stages} B4 matrix")
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
                F_train=F_train, F_test=F_test, batch_g=batch_g, beta=beta, results=results)


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
        if device == "cuda":
            eager_twin(launches, key, srv, res[path],
                       server(device, backend_opts={**opts, "capture": False}),
                       lambda s: serve(s, ds.x_test))
        nb, n_stages = srv.stats.n_batches, srv._dev[0].dplan.S
        per_flush[key] = {k: v / nb for k, v in launches[key].items()}
        want = {
            "lattice_fused": {"lattice_scores": nb, "mega_stage_lattice": nb * n_stages},
            "lattice_unfused": {"lattice_scores": nb * (1 + n_stages),
                                "cascade_chunk_step": nb * n_stages},
            "lattice_cpu": {},
        }[path]
        if launches[key] != want:
            raise AssertionError(f"{key}: launched {launches[key]}, expected {want}")
        log(f"[phase 4b] serve {key}: {nb} flushes of {n_stages} stages in "
            f"{time.perf_counter() - t:.1f}s; launches {launches[key]}"
            + ("; one CUDA graph == capture=False" if device == "cuda" else ""))
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
                if device == "cuda":
                    eager_twin(launches, key, srv, res[path],
                               server(cell, device, {**opts, "capture": False}, eager),
                               lambda s: stream_serve(s, x, arrivals))
                log(f"[phase 4c] {key}: {len(waves)} waves, {srv.stats.stream_steps} steps run, "
                    f"{enq} enqueued, {sum(w.syncs for w in waves)} syncs in "
                    f"{time.perf_counter() - t:.1f}s; launches {launches[key]}"
                    + ("; one CUDA graph == capture=False" if device == "cuda" else ""))
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


def submit_queries(server, x, offsets) -> list[dict]:
    for i in range(offsets.size - 1):
        server.submit(x[offsets[i] : offsets[i + 1]])
    return server.drain()


def rank_twin(srv):
    """The ranking server ``srv`` (batch or streaming) again, with its
    executor's eager loop on the card (``capture=False``)."""
    from repro_torch.kernels.device_executor import DeviceExecutor
    from repro_torch.ranking import GroupedRankServer

    ex = srv.executor
    eager = DeviceExecutor(ex.dplan, ex.scorer, block_n=ex.block_n, megakernel=ex.megakernel,
                           device=ex.device, capture=False)
    return GroupedRankServer(srv.gplan, srv.score_fn, executor=eager,
                             batch_groups=srv.batch_groups, capacity_groups=srv.capacity_groups,
                             capacity_docs=srv.capacity_docs, buckets=srv.buckets,
                             streaming=srv.streaming, policy=srv.policy)


def fresh_queries(x, n_drains: int, seed: int) -> list:
    """``n_drains`` sets of ``RANK_FRESH`` never-seen queries over the rows
    ``x``, as ``(rows, offsets)``: drain i cuts ``x`` into ragged queries
    (Poisson mean ``RANK_GROUP_MEAN``, seed ``seed + i``) and takes
    ``RANK_FRESH`` consecutive ones at a seeded start."""
    import numpy as np

    from repro_torch.launch.serve import _ragged_sizes
    from repro_torch.ranking import group_offsets

    out = []
    for i in range(n_drains):
        rng = np.random.default_rng(seed + i)
        offs = group_offsets(_ragged_sizes(len(x), RANK_GROUP_MEAN, rng))
        j = int(rng.integers(0, offs.size - 1 - RANK_FRESH))
        out.append((x[offs[j] : offs[j + RANK_FRESH]], offs[j : j + RANK_FRESH + 1] - offs[j]))
    return out


def phase_ranking(report: dict, launches: dict, main: dict) -> dict:
    """Phase 4d: query-level ranking exit on exp1_adult's GBT (no new
    ensemble, no new greedy search: phase 4's B3 calibration matrix and its
    ``both`` fit's order).  The train and test rows are cut into ragged
    query groups (Poisson mean ``RANK_GROUP_MEAN``, seed 2031, as the CLI
    cuts them); ``api.fit(groups=, topk=10)`` calibrates the group margin
    thresholds; the test queries are served through
    ``compile(...).serve(score_fn=B3, batch_size=256)`` on the card (B3 +
    B8), with device="cpu", on the host rung, and replayed by
    ``run_grouped_host``: all four equal bit for bit, and the margin-inf
    run's verdicts equal ``full_cascade_topk``."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import GROUPS_SEED, _ragged_sizes
    from repro_torch.ranking import (
        bucket_layout,
        full_cascade_topk,
        group_offsets,
        ndcg_at_k,
        pack_by_bucket,
        run_grouped_host,
    )

    ds, gbt, beta = main["ds"], main["gbt"], main["beta"]
    F_train, F_test = main["F_train"], main["F_test"]
    rng = np.random.default_rng(GROUPS_SEED)
    sizes_tr = _ragged_sizes(len(ds.y_train), RANK_GROUP_MEAN, rng)
    sizes_te = _ragged_sizes(len(ds.y_test), RANK_GROUP_MEAN, rng)
    off = group_offsets(sizes_te)
    t = time.perf_counter()
    fitted = api.fit(
        F_train, groups=sizes_tr, topk=RANK_K, alpha=RANK_ALPHA, beta=beta, mode="both",
        chunk_t=8, order=main["fits"]["both"].order, optimize_order=False,
    )
    fit_s = time.perf_counter() - t
    gp = fitted.grouped
    log(f"[phase 4d] grouped fit ({sizes_tr.size} train queries, mean "
        f"{sizes_tr.mean():.1f} docs; k={gp.k}, alpha={RANK_ALPHA}, phase 4's order) in "
        f"{fit_s:.1f}s: S={gp.S}, buckets {gp.buckets}, train disagreement "
        f"{gp.train_disagreement:.4f}")

    params = {d: tuple(a.to(d) for a in (gbt.feats, gbt.thrs, gbt.leaves)) for d in ("cuda", "cpu")}
    calls = {"n": 0}

    def score_fn(x):  # B3 on the card (the plain version on a CPU tensor)
        calls["n"] += 1
        return ops.gbt_scores(*params[x.device.type], x)

    def server(backend, device, capture=True):
        srv = fitted.compile(backend, device=device).serve(
            score_fn=score_fn, batch_size=RANK_BATCH, capacity_docs=RANK_DOCS
        )
        return srv if capture else rank_twin(srv)

    card = server("device", "cuda")
    res_card = counted(launches, "rank/both", lambda: submit_queries(card, ds.x_test, off))
    st = card.stats
    want = {"gbt_scores": calls["n"], "cascade_group": st.n_waves * (gp.S + 1)}
    if launches["rank/both"] != want:
        raise AssertionError(f"rank/both: launched {launches['rank/both']}, expected {want}")
    # the first drain runs each bucket wave's program (one a bucket shape:
    # the operand is pinned to RANK_DOCS rows) eagerly, as capture=False does
    twin = server("device", "cuda", capture=False)
    res_twin = counted(launches, "rank/both/eager", lambda: submit_queries(twin, ds.x_test, off))
    ex, tw = card.executor, twin.executor
    if res_twin != res_card or launches["rank/both/eager"] != launches["rank/both"]:
        raise AssertionError("ranking: captured results or launches != capture=False")
    if not (ex.traces == tw.traces == st.n_waves and not ex._graphs and not tw._graphs):
        raise AssertionError(f"ranking: traces {ex.traces} / {tw.traces}, graphs "
                             f"{len(ex._graphs)}, waves {st.n_waves}")
    log(f"[phase 4d] ranking: {ex.traces} programs (one a bucket wave), run eagerly at their "
        f"first drain == capture=False")
    res_cpu = submit_queries(server("device", "cpu"), ds.x_test, off)
    res_host = submit_queries(server("host", "cuda"), ds.x_test, off)
    oracle = run_grouped_host(gp, F_test, sizes_te)

    def fields(res, offsets=off):
        verd = np.full((len(res), gp.k), -1, dtype=np.int64)
        for i, r in enumerate(res):
            verd[i, : len(r["ranking"])] = np.asarray(r["ranking"]) + offsets[i]
        ex = np.array([r["exit_stage"] for r in res])
        m = np.array([r["margin"] for r in res], dtype=np.float32)
        return verd, ex, m.view(np.int32)

    ref = (oracle.verdicts.astype(np.int64), oracle.exit_stage, oracle.margin.view(np.int32))
    for name, res in (("card", res_card), ("cpu", res_cpu), ("host rung", res_host)):
        if len(res) != sizes_te.size or not all(
            np.array_equal(a, b) for a, b in zip(fields(res), ref)
        ):
            raise AssertionError(f"ranking: {name} verdicts/exit stages/margins != run_grouped_host")
    compiled = fitted.compile("device", device="cuda")
    inf = counted(launches, "rank_inf/both",
                  lambda: compiled.rank(scores=F_test, groups=sizes_te, margin_inf=True))
    full = full_cascade_topk(F_test, sizes_te, gp.k, order=gp.plan.order)
    if not np.array_equal(fields(inf)[0], full.astype(np.int64)):
        raise AssertionError("ranking: margin-inf verdicts != full_cascade_topk")
    if not all(r["exit_stage"] == gp.S for r in inf):
        raise AssertionError("ranking: a margin-inf query exited early")
    ndcg = ndcg_at_k(ds.y_test, fields(res_card)[0], sizes_te, gp.k)
    ndcg_full = ndcg_at_k(ds.y_test, full, sizes_te, gp.k)
    report["ranking"] = dict(
        config="exp1_adult ranking", k=gp.k, alpha=RANK_ALPHA, S=gp.S, buckets=gp.buckets,
        queries=int(sizes_te.size), docs=int(sizes_te.sum()), fit_s=fit_s,
        waves=st.n_waves, mean_exit_stage=st.mean_exit_stage,
        scores_computed=st.scores_computed, scores_possible=st.scores_possible,
        ndcg=ndcg, ndcg_full=ndcg_full, train_disagreement=gp.train_disagreement,
    )
    log(f"[phase 4d] ranking {sizes_te.size} test queries / {int(sizes_te.sum())} docs in "
        f"{st.n_waves} waves: mean exit stage {st.mean_exit_stage:.3f}/{gp.S}, scores "
        f"computed {st.scores_computed}/{st.scores_possible} "
        f"({st.compute_fraction:.2%} of eager), NDCG@{gp.k} {ndcg:.4f} (full cascade "
        f"{ndcg_full:.4f}); card == CPU == host rung == run_grouped_host, margin-inf == "
        f"full_cascade_topk; launches {launches['rank/both']}")
    # the second drain captures each program and replays it, the third
    # replays them: equal results and launches, nothing recaptured
    traces = ex.traces
    for i, path in enumerate(("rank/both/capture", "rank/both/replay")):
        graphs = dict(ex._graphs)
        again = counted(launches, path, lambda: submit_queries(card, ds.x_test, off))
        if again != res_card or launches[path] != launches["rank/both"] \
                or ex.traces != traces or len(ex._graphs) != traces \
                or (i and ex._graphs != graphs):
            raise AssertionError(f"ranking: {path} differs, or a graph was recaptured")
    log(f"[phase 4d] the second drain captures the {traces} programs, the third replays "
        f"them: == the first, same launches")
    # never-seen queries (the first RANK_FRESH train queries) replay the
    # same graphs: equal to capture=False and to run_grouped_host
    graphs = dict(ex._graphs)
    off_tr = group_offsets(sizes_tr)
    x_new, off_new = ds.x_train[: off_tr[RANK_FRESH]], off_tr[: RANK_FRESH + 1]
    waves = st.n_waves
    new = counted(launches, "rank/both/fresh", lambda: submit_queries(card, x_new, off_new))
    new_twin = counted(launches, "rank/both/fresh/eager",
                       lambda: submit_queries(twin, x_new, off_new))
    oracle_new = run_grouped_host(gp, F_train[: off_tr[RANK_FRESH]], sizes_tr[:RANK_FRESH])
    ref_new = (oracle_new.verdicts.astype(np.int64), oracle_new.exit_stage,
               oracle_new.margin.view(np.int32))
    if new != new_twin or launches["rank/both/fresh"] != launches["rank/both/fresh/eager"]:
        raise AssertionError("ranking: never-seen queries, captured != capture=False")
    if not all(np.array_equal(a, b) for a, b in zip(fields(new, off_new), ref_new)):
        raise AssertionError("ranking: never-seen queries != run_grouped_host")
    if any(ex._graphs.get(k) is not g for k, g in graphs.items()):
        raise AssertionError("ranking: never-seen queries recaptured a graph")
    new_keys = ex.traces - traces
    log(f"[phase 4d] {RANK_FRESH} never-seen queries: {st.n_waves - waves} "
        f"waves, {new_keys} new programs, the rest replayed == capture=False == "
        f"run_grouped_host")
    # B8's input at the widest bucket wave's first stage, for phase 5
    b, gidx = max(pack_by_bucket(sizes_te, gp.buckets).items())
    rows, valid = bucket_layout(sizes_te[gidx], b, offsets=off[gidx])
    cap_g = card.executor._cap_groups(len(gidx), RANK_BATCH)
    Fo = torch.from_numpy(F_test.astype(np.float32)[:, gp.plan.order]).cuda()
    rows_t = torch.zeros(cap_g, b, dtype=torch.int64, device="cuda")
    rows_t[: len(gidx)] = torch.from_numpy(rows).cuda()
    valid_t = torch.zeros(cap_g, b, dtype=torch.int32, device="cuda")
    valid_t[: len(gidx)] = torch.from_numpy(valid.astype(np.int32)).cuda()
    g0 = torch.zeros(cap_g, b, device="cuda")
    t0, t1 = gp.plan.stages[0]
    for j in range(t0, t1):
        g0 = g0 + torch.where(valid_t != 0, Fo[rows_t, j], 0.0)
    eps0 = torch.full((cap_g,), float(gp.eps_g[0]), device="cuda")
    return dict(
        server=lambda capture=True: server("device", "cuda", capture), x=ds.x_test, offsets=off,
        fresh=fresh_queries(ds.x_train, N_RANK_DRAINS, GROUPS_SEED + 1),
        b8=(g0, valid_t, eps0, gp.k, torch.tensor(len(gidx), dtype=torch.int32, device="cuda"),
            rows_t),
        b8_shape=f"G={cap_g} (live {len(gidx)}) B={b} k={gp.k}", S=gp.S,
        fitted=fitted, score_fn=score_fn, calls=calls, sizes=sizes_te, F_test=F_test,
        fields=fields,
    )


def submit_stream(server, x, offsets, arrivals) -> list[dict]:
    for i in range(offsets.size - 1):
        server.submit(x[offsets[i] : offsets[i + 1]], arrival=float(arrivals[i]))
    return server.drain()


def same_waves(a, b, what: str, loop_counts: bool = True) -> None:
    """Two streaming ranking servers' waves: verdicts, exit stages, margins'
    bits, the admit / done timeline, occupancy, steps run and the bill
    equal (with ``loop_counts`` also the steps enqueued and the syncs), and
    their ``RankStats``."""
    import numpy as np

    ra, rb = a.stream_results, b.stream_results
    if len(ra) != len(rb) or vars(a.stats) != vars(b.stats):
        raise AssertionError(f"{what}: {len(ra)} / {len(rb)} waves, stats {vars(a.stats)} / "
                             f"{vars(b.stats)}")
    for i, (x, y) in enumerate(zip(ra, rb)):
        for k in ("verdicts", "exit_stage", "admit_step", "done_step", "occupancy"):
            if not np.array_equal(getattr(x, k), getattr(y, k)):
                raise AssertionError(f"{what}: wave {i} {k} differs")
        if not np.array_equal(x.margin.view(np.int32), y.margin.view(np.int32)):
            raise AssertionError(f"{what}: wave {i} margin bits differ")
        keys = ["steps_run", "scores_computed", "capacity_groups"]
        for k in keys + (["steps_enqueued", "syncs"] if loop_counts else []):
            if getattr(x, k) != getattr(y, k):
                raise AssertionError(f"{what}: wave {i} {k} {getattr(x, k)} / {getattr(y, k)}")


def phase_rank_stream(report: dict, launches: dict, rmain: dict) -> dict:
    """Phase 4g: grouped streaming.  Phase 4d's fit (no new fit) serves
    the test queries through ``serve(streaming=True)`` under each admission
    policy, each query at its seed-2028 Poisson arrival at
    ``RANK_STREAM_RATE`` queries a stage step: on the card (B3 once a
    flush, B8 once a step enqueued, at each slot's own stage threshold),
    held against the same server with ``capture=False`` (every wave's
    verdicts, exit stages, margin bits, timeline, bill and the launches),
    against ``device="cpu"`` and against ``run_grouped_host``.  A bucket
    shape is one program: the second drain captures what the first ran
    eagerly, the third replays it and recaptures nothing.  Then
    ``run_stream_grouped`` alone on the largest bucket at
    ``RANK_STREAM_CAP`` slots (slots refill mid-cascade), eager, captured
    and replayed, equal to its CPU run and to the batch ``run_grouped``."""
    import numpy as np
    import torch

    from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, matrix_stage_scorer
    from repro_torch.ranking import bucket_layout, pack_by_bucket, run_grouped_host

    fitted, score_fn, calls = rmain["fitted"], rmain["score_fn"], rmain["calls"]
    x, off, sizes, F_test, fields = (rmain[k] for k in ("x", "offsets", "sizes", "F_test",
                                                         "fields"))
    gp = fitted.grouped
    arr = poisson_arrivals(sizes.size, RANK_STREAM_RATE)
    oracle = run_grouped_host(gp, F_test, sizes)
    ref = (oracle.verdicts.astype(np.int64), oracle.exit_stage, oracle.margin.view(np.int32))

    def server(device, policy, capture=True):
        srv = fitted.compile("device", device=device).serve(
            score_fn=score_fn, batch_size=RANK_BATCH, capacity_docs=RANK_DOCS,
            streaming=True, policy=policy,
        )
        return srv if capture else rank_twin(srv)

    def later(srv):
        # the trace again, after every arrival the server has seen
        return arr + math.ceil(srv._clock) + 1.0

    out = {}
    for policy in RANK_POLICIES:
        path = f"rank_stream/{policy}"
        card = server("cuda", policy)
        calls["n"] = 0
        res = counted(launches, path, lambda: submit_stream(card, x, off, arr))
        # the first drain's stats (the server's stats go on to add the later drains')
        st, ex = dataclasses.replace(card.stats), card.executor
        want = {"gbt_scores": calls["n"],
                "cascade_group": sum(w.steps_enqueued for w in card.stream_results)}
        if launches[path] != want:
            raise AssertionError(f"{path}: launched {launches[path]}, expected {want}")
        twin = server("cuda", policy, capture=False)
        res_twin = counted(launches, f"{path}/eager", lambda: submit_stream(twin, x, off, arr))
        if res_twin != res or launches[f"{path}/eager"] != launches[path]:
            raise AssertionError(f"{path}: captured results or launches != capture=False")
        same_waves(card, twin, f"{path} captured vs capture=False")
        cpu = server("cpu", policy)
        if submit_stream(cpu, x, off, arr) != res:
            raise AssertionError(f"{path}: card results != device='cpu'")
        same_waves(card, cpu, f"{path} card vs CPU")
        if len(res) != sizes.size or not all(
            np.array_equal(a, b) for a, b in zip(fields(res), ref)
        ):
            raise AssertionError(f"{path}: verdicts/exit stages/margins != run_grouped_host")
        waves = list(card.stream_results)
        traces, graphs_first = ex.traces, len(ex._graphs)
        # one program a bucket shape (the ring pinned to the slot count):
        # the second drain captures each program the first ran once, the
        # third replays every graph and captures none
        for i, step in enumerate(("capture", "replay")):
            graphs = dict(ex._graphs)
            n0 = len(card.stream_results)
            again = counted(launches, f"{path}/{step}",
                            lambda: submit_stream(card, x, off, later(card)))
            enq = sum(w.steps_enqueued for w in card.stream_results[n0:])
            if again != res or launches[f"{path}/{step}"] != {"gbt_scores": 1,
                                                                "cascade_group": enq}:
                raise AssertionError(f"{path}: {step} drain differs: {launches[f'{path}/{step}']}")
            if ex.traces != traces or len(ex._graphs) != traces or (
                    i and any(ex._graphs.get(k) is not g for k, g in graphs.items())):
                raise AssertionError(f"{path}: {step} drain: traces {ex.traces}, graphs "
                                     f"{len(ex._graphs)} of {traces}, or a graph recaptured")
        out[policy] = dict(
            waves=len(waves), traces=traces, graphs_after_first_drain=graphs_first,
            wave_groups=[int(w.verdicts.shape[0]) for w in waves],
            steps_run=[w.steps_run for w in waves],
            steps_enqueued=[w.steps_enqueued for w in waves],
            syncs=[w.syncs for w in waves],
            mean_occupancy=[w.mean_occupancy for w in waves],
            mean_exit_stage=st.mean_exit_stage, scores_computed=st.scores_computed,
            scores_possible=st.scores_possible, launches=launches[path],
        )
        log(f"[phase 4g] {policy}: {sizes.size} queries in {len(waves)} waves "
            f"({out[policy]['wave_groups']} groups), {traces} programs; steps run "
            f"{out[policy]['steps_run']}, enqueued {out[policy]['steps_enqueued']}, syncs "
            f"{out[policy]['syncs']}; mean exit stage {st.mean_exit_stage:.3f}/{gp.S}, scores "
            f"{st.scores_computed}/{st.scores_possible}; card == capture=False == CPU == "
            f"run_grouped_host; launches {launches[path]}; the second drain captures, the "
            f"third replays (no recapture)")
    # the executor alone on the largest bucket, its groups all waiting for
    # RANK_STREAM_CAP slots
    b, gidx = max(pack_by_bucket(sizes, gp.buckets).items(), key=lambda kv: len(kv[1]))
    n = len(gidx)
    if n <= RANK_STREAM_CAP:
        raise AssertionError(f"largest bucket holds {n} groups, not above {RANK_STREAM_CAP}")
    rows, valid = bucket_layout(sizes[gidx], b, offsets=off[gidx])
    Fo = np.ascontiguousarray(F_test.astype(np.float32)[:, gp.plan.order])
    dplan = DevicePlan.from_plan(gp.plan)

    def executor(device):
        return DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=device), device=device)

    ex_c, ex_p = executor("cuda"), executor("cpu")
    args = (Fo, rows, valid, n, gp.eps_g, gp.k)
    kw = dict(capacity_groups=RANK_STREAM_CAP)
    want = ex_p.run_stream_grouped(*args, **kw)
    for i in range(3):  # eager, captured, replayed
        got = counted(launches, f"rank_stream_exec/{i}", lambda: ex_c.run_stream_grouped(*args, **kw))
        for k in ("verdicts", "exit_stage", "admit_step", "done_step", "occupancy"):
            if not np.array_equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"run_stream_grouped run {i}: card {k} != CPU")
        if not np.array_equal(got.margin.view(np.int32), want.margin.view(np.int32)):
            raise AssertionError(f"run_stream_grouped run {i}: card margin bits != CPU")
        for k in ("steps_run", "scores_computed", "steps_enqueued", "syncs"):
            if getattr(got, k) != getattr(want, k):
                raise AssertionError(f"run_stream_grouped run {i}: card {k} != CPU")
    if not (int(got.occupancy.max()) == got.capacity_groups == RANK_STREAM_CAP
            and ex_c.traces == 1 and len(ex_c._graphs) == 1):
        raise AssertionError(f"run_stream_grouped: occupancy max {got.occupancy.max()}, "
                             f"traces {ex_c.traces}, graphs {len(ex_c._graphs)}")
    batch = ex_c.run_grouped(*args)
    if not (np.array_equal(got.verdicts, batch.verdicts)
            and np.array_equal(got.exit_stage, batch.exit_stage)
            and np.array_equal(got.margin.view(np.int32), batch.margin.view(np.int32))):
        raise AssertionError("run_stream_grouped on the card != its batch run_grouped")
    out["executor"] = dict(bucket=b, groups=n, capacity_groups=got.capacity_groups,
                           steps_run=got.steps_run, steps_enqueued=got.steps_enqueued,
                           syncs=got.syncs, mean_occupancy=got.mean_occupancy,
                           scores_computed=got.scores_computed,
                           batch_scores_computed=batch.scores_computed)
    log(f"[phase 4g] run_stream_grouped, bucket {b} ({n} groups) at {RANK_STREAM_CAP} slots: "
        f"{got.steps_run} steps ({got.steps_enqueued} enqueued, {got.syncs} syncs), occupancy "
        f"{got.mean_occupancy:.4f}; eager, captured and replayed == CPU, == batch run_grouped "
        f"(scores {got.scores_computed} vs {batch.scores_computed})")
    report["rank_stream"] = out
    return dict(server=server, x=x, offsets=off, arrivals=arr, S=gp.S)


def phase_baselines(report: dict, launches: dict, main: dict) -> dict:
    """Phase 4h: the paper's baselines and variants on exp1_adult (phase 4's
    trees, calibration and test matrices and QWYC fit; no new greedy QWYC
    search): the fixed orderings with their Algorithm-2 thresholds decided
    by B1, the masked walk ``cascade_from_scores`` on the card, Fan et al.,
    the device candidate sweep on a cut matrix, and the MoE expert
    contributions at Qwen3-MoE's layer widths."""
    import types

    import numpy as np
    import torch

    from repro_torch.convert import moe_params_from_numpy
    from repro_torch.core import (
        cascade_from_scores,
        evaluate_cascade,
        evaluate_fan,
        expert_contributions,
        fit_fan,
        fit_moe_qwyc,
        fit_thresholds_for_order,
        gbt_order,
        greedy_mse_order,
        individual_mse_order,
        random_order,
        report_moe_qwyc,
    )
    from repro_torch.core.moe_qwyc import _gate
    from repro_torch.core.qwyc_distributed import fit_qwyc_sharded
    from repro_torch.kernels import ops

    ds, F_train, F_test, beta = main["ds"], main["F_train"], main["F_test"], main["beta"]
    qwyc = main["fits"]["both"]
    T = F_train.shape[1]
    t = time.perf_counter()
    orders = {
        "gbt": gbt_order(T), "random": random_order(T, seed=0),
        "individual_mse": individual_mse_order(F_train, ds.y_train),
        "greedy_mse": greedy_mse_order(F_train, ds.y_train), "qwyc": qwyc.order,
    }
    log(f"[phase 4h] orderings of {T} trees on {F_train.shape[0]} labelled calibration rows in "
        f"{time.perf_counter() - t:.1f}s")
    out: dict = {"orderings": {}}
    walk_ms = b1_ms = None
    for name, order in orders.items():
        m = qwyc if name == "qwyc" else fit_thresholds_for_order(
            F_train, order, beta=beta, alpha=0.005, mode="both")
        ev = evaluate_cascade(m, F_test)
        S = torch.from_numpy(np.ascontiguousarray(F_test[:, m.order], dtype=np.float32)).cuda()
        eps = [torch.as_tensor(e, device="cuda") for e in (m.eps_pos, m.eps_neg)]
        dec, ex = counted(launches, f"orderings/{name}",
                          lambda: ops.cascade_decide(S, *eps, m.beta))
        dec, ex = dec.cpu().numpy().astype(bool), ex.cpu().numpy()
        if not (np.array_equal(dec, ev["decisions"]) and np.array_equal(ex, ev["exit_step"])):
            raise AssertionError(f"{name}: B1 verdicts != evaluate_cascade")
        walk = counted(launches, f"walk/{name}",
                       lambda: cascade_from_scores(S, m.eps_pos, m.eps_neg, m.beta))
        walk_cpu = cascade_from_scores(S.cpu(), m.eps_pos, m.eps_neg, m.beta, device="cpu")
        if not (np.array_equal(walk.decisions.cpu().numpy(), dec)
                and np.array_equal(walk.exit_step.cpu().numpy(), ex)):
            raise AssertionError(f"{name}: cascade_from_scores on the card != B1")
        if not torch.equal(walk.g_final.cpu().view(torch.int32), walk_cpu.g_final.view(torch.int32)):
            raise AssertionError(f"{name}: cascade_from_scores g_final bits: card != CPU")
        if name == "qwyc":
            b1_ms = (device_time_ms(lambda: ops.cascade_decide(S, *eps, m.beta), reps=20),
                     wall_ms(lambda: ops.cascade_decide(S, *eps, m.beta), reps=20))
            walk_ms = wall_ms(lambda: cascade_from_scores(S, m.eps_pos, m.eps_neg, m.beta),
                              reps=5)
        out["orderings"][name] = dict(mean_models=float(ex.mean()), diff_rate=ev["diff_rate"],
                                      train_mean_models=m.train_mean_models)
        log(f"[phase 4h] order {name}: mean models {ex.mean():.3f}/{T}, diff vs full "
            f"{ev['diff_rate']:.4f}; B1 == evaluate_cascade, walk == B1, walk g_final card == CPU")
    fan = fit_fan(F_train, orders["individual_mse"], lam=0.01, gamma=3.0, beta=beta)
    fe = evaluate_fan(fan, F_test)
    out["fan"] = dict(mean_models=fe["mean_models"], diff_rate=fe["diff_rate"])
    log(f"[phase 4h] Fan et al. (individual_mse order, lambda 0.01, gamma 3): mean models "
        f"{fe['mean_models']:.3f}/{T}, diff vs full {fe['diff_rate']:.4f}")
    log(f"[phase 4h] on (2000, {T}) in QWYC order: the masked walk (cascade_from_scores, "
        f"{T} steps of PyTorch ops) {walk_ms:.3f} ms wall; B1 {b1_ms[0]:.4f} ms device, "
        f"{b1_ms[1]:.4f} ms wall")
    out.update(walk_ms=walk_ms, b1_ms=b1_ms)

    # the device candidate sweep on a cut matrix: the first SWEEP_ROWS
    # calibration rows and SWEEP_T trees
    cut = F_train[:SWEEP_ROWS, :SWEEP_T]
    t = time.perf_counter()
    card = fit_qwyc_sharded(cut, beta=beta, alpha=0.005)
    card_s = time.perf_counter() - t
    cpu = fit_qwyc_sharded(cut, beta=beta, alpha=0.005, device="cpu")
    for f in ("order", "eps_pos", "eps_neg"):
        if not np.array_equal(getattr(card, f), getattr(cpu, f)):
            raise AssertionError(f"fit_qwyc_sharded {f}: card != CPU")
    if (card.train_mean_models, card.train_diff_rate) != (cpu.train_mean_models,
                                                          cpu.train_diff_rate):
        raise AssertionError("fit_qwyc_sharded train stats: card != CPU")
    out["sweep"] = dict(rows=SWEEP_ROWS, T=SWEEP_T, card_s=card_s,
                        train_mean_models=card.train_mean_models)
    log(f"[phase 4h] fit_qwyc_sharded on {cut.shape} in {card_s:.2f}s: == CPU (order, "
        f"thresholds, train mean models {card.train_mean_models:.3f})")

    # MoE expert contributions at Qwen3-30B-A3B's layer widths, seeded weights
    d, E, k, f, N = MOE_WIDTHS
    t = time.perf_counter()
    rng = np.random.default_rng(MOE_SEED)

    def draw(shape, fan_in):
        a = rng.random(shape, dtype=np.float32)
        a *= np.float32(2.0 * np.sqrt(3.0 / fan_in))
        a -= np.float32(np.sqrt(3.0 / fan_in))
        return a

    w = dict(router=draw((d, E), d), wi=draw((E, d, f), d), wg=draw((E, d, f), d),
             wo=draw((E, f, d), f))
    x = rng.standard_normal((N, d), dtype=np.float32)
    readout = rng.standard_normal(d, dtype=np.float32)
    draw_s = time.perf_counter() - t
    cfg = types.SimpleNamespace(n_experts=E, top_k=k)
    p_card = moe_params_from_numpy(**w, device="cuda")
    c_card = counted(launches, "moe", lambda: expert_contributions(p_card, x, readout, cfg))
    moe_ms = device_time_ms(lambda: expert_contributions(p_card, x, readout, cfg), reps=5)
    t = time.perf_counter()
    p_cpu = moe_params_from_numpy(**w, device="cpu")
    c_cpu = expert_contributions(p_cpu, x, readout, cfg, device="cpu")
    cpu_s = time.perf_counter() - t
    gate_card = _gate(torch.from_numpy(x).cuda(), p_card["router"], k).cpu() > 0
    gate_cpu = _gate(torch.from_numpy(x), p_cpu["router"], k) > 0
    if not torch.equal(gate_card, gate_cpu):
        raise AssertionError("expert_contributions: the card routes other experts than the CPU")
    c_card = c_card.cpu()
    err = float((c_card - c_cpu).abs().max())
    tol = 1e-5 * float(c_cpu.abs().max()) + 1e-6
    if not (err <= tol and torch.isfinite(c_card).all()):
        raise AssertionError(f"expert_contributions: card vs CPU max abs err {err} > {tol}")
    half = N // 2
    mq = fit_moe_qwyc(c_card[:half].double(), alpha=0.01)
    rep = report_moe_qwyc(mq, c_card[half:].double())
    out["moe"] = dict(widths=MOE_WIDTHS, draw_s=draw_s, card_ms=moe_ms, cpu_s=cpu_s,
                      max_abs_err=err, tol=tol, mean_experts=rep["mean_experts"],
                      routed=k, diff_rate=rep["diff_rate"])
    log(f"[phase 4h] expert_contributions (d {d}, {E} experts, top {k}, d_ff {f}, {N} tokens; "
        f"weights drawn in {draw_s:.1f}s): card {moe_ms:.2f} ms == CPU routing, max abs err "
        f"{err:.3g} <= {tol:.3g}; QWYC over experts on {N - half} tokens: mean experts "
        f"{rep['mean_experts']:.2f}/{E} (top {k} routed), diff {rep['diff_rate']:.4f}")
    report["baselines"] = out
    return out


def wall_ms(fn, reps: int) -> float:
    """Host-clock time of one call of ``fn`` with the card synced around
    ``reps`` calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _same_or_nan(kernel: str, what: str, a, b) -> None:
    """Kernel output ``a`` against ``b``: equal, floats by their bits, with
    NaN where ``b`` has NaN (a NaN's payload is left open)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{kernel} {what}: {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.is_floating_point():
        nan = torch.isnan(b)
        if not torch.equal(torch.isnan(a), nan):
            raise AssertionError(f"{kernel} {what}: NaN lanes differ")
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    if not torch.equal(a, b):
        raise AssertionError(f"{kernel} {what}: outputs differ")


def phase_guarded(report: dict, launches: dict, main: dict, ctx: dict) -> dict:
    """Phase 4i: guarded serving on exp1_adult.  Poisoned rows (NaN, +inf,
    -inf) through B1, B2 (both forms), B4 and B7 (tree, matrix, lattice)
    and B6 at the main paths' shapes: each poisoned call equals the plain
    version on the card, and its clean lanes equal the clean call bit for
    bit.  Then exp1's batch-256 server (captured): 5 % poisoned rows are
    exactly the quarantined ones, one injected wave fault recovers on the
    device rung, and a lost rung falls to the host, each with phase 4's
    verdicts."""
    import numpy as np
    import torch

    from repro_torch.kernels.cascade_kernel import (
        cascade_chunk_kernel,
        cascade_chunk_plain,
        cascade_chunk_step,
        cascade_chunk_step_plain,
        cascade_kernel,
        cascade_lane_step,
        cascade_lane_step_plain,
        cascade_plain,
    )
    from repro_torch.kernels.megakernel import (
        mega_lane_kernel,
        mega_lane_plain,
        mega_stage_kernel,
        mega_stage_plain,
    )
    from repro_torch.testing import FaultPlan

    dev = torch.device("cuda")
    poison_rows = torch.tensor(GUARD_POISON_ROWS, device=dev)
    values = (float("nan"), float("inf"), float("-inf"), float("nan"))

    def poisoned(x):
        """A copy of ``x`` with each poisoned row filled with its value."""
        x = x.clone()
        for r, v in zip(GUARD_POISON_ROWS, values):
            x[r] = v
        return x

    n_cases = 0

    def hold(name, run, plain, clean_args, bad_args, bad_lanes):
        """The kernel on poisoned inputs == its plain version there; its
        per-lane outputs (g, active, decided, exit) on the clean lanes ==
        the clean call's."""
        nonlocal n_cases
        clean, bad, want = run(*clean_args), run(*bad_args), plain(*bad_args)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(bad, want)):
            _same_or_nan(name, f"poisoned output {k}", a, b)
        keep = ~bad_lanes
        for k in range(4):
            _same_or_nan(name, f"clean lanes output {k}", bad[k][keep], clean[k][keep])
        n_cases += 1
        return bad

    rows, g_buf = ctx["rows"], ctx["g_buf"]
    eps_pos, eps_neg = ctx["eps"]
    lanes = ctx["lanes"]
    nv = torch.tensor(256, dtype=torch.int32, device=dev)
    by_row = torch.isin(rows, poison_rows)  # lanes reading a poisoned buffer row
    by_lane = torch.isin(torch.arange(256, device=dev), poison_rows)
    # B2, the reference's form (the host rung's decide) on a (256, 8) chunk
    g0, chunk, ep, en = ctx["chunk"]
    bad = hold("cascade_chunk", lambda *a: cascade_chunk_kernel(*a, 17, block_n=64),
               lambda *a: cascade_chunk_plain(*a, 17), (g0, chunk, ep, en),
               (g0, poisoned(chunk), ep, en), by_lane)
    if bool(bad[3][poison_rows[::3]].ne(0).any()):
        raise AssertionError("B2: a NaN lane exited")
    # B2's step form (the unfused batch stage) on a stage slab of the matrix
    F = ctx["F"]
    t0 = int(ctx["dplan"].stage_t0[5])
    slab, bad_slab = F[rows, t0 : t0 + 8], poisoned(F)[rows, t0 : t0 + 8]
    gfull = torch.cat([g_buf, g_buf.new_zeros(1)])
    step_args = (eps_pos, eps_neg, lanes["col_valid"])
    hold("cascade_chunk_step",
         lambda g, s: cascade_chunk_step(g, rows, s, 5, *step_args, n_valid=nv, block_n=64),
         lambda g, s: cascade_chunk_step_plain(g, rows, s, 5, *step_args, n_valid=nv),
         (gfull, slab), (gfull, bad_slab), by_row)
    # B6's step form (the unfused streaming step), lanes at every stage
    hold("cascade_lane_step",
         lambda s: cascade_lane_step(g_buf, s, lanes["stage"], *step_args, n_valid=nv,
                                     block_n=64),
         lambda s: cascade_lane_step_plain(g_buf, s, lanes["stage"], *step_args, n_valid=nv),
         (lanes["scores"],), (poisoned(lanes["scores"]),), by_lane)
    # B4 and B7: tree and matrix on exp1's geometry, lattice on exp4's
    for variant, slabs, xop, (ep_t, en_t) in (
        ("tree", ctx["tree"].slabs, ctx["x_buf"], ctx["eps"]),
        ("matrix", ctx["matrix"].slabs, F, ctx["eps"]),
        ("lattice", ctx["lattice"].slabs, ctx["xl_buf"], ctx["leps"]),
    ):
        st = 5
        t0 = int((ctx["lplan"] if variant == "lattice" else ctx["dplan"]).stage_t0[st])
        hold(f"mega_stage_{variant}",
             lambda x: mega_stage_kernel(slabs, x[rows], g_buf, st, t0, nv, ep_t, en_t,
                                         block_n=64),
             lambda x: mega_stage_plain(slabs, x[rows], g_buf, st, t0, nv, ep_t, en_t,
                                        block_n=64),
             (xop,), (poisoned(xop),), by_row)
        hold(f"mega_lane_{variant}",
             lambda x: mega_lane_kernel(slabs, x, rows, g_buf, lanes["stage"], lanes["stop"],
                                        nv, ep_t, en_t, block_n=64),
             lambda x: mega_lane_plain(slabs, x, rows, g_buf, lanes["stage"], lanes["stop"],
                                       nv, ep_t, en_t, block_n=64),
             (xop,), (poisoned(xop),), by_row)
    # B1 on exp1's test matrix in QWYC order, rows poisoned from column 0
    fit = main["fits"]["both"]
    S = torch.from_numpy(np.ascontiguousarray(main["F_test"][:, fit.order], np.float32)).cuda()
    beps = [torch.as_tensor(e, device=dev) for e in (fit.eps_pos, fit.eps_neg)]
    clean = cascade_kernel(S, *beps, fit.beta)
    bad_S = poisoned(S)
    bad = cascade_kernel(bad_S, *beps, fit.beta)
    want = cascade_plain(bad_S, *beps, fit.beta)
    for k in range(2):
        _same_or_nan("cascade", f"poisoned output {k}", bad[k], want[k])
        keep = ~torch.isin(torch.arange(S.shape[0], device=dev), poison_rows)
        _same_or_nan("cascade", f"clean rows output {k}", bad[k][keep], clean[k][keep])
    n_cases += 1
    nan_rows = poison_rows[::3]
    if not (bool((bad[0][nan_rows] == 0).all()) and bool((bad[1][nan_rows] == S.shape[1]).all())):
        raise AssertionError("B1: a NaN row exited or decided positive")
    log(f"[phase 4i] poisoned rows (NaN, +inf, -inf) through B1, B2 (both forms), B6, B4 and "
        f"B7 (tree, matrix, lattice): == plain on the card, clean lanes == the clean call "
        f"({n_cases} cases)")

    # the batch-256 server (TreeScorer, fused, captured), phase 4's verdicts
    ds, server, clean_res = main["ds"], main["server"], main["results"]["both"]
    plan = FaultPlan(seed=ARRIVAL_SEED, poison_fraction=0.05, poison_mode="mix")
    xp, mask = plan.poison(ds.x_test)
    srv = server("both", "cuda")
    res = counted(launches, "guard_quarantine/both", lambda: serve(srv, xp))
    quarantined = np.array([r.get("quarantined", False) for r in res])
    if not np.array_equal(quarantined, mask) or srv.stats.quarantined != int(mask.sum()):
        raise AssertionError("quarantine: the quarantined rows != the poisoned rows")
    if [r for r, q in zip(res, mask) if not q] != [r for r, q in zip(clean_res, mask) if not q]:
        raise AssertionError("quarantine: a clean row's verdict moved")
    if srv.stats.degradation_events or srv._dev[0].traces != 1 or len(srv._dev[0]._graphs) != 1:
        raise AssertionError("quarantine: events, or not one captured program")
    out = dict(poisoned=int(mask.sum()), quarantined=srv.stats.quarantined)
    log(f"[phase 4i] {int(mask.sum())}/{len(mask)} poisoned rows: exactly those quarantined, "
        f"every clean verdict == phase 4's; {srv.stats.n_batches} flushes, one CUDA graph; "
        f"launches {launches['guard_quarantine/both']}")

    srv = server("both", "cuda")
    with FaultPlan(seed=ARRIVAL_SEED, wave_failures=1) as fp:
        res = counted(launches, "guard_recover/both", lambda: serve(srv, ds.x_test))
    evs = [(e.kind, e.from_backend, e.to_backend, e.retries) for e in srv.stats.degradation_events]
    if evs != [("wave", "device", "device", 1)] or srv.exec.name != "device" or res != clean_res:
        raise AssertionError(f"recovery: events {evs}, rung {srv.exec.name}, or verdicts moved")
    log(f"[phase 4i] one injected wave fault: one same-rung recovery {evs}, rung "
        f"{srv.exec.name}, verdicts == phase 4's ({fp.injected['waves']} injected)")

    # the eager server (score_fn) can score on the host rung: a lost device
    # rung falls there, B3 scoring and B2's reference form deciding
    srv = server("both", "cuda", scorer=None, score_fn=main["score_fn"])
    with FaultPlan(seed=ARRIVAL_SEED, wave_failures=10_000) as fp:
        res = counted(launches, "guard_fall/both", lambda: serve(srv, ds.x_test))
    evs = [(e.kind, e.from_backend, e.to_backend, e.retries) for e in srv.stats.degradation_events]
    if evs != [("wave", "device", "host", 2)] or srv.exec.name != "host" or res != clean_res:
        raise AssertionError(f"fall: events {evs}, rung {srv.exec.name}, or verdicts moved")
    out.update(recover=1, fall=evs, fall_injected=fp.injected["waves"])
    log(f"[phase 4i] every device wave failing: fell {evs} after {fp.injected['waves']} injected "
        f"faults, host rung verdicts == phase 4's; launches {launches['guard_fall/both']}")
    report["guarded"] = out
    return out


def grid_payload(payload, order, stages, quant: str):
    """``payload`` (T, L) in original model order, rounded onto ``quant``'s
    grid for the plan's ``stages``: bf16 rounding, or (int8) per stage a
    power-of-two step ``sc`` with the stage's largest value pinned to
    127 sc, as ``tests/test_megakernel.py::_representable`` builds it, so
    the stage's computed scale is exactly ``sc`` and every stored value
    dequantises to itself."""
    import numpy as np
    import torch

    v = np.array(payload, dtype=np.float32)
    if quant == "bf16":
        return torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    for t0, t1 in stages:
        ids = np.asarray(order[t0:t1])
        sv = v[ids]
        m = float(np.abs(sv).max())
        if m == 0.0:
            continue
        sc = 2.0 ** math.ceil(math.log2(m / 127.0))
        k = np.clip(np.round(sv / sc), -127, 127)
        top = np.unravel_index(np.argmax(np.abs(sv)), sv.shape)
        k[top] = 127.0 * np.sign(sv[top])
        v[ids] = (k * sc).astype(np.float32)
    return v


def phase_quant(report: dict, launches: dict, main: dict, lmain: dict) -> dict:
    """Phase 4e: quantised parameter slabs served at full width, with phase
    4's exp1_adult fit and phase 4b's exp4_rw2_joint fit (no new fit).
    For trees and lattices at bf16 and int8: the test rows through
    ``QWYCServer`` (batch 256, policy ``kernel``, ``megakernel=True``: B4 at
    the slabs' storage) and ``StreamingServer`` (256 requests/step,
    capacity 256, window 1024: B7), on the card and on the CPU; for exp1's
    test score matrix at bf16 the same through ``DeviceExecutor``.  Hard
    checks: card == CPU bit for bit (verdicts, exits, g_final, billing);
    batch == streaming; on weights rounded onto the grid, quantised serving
    == f32 serving exactly; on the raw weights, |g_q - g_f32| within
    ``tolerance_bound`` on every row whose exit did not move.  Reported:
    verdicts and exits that moved against f32 serving, the diff rate
    against the full ensemble, mean models."""
    import numpy as np
    import torch

    from repro_torch.api.scorers import LatticeScorer, TreeScorer
    from repro_torch.core import evaluate_cascade
    from repro_torch.core.executor import CascadePlan
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, matrix_stage_scorer
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    gbt = main["gbt"]
    cells = {
        "tree": dict(cell="exp1", fit=main["fits"]["both"], x=main["ds"].x_test,
                     F=main["F_test"], g_f32=main["batch_g"]["both"], make=TreeScorer, pay=2,
                     params=[a.cpu().numpy() for a in (gbt.feats, gbt.thrs, gbt.leaves)]),
        "lattice": dict(cell="exp4", fit=lmain["fit"], x=lmain["ds"].x_test, F=lmain["F_test"],
                        g_f32=lmain["batch_g"], make=LatticeScorer, pay=0,
                        params=[a.cpu().numpy() for a in (lmain["theta"], lmain["feats"])]),
    }

    def batch_server(c, params, quant, device, capture=True):
        return QWYCServer(
            c["fit"], scorer=c["make"](*params, quant=quant), exec_backend="device",
            device=device, backend="kernel", batch_size=256, chunk_t=8,
            backend_opts={"megakernel": True, "capture": capture},
        )

    def stream_server(c, params, quant, device, capture=True):
        return StreamingServer(
            c["fit"], scorer=c["make"](*params, quant=quant), exec_backend="device",
            device=device, batch_size=STREAM_CAP, window=STREAM_WINDOW, chunk_t=8, block_n=64,
            backend_opts={"megakernel": True, "capture": capture},
        )

    def rows_of(results):  # per-row (decisions, exits, g bits) of flushes or waves
        return tuple(np.concatenate([np.asarray(getattr(r, k)) for r in results])
                     for k in ("decisions", "exit_step", "g_final"))

    def same(a, b):
        return all(np.array_equal(np.asarray(u).view(np.int32) if u.dtype == np.float32 else u,
                                  np.asarray(v).view(np.int32) if v.dtype == np.float32 else v)
                   for u, v in zip(a, b))

    def against_f32(name, dec, ex, g, ev, g_f32, eps, g_scale):
        """The raw weights: g within the oracle's bound where the exit did
        not move; moves reported."""
        kept = ex == ev["exit_step"]
        bound = mk.tolerance_bound(eps, ev["exit_step"], g_scale)
        err = np.abs(g.astype(np.float64) - g_f32.astype(np.float64))
        if not (err[kept] <= bound[kept]).all():
            bad = np.flatnonzero(kept & (err > bound))[:8]
            raise AssertionError(f"{name}: |g_q - g_f32| above tolerance_bound on rows {bad.tolist()}")
        return dict(
            verdicts_moved=int((dec != ev["decisions"]).sum()),
            exits_moved=int((~kept).sum()),
            diff_vs_full=float((dec != ev["full_decisions"]).mean()),
            mean_models=float(ex.mean()), max_err=float(err[kept].max(initial=0.0)),
            max_bound=float(bound[kept].max(initial=0.0)),
        )

    out = {}
    for variant, c in cells.items():
        x, fit, cell = c["x"], c["fit"], c["cell"]
        ev = evaluate_cascade(fit, c["F"])
        plan = CascadePlan.from_qwyc(fit, chunk_t=8)
        arrivals = poisson_arrivals(x.shape[0], STREAM_RATES[0])
        for quant in QUANTS:
            t = time.perf_counter()
            name = f"{variant}_{quant}"
            runs = {}
            for kind, make, path, serve_fn in (
                ("batch", batch_server, f"q_batch_{name}/{cell}", lambda s: serve(s, x)),
                ("stream", stream_server, f"q_stream_{name}/{cell}/r256",
                 lambda s: stream_serve(s, x, arrivals)),
            ):
                for device, key in (("cuda", path), ("cpu", f"q_cpu/{cell}/{kind}/{name}")):
                    srv = make(c, c["params"], quant, device)
                    res = counted(launches, key, lambda: serve_fn(srv))
                    waves = srv.flush_results if kind == "batch" else srv.stream_results
                    runs[kind, device] = (res, srv, rows_of(waves))
                    if device == "cuda":
                        eager_twin(launches, key, srv, res,
                                   make(c, c["params"], quant, device, capture=False), serve_fn)
                card = runs[kind, "cuda"][1]
                if kind == "batch":
                    n_launch = card.stats.n_batches * card._dev[0].dplan.S
                else:
                    n_launch = sum(w.steps_enqueued for w in card.stream_results)
                kernel = f"mega_{'stage' if kind == 'batch' else 'lane'}_{name}"
                if launches[path] != {kernel: n_launch}:
                    raise AssertionError(f"{path}: launched {launches[path]}, expected {n_launch}")
                (rc, sc, wc), (rp, sp, wp) = runs[kind, "cuda"], runs[kind, "cpu"]
                if rc != rp or not same(wc, wp):
                    raise AssertionError(f"{name} {kind}: card != CPU (results, exits or g bits)")
                for k in ("scores_computed", "models_evaluated", "chunk_survivors",
                          "latency_steps", "stream_steps"):
                    if getattr(sc.stats, k) != getattr(sp.stats, k):
                        raise AssertionError(f"{name} {kind}: {k} card != CPU")
            if not same(runs["batch", "cuda"][2], runs["stream", "cuda"][2]):
                raise AssertionError(f"{name}: batch != streaming (verdicts, exits or g)")
            dec, ex, g = runs["batch", "cuda"][2]
            slabs = runs["batch", "cuda"][1]._dev[1].slabs
            payload = c["params"][c["pay"]]
            # f32 serving of the raw weights (phases 4 and 4b; its exits are
            # evaluate_cascade's) is what each quantised run is held to
            raw = against_f32(name, dec, ex, g, ev, c["g_f32"], slabs.eps_position,
                              float(np.abs(payload).max()) * fit.T)
            # the same weights on the grid: quantised == f32 serving exactly
            gp = list(c["params"])
            gp[c["pay"]] = grid_payload(payload, fit.order, plan.stages, quant)
            grid = {}
            for q, key in ((quant, f"q_grid_{name}/{cell}"), (None, f"q_grid_f32_{variant}/{cell}")):
                srv = batch_server(c, gp, q, "cuda")
                res = counted(launches, key, lambda: serve(srv, x))
                grid[q] = (res, rows_of(srv.flush_results), srv)
            if grid[quant][2]._dev[1].slabs.eps_position.max() != 0.0:
                raise AssertionError(f"{name}: grid payload not representable")
            if grid[quant][0] != grid[None][0] or not same(grid[quant][1], grid[None][1]):
                raise AssertionError(f"{name}: grid weights, quantised != f32 serving")
            st = runs["batch", "cuda"][1].stats
            out[f"{cell}/{name}"] = dict(
                raw, scores_computed=st.scores_computed, n_batches=st.n_batches,
                stream_steps=runs["stream", "cuda"][1].stats.stream_steps,
                launches_batch=launches[f"q_batch_{name}/{cell}"],
                launches_stream=launches[f"q_stream_{name}/{cell}/r256"],
                wall_s=time.perf_counter() - t,
            )
            log(f"[phase 4e] {cell} {name}: card == CPU, batch == streaming, grid == f32; raw "
                f"weights vs f32: {raw['verdicts_moved']} verdicts / {raw['exits_moved']} exits "
                f"moved of {x.shape[0]}, diff vs full {raw['diff_vs_full']:.4f}, mean models "
                f"{raw['mean_models']:.3f}/{fit.T}, max |g err| {raw['max_err']:.3g} (bound "
                f"{raw['max_bound']:.3g}); launches {out[f'{cell}/{name}']['launches_batch']} "
                f"{out[f'{cell}/{name}']['launches_stream']} in {time.perf_counter() - t:.1f}s")

    # exp1's test score matrix at bf16 through DeviceExecutor
    t = time.perf_counter()
    fit, x = main["fits"]["both"], main["ds"].x_test
    F = main["F_test"]
    Fo = np.ascontiguousarray(F[:, fit.order].astype(np.float32))
    plan = CascadePlan.from_qwyc(fit, chunk_t=8)
    n = Fo.shape[0]
    steps = np.floor(poisson_arrivals(n, STREAM_RATES[0])).astype(np.int64)
    ev = evaluate_cascade(fit, F)

    def executor(quant, device, capture=True):
        dplan = DevicePlan.from_plan(plan, quant=quant)
        return DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=device), block_n=64,
                              megakernel=True, device=device, capture=capture)

    def batches(ex, op):
        return [ex.run(op[b0 : b0 + 256], min(256, n - b0), capacity=256)
                for b0 in range(0, n, 256)]

    runs = {}
    for device, kb, ks in (("cuda", "q_batch_matrix_bf16/exp1", "q_stream_matrix_bf16/exp1/r256"),
                           ("cpu", "q_cpu/exp1/batch/matrix_bf16", "q_cpu/exp1/stream/matrix_bf16")):
        ex = executor("bf16", device)
        if device == "cuda":
            ex_card = ex
        b = counted(launches, kb, lambda: batches(ex, Fo))
        s = counted(launches, ks, lambda: [ex.run_stream(Fo, n, arrivals=steps, capacity=256)])
        runs[device] = (b, s)
    # the captured executor (a batch graph and a streaming graph) against
    # capture=False on the card
    ex_c, ex_e = ex_card, executor("bf16", "cuda", capture=False)
    be = counted(launches, "q_batch_matrix_bf16/exp1/eager", lambda: batches(ex_e, Fo))
    se = counted(launches, "q_stream_matrix_bf16/exp1/r256/eager",
                 lambda: [ex_e.run_stream(Fo, n, arrivals=steps, capacity=256)])
    bc_, sc_ = runs["cuda"]
    if not (same(rows_of(be), rows_of(bc_)) and same(rows_of(se), rows_of(sc_))
            and [r.chunk_stats for r in be] == [r.chunk_stats for r in bc_]
            and [(r.steps_enqueued, r.syncs, r.scores_computed) for r in se]
            == [(r.steps_enqueued, r.syncs, r.scores_computed) for r in sc_]
            and launches["q_batch_matrix_bf16/exp1/eager"] == launches["q_batch_matrix_bf16/exp1"]
            and launches["q_stream_matrix_bf16/exp1/r256/eager"]
            == launches["q_stream_matrix_bf16/exp1/r256"]):
        raise AssertionError("matrix bf16: captured != capture=False")
    if not (ex_c.traces == ex_e.traces == len(ex_c._graphs) == 2 and not ex_e._graphs):
        raise AssertionError(f"matrix bf16: traces {ex_c.traces} / {ex_e.traces}, graphs "
                             f"{len(ex_c._graphs)}")
    S = DevicePlan.from_plan(plan).S
    want = {"q_batch_matrix_bf16/exp1": {"mega_stage_matrix_bf16": len(runs["cuda"][0]) * S},
            "q_stream_matrix_bf16/exp1/r256": {
                "mega_lane_matrix_bf16": runs["cuda"][1][0].steps_enqueued}}
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{k}: launched {launches[k]}, expected {v}")
    (bc, sc), (bp, sp) = runs["cuda"], runs["cpu"]
    if not (same(rows_of(bc), rows_of(bp)) and same(rows_of(sc), rows_of(sp))):
        raise AssertionError("matrix bf16: card != CPU")
    if [r.scores_computed for r in bc] != [r.scores_computed for r in bp] or \
            sc[0].scores_computed != sp[0].scores_computed:
        raise AssertionError("matrix bf16: billing card != CPU")
    if not same(rows_of(bc), rows_of(sc)):
        raise AssertionError("matrix bf16: batch != streaming")
    dec, ex_, g = rows_of(bc)
    g_f32 = np.take_along_axis(np.cumsum(Fo, axis=1, dtype=np.float32),
                               ev["exit_step"][:, None] - 1, axis=1)[:, 0]
    raw = against_f32("matrix_bf16", dec, ex_, g, ev, g_f32, mk.matrix_eps_position(Fo, "bf16"),
                      float(np.abs(Fo).max()) * fit.T)
    Fg = torch.from_numpy(Fo).to(torch.bfloat16).float().numpy()
    grid = {}
    for q, key in (("bf16", "q_grid_matrix_bf16/exp1"), ("f32", "q_grid_f32_matrix/exp1")):
        ex = executor(q, "cuda")
        grid[q] = rows_of(counted(launches, key, lambda: batches(ex, Fg)))
    if not same(grid["bf16"], grid["f32"]):
        raise AssertionError("matrix bf16: grid operand, bf16 != f32 serving")
    out["exp1/matrix_bf16"] = dict(
        raw, scores_computed=sum(r.scores_computed for r in bc),
        stream_steps=sc[0].steps_run, launches_batch=launches["q_batch_matrix_bf16/exp1"],
        launches_stream=launches["q_stream_matrix_bf16/exp1/r256"],
        wall_s=time.perf_counter() - t,
    )
    log(f"[phase 4e] exp1 matrix_bf16: card == CPU, batch == streaming, grid == f32; raw vs "
        f"f32: {raw['verdicts_moved']} verdicts / {raw['exits_moved']} exits moved, diff vs full "
        f"{raw['diff_vs_full']:.4f}, mean models {raw['mean_models']:.3f}/{fit.T}; launches "
        f"{want} in {time.perf_counter() - t:.1f}s")
    report["quant"] = out
    return dict(batch_server=batch_server, stream_server=stream_server, cells=cells)


def phase_neural(report: dict, launches: dict, check: Check) -> dict:
    """Phase 4j: the neural depth cascade at Qwen3-1.7B's published widths
    (28 layers, d_model 2048, vocab 151936, an exit head every 2 layers: 14
    exits), random f32 weights drawn on the card.  Calibrates with the
    chunked ``exit_scores``, fits (``api.fit(NeuralScorer, tokens)``), serves
    the test sequences through ``QWYCServer(scorer=NeuralScorer)`` captured
    and with ``capture=False`` (B2's step form once a stage), streams an
    8-layer cut of the same widths through ``StreamingServer`` (B6 once a
    step) against the batch path on the same rows and the cut's query groups
    through both grouped loops (B8), holds B2's and B6's step forms against
    their plain versions on the neural stages' own scores, and holds a
    2-layer cut's exit scores on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core import evaluate_cascade
    from repro_torch.core.early_exit import exit_deltas, exit_scores
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    card = report["card"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen3-1.7b").scaled(exit_interval=2)
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(NEURAL_SEED),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for d in (params["embed"], params["layers"]["attn"],
                                       params["layers"]["mlp"]) for v in d.values())
    log(f"[phase 4j] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers // cfg.exit_interval} exits; {n_params / 1e9:.3f}e9 "
        f"f32 weights drawn on the card in {time.perf_counter() - t:.1f}s")
    toks = np.random.default_rng(NEURAL_SEED + 1).integers(
        0, cfg.vocab_size, size=(NEURAL_CALIB + NEURAL_TEST, NEURAL_SEQ))
    calib, test = toks[:NEURAL_CALIB], toks[NEURAL_CALIB:]
    scorer = api.NeuralScorer(params, cfg, seq_len=NEURAL_SEQ)
    E = scorer.n_exits

    t = time.perf_counter()
    fitted = counted(launches, "neural_scores/calibration", lambda: api.fit(
        scorer, calib, alpha=NEURAL_ALPHA, chunk_t=NEURAL_CHUNK_T))
    calib_s = time.perf_counter() - t
    m = fitted.model
    if not (np.array_equal(m.order, np.arange(E)) and np.all(m.costs == cfg.exit_interval)):
        raise AssertionError(f"neural fit: order {m.order}, costs {m.costs}")
    ev_calib = evaluate_cascade(m, fitted.calibration_scores)
    if ev_calib["diff_rate"] > NEURAL_ALPHA:
        raise AssertionError(f"neural fit: calibration disagreement {ev_calib['diff_rate']} > "
                             f"alpha {NEURAL_ALPHA}")
    log(f"[phase 4j] calibration: exit_scores over {calib.shape} tokens and the fit in "
        f"{calib_s:.1f}s; calibration mean layers {ev_calib['mean_cost']:.2f}/{cfg.n_layers}, "
        f"disagreement {ev_calib['diff_rate']:.4f} <= alpha {NEURAL_ALPHA}")
    S_test = counted(launches, "neural_scores/test", lambda: exit_scores(params, cfg, test))
    F_test = exit_deltas(S_test)
    S_test = S_test.cpu().numpy().astype(np.float64)

    near_band, verdicts, agree = _near_band, _verdicts, _agree
    out: dict = {"card": card, "calibration_s": calib_s, "n_exits": E,
                 "calib_diff_rate": ev_calib["diff_rate"]}

    def batch_server(model, sc, **kw):
        return QWYCServer(model, scorer=sc, backend="kernel", batch_size=NEURAL_BATCH,
                          chunk_t=NEURAL_CHUNK_T, device="cuda", **kw)

    # the batch server over the test sequences, captured and eager
    t = time.perf_counter()
    srv = batch_server(m, scorer)
    res = counted(launches, "neural_batch", lambda: serve(srv, test))
    eager_twin(launches, "neural_batch", srv, res, batch_server(
        m, scorer, backend_opts={"capture": False}), lambda x: serve(x, test))
    serve_s = time.perf_counter() - t
    n_flush, S = srv.stats.n_batches, srv._dev[0].dplan.S
    b2 = launches["neural_batch"].get("cascade_chunk_step", 0)
    if b2 != n_flush * S:
        raise AssertionError(f"neural_batch: {b2} B2 launches over {n_flush} flushes of {S} "
                             "stages")
    stages_live = [len(r.chunk_stats) for r in srv.flush_results]
    ev = evaluate_cascade(m, F_test)
    got = verdicts(res)
    near = near_band(m, F_test)
    moved = agree("neural_batch vs evaluate_cascade", got,
                  (ev["decisions"], ev["exit_step"]), near)
    layers = float(got[1].mean()) * cfg.exit_interval
    if not layers < cfg.n_layers:
        raise AssertionError(f"neural_batch: mean layers paid {layers} not below {cfg.n_layers}")
    log(f"[phase 4j] served {NEURAL_TEST} sequences in {n_flush} flushes of batch "
        f"{NEURAL_BATCH} (one CUDA graph == capture=False) in {serve_s:.1f}s: mean layers paid "
        f"{layers:.2f}/{cfg.n_layers}, diff vs full depth "
        f"{float((got[0] != (S_test[:, -1] >= m.beta)).mean()):.4f}; B2 {b2} launches = "
        f"{n_flush} flushes x {S} stages enqueued (stages with live rows {stages_live}); "
        f"{moved} verdicts moved vs evaluate_cascade, {int(near.sum())} rows in the band")
    out.update(mean_layers=layers, flushes=n_flush, stages=S, b2_launches=b2,
               stages_with_live_rows=stages_live, moved_vs_oracle=moved,
               band_rows=int(near.sum()))

    # walls at one batch: a captured and an eager flush against a full-depth
    # forward (exit_scores over the same rows)
    x = test[:NEURAL_BATCH]
    x_dev = torch.from_numpy(x).cuda()
    twin = batch_server(m, scorer, backend_opts={"capture": False})
    ex_cap, ex_eager = srv._dev[0], twin._device_state()[0]
    flush_ms = wall_ms(lambda: ex_cap.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH), reps=5)
    eager_ms = wall_ms(lambda: ex_eager.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH), reps=3)
    full_ms = counted(launches, "neural_scores/full_depth",
                      lambda: wall_ms(lambda: exit_scores(params, cfg, x_dev), reps=3))
    flush_res = ex_cap.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH)
    paid = float(flush_res.exit_step.mean()) * cfg.exit_interval
    log(f"[phase 4j] {card}: batch {NEURAL_BATCH} x {NEURAL_SEQ} tokens: captured flush "
        f"{flush_ms:.1f} ms, eager flush {eager_ms:.1f} ms, full-depth forward {full_ms:.1f} ms "
        f"(the flush's rows paid {paid:.2f} of {cfg.n_layers} layers; the captured loop runs "
        f"all {S} stages at the full capacity)")
    out.update(flush_ms=flush_ms, eager_flush_ms=eager_ms, full_depth_ms=full_ms,
               flush_layers_paid=paid)
    out["b2_real_scores"] = check_neural_chunk_step(check, ex_cap, x)
    del srv, twin, ex_cap, ex_eager

    # the streaming cut: the first NEURAL_STREAM_LAYERS layers and their
    # exits at the same widths, fit on the full calibration's first columns
    cut = NEURAL_STREAM_LAYERS
    E8 = cut // cfg.exit_interval
    cfg8 = cfg.scaled(n_layers=cut)
    params8 = {**params, "exit_heads": params["exit_heads"][:E8],
               "layers": _layer_slice(params["layers"], cut)}
    sc8 = api.NeuralScorer(params8, cfg8, seq_len=NEURAL_SEQ)
    m8 = api.fit(fitted.calibration_scores[:, :E8], alpha=NEURAL_ALPHA,
                 chunk_t=NEURAL_CHUNK_T, **sc8.fit_overrides()).model
    arr = poisson_arrivals(NEURAL_TEST, NEURAL_STREAM_RATE)

    def stream_server(**kw):
        return StreamingServer(m8, scorer=sc8, batch_size=NEURAL_BATCH, window=NEURAL_WINDOW,
                               chunk_t=NEURAL_CHUNK_T, device="cuda", **kw)

    t = time.perf_counter()
    ss = stream_server()
    sres = counted(launches, "neural_stream", lambda: stream_serve(ss, test, arr))
    eager_twin(launches, "neural_stream", ss, sres,
               stream_server(backend_opts={"capture": False}),
               lambda x: stream_serve(x, test, arr))
    stream_s = time.perf_counter() - t
    enq = sum(r.steps_enqueued for r in ss.stream_results)
    b6 = launches["neural_stream"].get("cascade_lane", 0)
    if b6 != enq:
        raise AssertionError(f"neural_stream: {b6} B6 launches, {enq} steps enqueued")
    bsrv = batch_server(m8, sc8)
    bres = counted(launches, "neural_batch/cut", lambda: serve(bsrv, test))
    F8 = F_test[:, :E8]
    moved8 = agree("neural_stream vs the batch path", verdicts(sres), verdicts(bres),
                   near_band(m8, F8))
    steps = sum(r.steps_run for r in ss.stream_results)
    log(f"[phase 4j] streaming cut ({cut} layers, {E8} exits, same widths): {NEURAL_TEST} "
        f"sequences at {NEURAL_STREAM_RATE}/step through {NEURAL_BATCH} lanes in "
        f"{len(ss.stream_results)} waves, {steps} steps run, {enq} enqueued, B6 {b6} launches "
        f"(one a step enqueued), one CUDA graph == capture=False, in {stream_s:.1f}s; "
        f"{moved8} verdicts differ from the batch path on the same rows, mean layers paid "
        f"{ss.stats.models_evaluated / ss.stats.n_requests * cfg.exit_interval:.2f}/{cut}")
    out.update(stream_waves=len(ss.stream_results), stream_steps=steps, stream_enqueued=enq,
               b6_launches=b6, stream_moved_vs_batch=moved8, stream_s=stream_s)
    out["b6_real_scores"] = check_neural_lane_step(check, ss._dev[0], test[:NEURAL_BATCH])
    del ss, bsrv
    out["grouped"] = neural_grouped(launches, m8, sc8, test, F8)

    # the card against the CPU on a 2-layer cut of the same widths
    cut2 = NEURAL_CPU_LAYERS
    cfg2 = cfg.scaled(n_layers=cut2)
    p2 = {**params, "exit_heads": params["exit_heads"][: cut2 // cfg.exit_interval],
          "layers": _layer_slice(params["layers"], cut2)}
    rows = test[:NEURAL_CPU_ROWS]
    on_card = exit_scores(p2, cfg2, rows).cpu()
    t = time.perf_counter()
    p2_cpu = {k: _to_cpu(v) for k, v in p2.items()}
    on_cpu = exit_scores(p2_cpu, cfg2, rows)
    err = float((on_card - on_cpu).abs().max())
    bound = NEURAL_TOL * max(1.0, float(on_cpu.abs().max()))
    if not err <= bound:
        raise AssertionError(f"neural {cut2}-layer cut: card vs CPU exit scores max abs err "
                             f"{err} > {bound}")
    log(f"[phase 4j] {cut2}-layer cut at full widths, {NEURAL_CPU_ROWS} sequences: exit scores "
        f"card vs CPU max abs err {err:.3g} <= {bound:.3g} (TF32 off; CPU in "
        f"{time.perf_counter() - t:.1f}s)")
    out.update(cpu_max_abs_err=err, cpu_bound=bound)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase 4j] {card}: torch.cuda.max_memory_allocated "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB; the phase took {out['phase_s']:.1f}s")
    report["neural"] = out
    del params, params8, p2, p2_cpu, scorer, sc8, fitted
    torch.cuda.empty_cache()
    return out


def _near_band(model, F):
    """Rows whose running sum (of the (N, T) exit deltas ``F``) comes within
    the band of a finite threshold or of beta."""
    import numpy as np

    G = np.cumsum(F[:, model.order], axis=1)
    band = NEURAL_BAND * max(1.0, float(np.abs(G).max()))
    near = np.abs(G[:, -1] - model.beta) <= band
    for eps in (model.eps_pos, model.eps_neg):
        fin = np.isfinite(eps)
        near |= (np.abs(G[:, fin] - eps[fin]) <= band).any(axis=1)
    return near


def _verdicts(res):
    """A server's results -> (decisions, models evaluated) arrays."""
    import numpy as np

    return (np.array([r["decision"] for r in res]),
            np.array([r["models_evaluated"] for r in res]))


def _agree(what, a, b, near):
    """Verdicts ``a`` and ``b`` equal on every row outside the band;
    returns the rows that differ (all inside it)."""
    import numpy as np

    diff = (a[0] != b[0]) | (a[1] != b[1])
    if (diff & ~near).any():
        raise AssertionError(f"{what}: {int((diff & ~near).sum())} rows differ outside the "
                             f"band (rows {np.flatnonzero(diff & ~near)[:8]})")
    return int(diff.sum())


def check_neural_chunk_step(check: Check, ex, x) -> dict:
    """Phase 4j: B2's step form against ``cascade_chunk_step_plain`` on the
    neural stages' own scores (W 2, 7 stages, the batch executor ``ex``'s
    tables): ``x``'s rows go through every stage of the bound scorer, its
    state carried, and each stage's scores are decided by the wrapper and
    the plain version with every row live, a device live count mid-block
    (the rows past it at the trash slot) and a host count.  All six
    outputs equal, ``g`` by its bits; the next stage reads the running sums
    of the all-live call."""
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_chunk_step, cascade_chunk_step_plain

    bound, dp, dev = ex.scorer, ex.dplan, ex.device
    xp = bound.prepare(x)
    cap = xp.shape[0]
    lane = torch.arange(cap, device=dev)
    g = torch.zeros(cap + 1, dtype=torch.float32, device=dev)
    state: dict = {}
    n_cases, exits = 0, 0
    for s in range(dp.S):
        t0 = int(dp.stage_t0[s])
        n_all = torch.tensor(cap, dtype=torch.int32, device=dev)
        scores, state = bound.stage(state, t0, t0 + dp.W, lane, xp, n_all)
        for label, live in [("all", cap), ("device n_valid", cap // 2 + 5),
                            ("host n_valid", cap // 3)]:
            rows = torch.where(lane < live, lane, cap)
            n_valid = {"all": None, "host n_valid": live}.get(
                label, torch.tensor(live, dtype=torch.int32, device=dev))
            args = (g, rows, scores, s, ex._eps_pos, ex._eps_neg, ex._col_valid)
            got = cascade_chunk_step(*args, n_valid=n_valid, block_n=ex.block_n)
            want = cascade_chunk_step_plain(*args, n_valid=n_valid)
            what = f"neural stage {s} {label}"
            check.equal("cascade_chunk_step", f"{what} g bits",
                        got[0].view(torch.int32), want[0].view(torch.int32))
            for k, (a, b) in enumerate(zip(got[1:], want[1:])):
                check.equal("cascade_chunk_step", f"{what} output {k + 1}", a, b)
            n_cases += 1
            if n_valid is None:
                exits += int((got[3] > 0).sum())
                g_next = got[0]
        g[:cap] = g_next
    log(f"[phase 4j] B2 step form == plain on the neural stages' own scores ({cap} rows, "
        f"W {dp.W}, {dp.S} stages, {n_cases} cases, {exits} exits over the stages)")
    return dict(cases=n_cases, exits=exits)


def check_neural_lane_step(check: Check, ex, x) -> dict:
    """Phase 4j: B6's step form against ``cascade_lane_step_plain`` on the
    streaming cut's own lane scores (W 2, 2 stages, the streaming executor
    ``ex``'s tables): a first lane step with every lane a rookie, then a
    second with the odd lanes a stage further on (their state and partial
    sums carried from the first) beside rookies, each decided by the
    wrapper and the plain version with every lane live, a device live
    count and a host one.  All six outputs equal, ``g`` by its bits."""
    import torch

    from repro_torch.kernels.cascade_kernel import cascade_lane_step, cascade_lane_step_plain

    bound, dp, dev = ex.scorer, ex.dplan, ex.device
    xp = bound.prepare(x)
    cap = xp.shape[0]
    lanes = torch.arange(cap, device=dev)
    n_all = torch.tensor(cap, dtype=torch.int32, device=dev)
    t0s = torch.as_tensor(dp.stage_t0, device=dev).to(torch.int32)
    zeros = torch.zeros(cap, dtype=torch.int32, device=dev)
    scores0, state = bound.lane_stage(bound.init_state(cap, dev), t0s[zeros.long()], lanes, xp,
                                      n_all)
    g0 = torch.full((cap,), -0.0, dtype=torch.float32, device=dev)
    for j in range(dp.W):
        g0 = g0 + scores0[:, j]
    stages = (lanes % 2).to(torch.int32)
    scores1, _ = bound.lane_stage(state, t0s[stages.long()], lanes, xp, n_all)
    gl = torch.where(stages > 0, g0, -0.0)
    n_cases = 0
    for step, (g, st, sc) in enumerate([(torch.full_like(g0, -0.0), zeros, scores0),
                                        (gl, stages, scores1)]):
        for label, n_valid in [("all", None),
                               ("device n_valid", torch.tensor(cap - 9, dtype=torch.int32,
                                                               device=dev)),
                               ("host n_valid", cap // 3)]:
            args = (g, sc.contiguous(), st, ex._eps_pos, ex._eps_neg, ex._col_valid)
            got = cascade_lane_step(*args, n_valid=n_valid, block_n=ex.block_n)
            want = cascade_lane_step_plain(*args, n_valid=n_valid)
            what = f"neural lane step {step} {label}"
            check.equal("cascade_lane", f"{what} g bits",
                        got[0].view(torch.int32), want[0].view(torch.int32))
            for k, (a, b) in enumerate(zip(got[1:], want[1:])):
                check.equal("cascade_lane", f"{what} output {k + 1}", a, b)
            n_cases += 1
    log(f"[phase 4j] B6 step form == plain on the streaming cut's own lane scores ({cap} "
        f"lanes, W {dp.W}, {dp.S} stages, rookies beside lanes a stage on; {n_cases} cases)")
    return dict(cases=n_cases)


def group_margins(F, rows, valid, k: int, W: int, S: int):
    """(G, S) f64 margins (the k-th minus the (k+1)-th best running sum of a
    group's documents at the end of each stage; +inf for a group of at
    most k) and (G,) the smallest gap between two of a group's running
    sums at any stage, from the (N, E) exit deltas ``F``."""
    import numpy as np

    G = rows.shape[0]
    margins = np.full((G, S), np.inf)
    gaps = np.full(G, np.inf)
    for s in range(S):
        c = F[:, : (s + 1) * W].sum(axis=1)
        for i in range(G):
            v = np.sort(c[rows[i][valid[i] != 0]])[::-1]
            if v.size > 1:
                gaps[i] = min(gaps[i], float(np.diff(-v).min()))
            if v.size > k:
                margins[i, s] = v[k - 1] - v[k]
    return margins, gaps


def neural_grouped(launches: dict, model, scorer, toks, F) -> dict:
    """Phase 4j: the state carry through the grouped loops on the streaming
    cut (8 layers, 4 exits, W 2: 2 stages).  ``NEURAL_GROUPS`` query groups
    of the test sequences (``F`` their exit deltas from ``exit_scores``),
    a margin threshold midway between the two middle first-stage margins
    (so that about half the groups exit at once), through
    ``run_grouped`` and ``run_stream_grouped`` (groups arriving at
    ``NEURAL_GROUP_ARRIVALS``): three runs captured (eager, captured,
    replayed) each equal to ``capture=False`` bit for bit and launching B8
    once a stage and once for the epilogue (batch) or once a step enqueued
    (streaming); the CPU and the streaming loop equal to the card's batch
    loop on every group outside the band (whose ranking or margin comes
    within it of a flip at some stage), margins within ``NEURAL_TOL``."""
    import numpy as np

    from repro_torch.core import CascadePlan
    from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan

    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(model, chunk_t=NEURAL_CHUNK_T))
    S, W, k = dplan.S, dplan.W, NEURAL_K
    G, B = NEURAL_GROUPS, NEURAL_GROUP_B
    rows = np.arange(G * B).reshape(G, B)
    sizes = np.full(G, B)
    sizes[0] = k
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    x = toks[: G * B]
    margins, gaps = group_margins(np.asarray(F[: G * B], np.float64), rows, valid, k, W, S)
    m0 = np.sort(margins[sizes > k, 0])
    eps = np.float32((m0[m0.size // 2 - 1] + m0[m0.size // 2]) / 2)
    eps_g = np.full(S, eps, dtype=np.float32)
    scale = max(1.0, float(np.abs(np.cumsum(F[: G * B], axis=1)).max()))
    band = NEURAL_BAND * scale
    near = (gaps <= band) | (np.abs(margins - eps).min(axis=1) <= band)
    arrivals = np.array(NEURAL_GROUP_ARRIVALS)

    def executor(device, capture=True):
        return DeviceExecutor(dplan, scorer.bind(dplan, device=device), device=device,
                              capture=capture)

    def exact(what, a, b):
        for f in ("verdicts", "exit_stage", "admit_step", "done_step", "occupancy"):
            if hasattr(a, f) and not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{what}: {f} differ")
        if not np.array_equal(a.margin.view(np.int32), b.margin.view(np.int32)):
            raise AssertionError(f"{what}: margin bits differ")
        for f in ("chunk_stats", "scores_computed", "scores_possible", "steps_run",
                  "steps_enqueued", "syncs"):
            if getattr(a, f, None) != getattr(b, f, None):
                raise AssertionError(f"{what}: {f} differ")

    def outside_band(what, a, b):
        diff = (a.exit_stage != b.exit_stage) | (a.verdicts != b.verdicts).any(axis=1)
        if (diff & ~near).any():
            raise AssertionError(f"{what}: groups {np.flatnonzero(diff & ~near)} differ "
                                 "outside the band")
        fin = np.isfinite(a.margin) & ~near
        err = np.abs(a.margin[fin].astype(np.float64) - b.margin[fin])
        if fin.any() and not err.max() <= NEURAL_TOL * scale:
            raise AssertionError(f"{what}: margins differ by {err.max()}")
        return int(diff.sum())

    out: dict = {"groups": G, "bucket": B, "k": k, "eps_g": float(eps),
                 "band_groups": int(near.sum())}
    res = {}
    for loop, path, kw in (("run_grouped", "neural_grouped", {}),
                           ("run_stream_grouped", "neural_stream_grouped",
                            dict(arrivals=arrivals))):
        def call(ex):
            return getattr(ex, loop)(x, rows, valid, G, eps_g, k, **kw)

        ex, twin = executor("cuda"), executor("cuda", capture=False)
        runs = [counted(launches, f"{path}/run{i}", lambda: call(ex)) for i in range(3)]
        eager = counted(launches, f"{path}/eager", lambda: call(twin))
        n_b8 = S + 1 if loop == "run_grouped" else eager.steps_enqueued
        for p in [f"{path}/run{i}" for i in range(3)] + [f"{path}/eager"]:
            if launches[p] != {"cascade_group": n_b8}:
                raise AssertionError(f"{p}: launched {launches[p]}, expected B8 {n_b8} times")
        for i, r in enumerate(runs):
            exact(f"{path} run {i} vs capture=False", r, eager)
        if not (ex.traces == twin.traces == len(ex._graphs) == 1 and not twin._graphs):
            raise AssertionError(f"{path}: traces {ex.traces} / {twin.traces}, graphs "
                                 f"{len(ex._graphs)} / {len(twin._graphs)}, expected 1")
        t = time.perf_counter()
        cpu = call(executor("cpu"))
        cpu_s = time.perf_counter() - t
        res[loop] = eager
        if not (1 in eager.exit_stage and S in eager.exit_stage):
            raise AssertionError(f"{path}: exit stages {eager.exit_stage}, expected 1 and {S}")
        moved = outside_band(f"{path} card vs CPU", eager, cpu)
        out[loop] = dict(b8_launches=n_b8, exit_stage=eager.exit_stage.tolist(),
                         moved_vs_cpu=moved, cpu_s=cpu_s,
                         steps_enqueued=getattr(eager, "steps_enqueued", None))
        log(f"[phase 4j] {loop} on the cut: {G} groups of up to {B} sequences, k {k}, eps_g "
            f"{eps:.4g}: exit stages {eager.exit_stage.tolist()}, B8 {n_b8} launches a run; "
            f"eager, captured and replayed == capture=False; card vs CPU: {moved} groups "
            f"differ, {int(near.sum())} in the band (CPU in {cpu_s:.1f}s)")
    st = res["run_stream_grouped"]
    if not (st.admit_step > 0).any():
        raise AssertionError("neural_stream_grouped: no group joined a later step")
    out["stream_moved_vs_batch"] = outside_band(
        "neural_stream_grouped vs run_grouped", st, res["run_grouped"])
    return out


def _layer_slice(layers: dict, n: int) -> dict:
    """The first ``n`` layers of leading-L stacked layer params (views)."""
    return {k: _layer_slice(v, n) if isinstance(v, dict) else v[:n] for k, v in layers.items()}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


class MoEProbe:
    """Phase 4k: while active, records what each MoE call's routing did
    (``models.moe.route`` on the call's own input, beside the call): the
    (token, slot) assignments and those the capacity dropped, the tokens
    whose k-th and (k+1)-th router probabilities lie within
    ``FAMILY_ROUTE_TIE`` (where the card's and the CPU's sums may route a
    token apart), and with ``routes`` each call's expert ids.  It reads its
    counts back after each call: eager runs only."""

    def __init__(self, routes: bool = False):
        self.assigned = self.dropped = 0
        # the same over live tokens only: a retired lane's state is zero,
        # and so is its normed FFN input (no live token's is)
        self.live_assigned = self.live_dropped = 0
        self.ties: list = []  # per call: the near-tie tokens' flat ids
        self.routes: list | None = [] if routes else None  # per call: (n, k) expert ids

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._apply = apply = moe.apply_moe

        def probed(p, x, cfg):
            probs, _, topi, pos, cap = moe.route(p["router"], x.reshape(-1, x.shape[-1]), cfg)
            top = torch.sort(probs, dim=-1, descending=True).values
            near = top[:, cfg.top_k - 1] - top[:, cfg.top_k] <= FAMILY_ROUTE_TIE
            drop = pos >= cap
            live = x.reshape(-1, x.shape[-1]).abs().amax(-1) > 0
            self.assigned += pos.numel()
            self.dropped += int(drop.sum())
            self.live_assigned += int(live.sum()) * pos.shape[1]
            self.live_dropped += int(drop[live].sum())
            self.ties.append(torch.nonzero(near).flatten().cpu().numpy())
            if self.routes is not None:
                self.routes.append(topi.cpu().numpy())
            return apply(p, x, cfg)

        moe.apply_moe = probed
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe

        moe.apply_moe = self._apply

    @property
    def drop_share(self) -> float:
        return self.dropped / max(self.assigned, 1)

    @property
    def live_drop_share(self) -> float:
        return self.live_dropped / max(self.live_assigned, 1)

    @property
    def n_ties(self) -> int:
        return int(sum(t.size for t in self.ties))

    def flips(self, other: "MoEProbe") -> list:
        """Per call, the tokens that ``other`` (the same calls on another
        device) routed to other experts; each must be a near tie of one
        of the two runs, else the routing itself differs."""
        import numpy as np

        if len(self.routes) != len(other.routes):
            raise AssertionError(f"{len(self.routes)} MoE calls against {len(other.routes)}")
        out = []
        for a, b, ta, tb in zip(self.routes, other.routes, self.ties, other.ties):
            ids = np.flatnonzero((a != b).any(axis=1))
            if not np.isin(ids, np.union1d(ta, tb)).all():
                raise AssertionError(f"tokens {ids[~np.isin(ids, np.union1d(ta, tb))][:8]} "
                                     "routed apart without a near tie")
            out.append(ids)
        return out


def first_row(ids_per_call: list, seq: int, n_rows: int) -> int:
    """The first row (of ``seq`` tokens) holding one of the tokens of any
    call, or ``n_rows`` without one: a MoE call's rows before a token that
    routed apart see the same queue places."""
    return min([int(ids[0]) // seq for ids in ids_per_call if ids.size] + [n_rows])


def family_served(launches: dict, cfg, params, calib, test, path: str) -> dict:
    """Phase 4k, one family at full widths: ``api.fit(NeuralScorer)`` on the
    calibration sequences (``exit_scores``: a MoE layer over every row in
    one call), then the test sequences through ``QWYCServer(scorer=
    NeuralScorer)`` at batch ``NEURAL_BATCH``, captured and ``capture=
    False`` (equal in every result, B2's step form once a stage of every
    flush), the mean layers paid below the depth, the flush walls (captured,
    eager, and a full-depth ``exit_scores`` of the same rows) and the layers
    the timed flush's rows paid.  With a MoE FFN, the share of (token, slot)
    assignments the capacity dropped in the calibration and in one eager
    flush.  Returns the numbers and, under ``"ctx"``, what the family's
    other checks read."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import evaluate_cascade
    from repro_torch.core.early_exit import exit_scores
    from repro_torch.serving.engine import QWYCServer

    scorer = api.NeuralScorer(params, cfg, seq_len=NEURAL_SEQ)
    E, k = scorer.n_exits, cfg.exit_interval
    probe = MoEProbe()
    t = time.perf_counter()
    with probe:
        fitted = counted(launches, f"family_scores/{path}_calibration", lambda: api.fit(
            scorer, calib, alpha=NEURAL_ALPHA, chunk_t=NEURAL_CHUNK_T))
    calib_s = time.perf_counter() - t
    m = fitted.model
    if not (np.array_equal(m.order, np.arange(E)) and np.all(m.costs == k)):
        raise AssertionError(f"{path} fit: order {m.order}, costs {m.costs}")
    ev_calib = evaluate_cascade(m, fitted.calibration_scores)
    if ev_calib["diff_rate"] > NEURAL_ALPHA:
        raise AssertionError(f"{path} fit: calibration disagreement {ev_calib['diff_rate']} > "
                             f"alpha {NEURAL_ALPHA}")
    out: dict = dict(n_exits=E, calibration_rows=len(calib), calibration_s=calib_s,
                     calib_diff_rate=ev_calib["diff_rate"],
                     calib_mean_layers=ev_calib["mean_cost"])
    if cfg.n_experts:
        out["calib_dropped_share"] = probe.drop_share
    log(f"[phase 4k] {path}: calibration over {calib.shape} tokens and the fit in "
        f"{calib_s:.1f}s; calibration mean layers {ev_calib['mean_cost']:.2f}/{cfg.n_layers}, "
        f"disagreement {ev_calib['diff_rate']:.4f} <= alpha {NEURAL_ALPHA}"
        + (f"; capacity dropped {probe.dropped} of {probe.assigned} (token, slot) assignments "
           f"({probe.drop_share:.5f})" if cfg.n_experts else ""))

    def batch_server(**kw):
        return QWYCServer(m, scorer=scorer, backend="kernel", batch_size=NEURAL_BATCH,
                          chunk_t=NEURAL_CHUNK_T, device="cuda", **kw)

    t = time.perf_counter()
    srv = batch_server()
    res = counted(launches, path, lambda: serve(srv, test))
    twin = batch_server(backend_opts={"capture": False})
    eager_twin(launches, path, srv, res, twin, lambda x: serve(x, test))
    serve_s = time.perf_counter() - t
    n_flush, S = srv.stats.n_batches, srv._dev[0].dplan.S
    b2 = launches[path].get("cascade_chunk_step", 0)
    if b2 != n_flush * S:
        raise AssertionError(f"{path}: {b2} B2 launches over {n_flush} flushes of {S} stages")
    got = _verdicts(res)
    layers = float(got[1].mean()) * k
    if not layers < cfg.n_layers:
        raise AssertionError(f"{path}: mean layers paid {layers} not below {cfg.n_layers}")
    stages_live = [len(r.chunk_stats) for r in srv.flush_results]
    log(f"[phase 4k] {path}: served {len(test)} sequences in {n_flush} flushes of batch "
        f"{NEURAL_BATCH} (one CUDA graph == capture=False) in {serve_s:.1f}s: mean layers paid "
        f"{layers:.2f}/{cfg.n_layers}; B2 {b2} launches = {n_flush} flushes x {S} stages "
        f"(stages with live rows {stages_live})")
    out.update(flushes=n_flush, stages=S, b2_launches=b2, mean_layers=layers, serve_s=serve_s,
               stages_with_live_rows=stages_live)

    x = test[:NEURAL_BATCH]
    x_dev = torch.from_numpy(x).cuda()
    ex_cap, ex_eager = srv._dev[0], twin._dev[0]
    flush_ms = wall_ms(lambda: ex_cap.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH), reps=3)
    eager_ms = wall_ms(lambda: ex_eager.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH), reps=2)
    full_ms = counted(launches, f"family_scores/{path}_full_depth",
                      lambda: wall_ms(lambda: exit_scores(params, cfg, x_dev), reps=2))
    probe = MoEProbe()
    with probe:
        flush_res = ex_eager.run(x, NEURAL_BATCH, capacity=NEURAL_BATCH)
    paid = float(flush_res.exit_step.mean()) * k
    log(f"[phase 4k] {path}: batch {NEURAL_BATCH} x {NEURAL_SEQ} tokens: captured flush "
        f"{flush_ms:.1f} ms, eager flush {eager_ms:.1f} ms, full-depth exit_scores "
        f"{full_ms:.1f} ms (the flush's rows paid {paid:.2f} of {cfg.n_layers} layers; every "
        f"stage runs at the full capacity)"
        + (f"; capacity dropped {probe.dropped} of {probe.assigned} assignments in one eager "
           f"flush ({probe.drop_share:.5f}), {probe.live_dropped} of the live tokens' "
           f"{probe.live_assigned} ({probe.live_drop_share:.5f})" if cfg.n_experts else ""))
    out.update(flush_ms=flush_ms, eager_flush_ms=eager_ms, full_depth_ms=full_ms,
               flush_layers_paid=paid)
    if cfg.n_experts:
        out.update(flush_dropped_share=probe.drop_share,
                   flush_live_dropped_share=probe.live_drop_share)
    out["ctx"] = dict(scorer=scorer, fitted=fitted, res=res)
    return out


def family_moe(launches: dict, card: str) -> dict:
    """Phase 4k: Qwen3-MoE-30B-A3B at its published widths, cut to
    ``FAMILY_MOE_LAYERS`` layers (exits every 2 layers, W 2): the calibration
    in one MoE call a layer, the fit and the batch server (``family_served``);
    the full-depth verdicts of each flush's rows (one 64-row call) beside the
    served ones; an 8-layer cut streamed through ``StreamingServer`` (B6 once
    a step enqueued), captured == ``capture=False``; and a 2-layer cut (an
    exit after each layer) through the batch loop at cap ``FAMILY_CPU_ROWS``
    on the card and on the CPU, equal outside the band on the rows before
    the first token whose routing may flip (counted)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core.early_exit import exit_scores
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import StreamingServer

    torch.cuda.reset_peak_memory_stats()
    t_fam = time.perf_counter()
    cfg = get_config("qwen3-moe-30b-a3b").scaled(n_layers=FAMILY_MOE_LAYERS, exit_interval=2)
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(FAMILY_SEED),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    log(f"[phase 4k] {cfg.name}: {cfg.n_layers} of 48 layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.moe_d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_layers // cfg.exit_interval} exits; {n_params / 1e9:.3f}e9 f32 "
        f"weights drawn on the card in {time.perf_counter() - t:.1f}s")
    toks = np.random.default_rng(FAMILY_SEED + 1).integers(
        0, cfg.vocab_size, size=(FAMILY_MOE_CALIB + FAMILY_TEST, NEURAL_SEQ))
    calib, test = toks[:FAMILY_MOE_CALIB], toks[FAMILY_MOE_CALIB:]
    out = family_served(launches, cfg, params, calib, test, "moe_batch")
    ctx = out.pop("ctx")
    m, fitted = ctx["fitted"].model, ctx["fitted"]

    # each flush's full-depth verdicts at the flush's own call shape (one
    # 64-row call a layer); the served verdicts differ where a later stage's
    # smaller live set moved a token's place in an expert's queue
    S_flush = counted(launches, "family_scores/moe_flush_full_depth", lambda: torch.cat([
        exit_scores(params, cfg, test[i : i + NEURAL_BATCH])
        for i in range(0, len(test), NEURAL_BATCH)]))
    got = _verdicts(ctx["res"])
    full = (S_flush[:, -1] >= m.beta).cpu().numpy()
    out["diff_vs_full_depth"] = float((got[0] != full).mean())
    log(f"[phase 4k] moe_batch: served verdicts differ from each flush's full-depth verdicts "
        f"on {out['diff_vs_full_depth']:.4f} of the rows (alpha {NEURAL_ALPHA})")

    # the streaming cut: the first FAMILY_STREAM_LAYERS layers and their
    # exits, fit on the full calibration's first columns (the same call)
    cut = FAMILY_STREAM_LAYERS
    E8 = cut // cfg.exit_interval
    cfg8 = cfg.scaled(n_layers=cut)
    params8 = {**params, "exit_heads": params["exit_heads"][:E8],
               "layers": _layer_slice(params["layers"], cut)}
    sc8 = api.NeuralScorer(params8, cfg8, seq_len=NEURAL_SEQ)
    m8 = api.fit(fitted.calibration_scores[:, :E8], alpha=NEURAL_ALPHA,
                 chunk_t=NEURAL_CHUNK_T, **sc8.fit_overrides()).model
    rows = test[:FAMILY_STREAM_ROWS]
    arr = poisson_arrivals(len(rows), NEURAL_STREAM_RATE)

    def stream_server(**kw):
        return StreamingServer(m8, scorer=sc8, batch_size=NEURAL_BATCH, window=NEURAL_WINDOW,
                               chunk_t=NEURAL_CHUNK_T, device="cuda", **kw)

    t = time.perf_counter()
    ss = stream_server()
    sres = counted(launches, "moe_stream", lambda: stream_serve(ss, rows, arr))
    eager_twin(launches, "moe_stream", ss, sres, stream_server(backend_opts={"capture": False}),
               lambda x: stream_serve(x, rows, arr))
    stream_s = time.perf_counter() - t
    enq = sum(r.steps_enqueued for r in ss.stream_results)
    steps = sum(r.steps_run for r in ss.stream_results)
    b6 = launches["moe_stream"].get("cascade_lane", 0)
    if b6 != enq:
        raise AssertionError(f"moe_stream: {b6} B6 launches, {enq} steps enqueued")
    log(f"[phase 4k] moe_stream ({cut} layers, {E8} exits): {len(rows)} sequences at "
        f"{NEURAL_STREAM_RATE}/step through {NEURAL_BATCH} lanes in {len(ss.stream_results)} "
        f"waves, {steps} steps run, {enq} enqueued, B6 {b6} launches (one a step enqueued), "
        f"one CUDA graph == capture=False, in {stream_s:.1f}s; mean layers paid "
        f"{ss.stats.models_evaluated / ss.stats.n_requests * cfg.exit_interval:.2f}/{cut}")
    out.update(stream_rows=len(rows), stream_waves=len(ss.stream_results), stream_steps=steps,
               stream_enqueued=enq, b6_launches=b6, stream_s=stream_s)
    del ss, sres, sc8, params8

    out["cpu_cut"] = family_moe_cpu_cut(launches, cfg, params, calib, test)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_fam
    log(f"[phase 4k] {card}: {cfg.name} cut: torch.cuda.max_memory_allocated "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB; {out['phase_s']:.1f}s")
    return out


def family_moe_cpu_cut(launches: dict, cfg, params, calib, test) -> dict:
    """Phase 4k: the Qwen3-MoE cut's first 2 layers at full widths, an exit
    after each (one stage of W 2), fit on ``exit_scores`` of the calibration
    rows (one call), then ``FAMILY_CPU_ROWS`` test sequences through the
    batch loop at that capacity on the card (B2's step form once) and on
    the CPU (TF32 off).  Both runs' routing is probed: every token the two
    route apart must be a near tie (its k-th and (k+1)-th router
    probabilities within ``FAMILY_ROUTE_TIE``), and on the rows before the
    first such token (every row without one) the verdicts are equal
    outside the band and ``g_final`` within ``NEURAL_TOL``."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import CascadePlan
    from repro_torch.core.early_exit import exit_deltas, exit_scores
    from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan

    cfg2 = cfg.scaled(n_layers=2, exit_interval=1)
    p2 = {**params, "exit_heads": params["exit_heads"][:2],
          "layers": _layer_slice(params["layers"], 2)}
    sc2 = api.NeuralScorer(p2, cfg2, seq_len=NEURAL_SEQ)
    S_cal = counted(launches, "family_scores/moe_cut2_calibration",
                    lambda: exit_scores(p2, cfg2, calib))
    m2 = api.fit(exit_deltas(S_cal), alpha=NEURAL_ALPHA, chunk_t=NEURAL_CHUNK_T,
                 **sc2.fit_overrides()).model
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m2, chunk_t=NEURAL_CHUNK_T))
    rows = test[:FAMILY_CPU_ROWS]
    n = len(rows)
    ex = DeviceExecutor(dplan, sc2.bind(dplan, device="cuda"), block_n=n, device="cuda",
                        capture=False)
    on_card = MoEProbe(routes=True)
    with on_card:
        card = counted(launches, "moe_batch/cut2", lambda: ex.run(rows, n, capacity=n))
    t = time.perf_counter()
    sc_cpu = api.NeuralScorer(_to_cpu(p2), cfg2, seq_len=NEURAL_SEQ)
    on_cpu = MoEProbe(routes=True)
    with on_cpu:
        cpu = DeviceExecutor(dplan, sc_cpu.bind(dplan, device="cpu"), block_n=n,
                             device="cpu").run(rows, n, capacity=n)
    cpu_s = time.perf_counter() - t
    flips = on_card.flips(on_cpu)
    ok = np.arange(n) < first_row(flips, NEURAL_SEQ, n)
    # the stage runs every row in one call, as exit_scores over the rows does
    near = _near_band(m2, exit_deltas(counted(launches, "family_scores/moe_cut2_test",
                                              lambda: exit_scores(p2, cfg2, rows))))
    diff = (card.decisions != cpu.decisions) | (card.exit_step != cpu.exit_step)
    if (diff & ok & ~near).any():
        raise AssertionError(f"moe cut2 card vs CPU: rows {np.flatnonzero(diff & ok & ~near)} "
                             "differ outside the band before the first token routed apart")
    scale = max(1.0, float(np.abs(cpu.g_final).max()))
    err = np.abs(card.g_final.astype(np.float64) - cpu.g_final)
    checked = float(err[ok].max()) if ok.any() else 0.0
    if not checked <= NEURAL_TOL * scale:
        raise AssertionError(f"moe cut2 card vs CPU: g_final differs by {checked}")
    n_flips = int(sum(f.size for f in flips))
    log(f"[phase 4k] moe 2-layer cut at full widths, {n} sequences at cap {n} (one stage, W "
        f"{dplan.W}): card vs CPU batch loop over {len(flips)} MoE calls: {on_cpu.n_ties} "
        f"near-tie tokens (router gap <= {FAMILY_ROUTE_TIE}), {n_flips} routed apart, rows "
        f"checked {int(ok.sum())}/{n}; {int(diff.sum())} verdicts differ ({int(near.sum())} "
        f"rows in the band), g_final max abs err {float(err.max()):.3g} (checked rows "
        f"{checked:.3g} <= {NEURAL_TOL * scale:.3g}); capacity dropped "
        f"{on_cpu.drop_share:.5f}; CPU in {cpu_s:.1f}s")
    return dict(rows=n, near_tie_tokens=on_cpu.n_ties, routed_apart=n_flips,
                rows_checked=int(ok.sum()), verdicts_differ=int(diff.sum()),
                band_rows=int(near.sum()), g_max_abs_err=float(err.max()), cpu_s=cpu_s,
                dropped_share=on_cpu.drop_share)


def family_rwkv(launches: dict, card: str) -> dict:
    """Phase 4k: RWKV6-1.6B whole (24 layers, exits every 2: W 2, 6
    stages): the calibration, fit and batch server (``family_served``); the
    served verdicts equal ``evaluate_cascade`` on the test exit scores
    outside the band (rows are independent here); and a 2-layer cut's exit
    scores on the card within ``NEURAL_TOL`` of the CPU's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import evaluate_cascade
    from repro_torch.core.early_exit import exit_deltas, exit_scores
    from repro_torch.models.transformer import init_params

    torch.cuda.reset_peak_memory_stats()
    t_fam = time.perf_counter()
    cfg = get_config("rwkv6-1.6b").scaled(exit_interval=2)
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(FAMILY_SEED + 2),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    log(f"[phase 4k] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.rnn_heads} heads of {cfg.d_model // cfg.rnn_heads}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers // cfg.exit_interval} exits; {n_params / 1e9:.3f}e9 f32 weights drawn "
        f"on the card in {time.perf_counter() - t:.1f}s")
    toks = np.random.default_rng(FAMILY_SEED + 3).integers(
        0, cfg.vocab_size, size=(FAMILY_RWKV_CALIB + FAMILY_TEST, NEURAL_SEQ))
    calib, test = toks[:FAMILY_RWKV_CALIB], toks[FAMILY_RWKV_CALIB:]
    out = family_served(launches, cfg, params, calib, test, "rwkv_batch")
    ctx = out.pop("ctx")
    m = ctx["fitted"].model
    S_test = counted(launches, "family_scores/rwkv_test", lambda: exit_scores(params, cfg, test))
    F_test = exit_deltas(S_test)
    ev = evaluate_cascade(m, F_test)
    near = _near_band(m, F_test)
    moved = _agree("rwkv_batch vs evaluate_cascade", _verdicts(ctx["res"]),
                   (ev["decisions"], ev["exit_step"]), near)
    log(f"[phase 4k] rwkv_batch: {moved} verdicts moved vs evaluate_cascade on the test exit "
        f"scores, {int(near.sum())} rows in the band")
    out.update(moved_vs_oracle=moved, band_rows=int(near.sum()))
    out["cpu_cut"] = family_cut_vs_cpu(cfg.scaled(n_layers=2), {
        **params, "exit_heads": params["exit_heads"][:1],
        "layers": _layer_slice(params["layers"], 2)}, test[:FAMILY_CPU_ROWS])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_fam
    log(f"[phase 4k] {card}: {cfg.name}: torch.cuda.max_memory_allocated "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB; {out['phase_s']:.1f}s")
    return out


def family_cut_vs_cpu(cfg, params, rows, frontend=None) -> dict:
    """Phase 4k: ``exit_scores`` of a cut on the card and on the CPU (TF32
    off), held within ``NEURAL_TOL * max(1, max|cpu|)`` on the rows before
    the first token the two route apart (every row for a dense stack, or
    without one); such a token must be a near tie (``MoEProbe.flips``)."""
    import numpy as np
    import torch

    from repro_torch.core.early_exit import exit_scores

    card_probe, cpu_probe = MoEProbe(routes=True), MoEProbe(routes=True)
    with card_probe:
        on_card = exit_scores(params, cfg, rows, frontend=frontend).cpu()
    t = time.perf_counter()
    with cpu_probe:
        on_cpu = exit_scores(_to_cpu(params), cfg, rows,
                             frontend=None if frontend is None else frontend.cpu())
    cpu_s = time.perf_counter() - t
    seq = rows.shape[1] + (0 if frontend is None else frontend.shape[1])
    flips = card_probe.flips(cpu_probe)
    ok = torch.arange(len(rows)) < first_row(flips, seq, len(rows))
    err = (on_card - on_cpu).abs()
    checked = float(err[ok].max()) if ok.any() else 0.0
    bound = NEURAL_TOL * max(1.0, float(on_cpu.abs().max()))
    if not (torch.isfinite(on_card).all() and checked <= bound):
        raise AssertionError(f"{cfg.name} {cfg.n_layers}-layer cut: card vs CPU exit scores max "
                             f"abs err {checked} > {bound}")
    n_flips = int(sum(f.size for f in flips))
    log(f"[phase 4k] {cfg.name} {cfg.n_layers}-layer cut ({''.join(cfg.layer_kinds())}) at full "
        f"widths, {len(rows)} sequences of {seq}: exit scores card vs CPU max abs err "
        f"{float(err.max()):.3g} (rows checked {int(ok.sum())}/{len(rows)}: {checked:.3g} <= "
        f"{bound:.3g}); {len(flips)} MoE calls, {cpu_probe.n_ties} near-tie tokens, {n_flips} "
        f"routed apart; CPU in {cpu_s:.1f}s")
    return dict(layers=cfg.n_layers, kinds="".join(cfg.layer_kinds()), rows=len(rows), seq=seq,
                max_abs_err=float(err.max()), checked_err=checked, bound=bound,
                rows_checked=int(ok.sum()), near_tie_tokens=cpu_probe.n_ties,
                routed_apart=n_flips, cpu_s=cpu_s)


def family_cuts(launches: dict) -> dict:
    """Phase 4k: the other families at full widths, cut to
    ``FAMILY_CUTS`` layers (an exit after each), weights drawn on the card:
    DeepSeek-V2-Lite (MLA, a dense first layer, 64 routed + 2 shared
    experts top-6), RecurrentGemma-2B (R, R, L: the hybrid loop),
    gemma2-2B (L, G, softcaps) and musicgen-large (its 64 frontend
    embeddings prepended), ``exit_scores`` card against CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    out = {}
    for i, (name, n_layers) in enumerate(FAMILY_CUTS.items()):
        cfg = get_config(name).scaled(n_layers=n_layers, exit_interval=1)
        gen = torch.Generator(device="cuda").manual_seed(FAMILY_SEED + 10 + i)
        params = init_params(cfg, gen, device="cuda")
        rng = np.random.default_rng(FAMILY_SEED + 10 + i)
        rows = rng.integers(0, cfg.vocab_size, size=(FAMILY_CPU_ROWS, NEURAL_SEQ))
        front = None
        if cfg.n_frontend_tokens:
            front = torch.randn((FAMILY_CPU_ROWS, cfg.n_frontend_tokens, cfg.d_model),
                                generator=gen, device="cuda")
        out[name] = counted(launches, f"family_scores/{name}",
                            lambda: family_cut_vs_cpu(cfg, params, rows, front))
        del params, front
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_families(report: dict, launches: dict) -> dict:
    """Phase 4k: the neural depth cascade over the other model families
    (``family_moe``, ``family_rwkv``, ``family_cuts``), the card's memory
    released between them."""
    import gc

    import torch

    card = report["card"]
    out: dict = {"card": card}
    for key, fn in (("moe", lambda: family_moe(launches, card)),
                    ("rwkv6", lambda: family_rwkv(launches, card)),
                    ("cuts", lambda: family_cuts(launches))):
        out[key] = fn()
        gc.collect()
        torch.cuda.empty_cache()
    report["families"] = out
    return out


def _decode(params, cfg, batch: dict, cache, steps: int, feed=None):
    """Phase 4l: ``make_prefill_step`` over ``batch``, then ``steps``
    ``make_decode_step`` calls, each fed ``feed[:, t]`` or, without
    ``feed``, the greedy token of the logits before it -> (logits (B,
    steps + 1, V): the prefill's last position, then each step's; the
    tokens fed (B, steps); the cache; the prefill's wall and each step's,
    in seconds, each ended by a synchronise)."""
    import torch

    from repro_torch.models import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = prefill(params, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    pos = batch["tokens"].shape[1] + (batch["frontend"].shape[1] if "frontend" in batch else 0)
    logits, fed, walls = [lg[:, 0]], [], []
    for i in range(steps):
        tok = feed[:, i:i + 1] if feed is not None else logits[-1].argmax(-1, keepdim=True)
        t = time.perf_counter()
        lg, cache = decode(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        fed.append(tok)
        logits.append(lg[:, 0])
    return torch.stack(logits, 1), torch.cat(fed, 1), cache, prefill_s, walls


def device_breakdown(work: dict, wall_s: float, top: int = 6) -> dict:
    """A profiled window's ``device_work`` against its unprofiled wall:
    device ms, kernel launches, the busy share and the ``top`` kernels by
    device time (name, ms, launches)."""
    dev_us = sum(us for us, _ in work.values())
    ranked = sorted(work.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(device_ms=dev_us / 1e3, launches=sum(n for _, n in work.values()),
                busy_share=dev_us / 1e6 / wall_s,
                top=[(name[:80], us / 1e3, n) for name, (us, n) in ranked])


def _fmt_breakdown(b: dict) -> str:
    return (f"device {b['device_ms']:.2f} ms over {b['launches']} launches, busy "
            f"{100 * b['busy_share']:.1f} %; top: "
            + "; ".join(f"{name} {ms:.2f} ms x{n}" for name, ms, n in b["top"][:4]))


def _moe_first_row(probe_card, probe_cpu, rows: int) -> int:
    """The first row that a token routed apart on the card and the CPU can
    touch (a MoE call's rows from the first such token on see other queue
    places; a decode step's call holds one token a row), or ``rows``."""
    first = rows
    for ids, calls in zip(probe_card.flips(probe_cpu), probe_card.routes):
        if ids.size:
            first = min(first, int(ids[0]) // (calls.shape[0] // rows))
    return first


def decode_cut_vs_cpu(name: str, n_layers: int, edit: dict) -> dict:
    """Phase 4l: a cut of ``name`` at its published widths, weights drawn
    on the card (the seed from the name, so the two DeepSeek cuts share
    theirs), prefill plus ``DECODE_CUT_STEPS`` decode steps of the
    stream's next tokens on the card and on the CPU (f32 caches, TF32
    off): every step's logits and every returned cache leaf within
    ``NEURAL_TOL * max(1, max|cpu|)`` on the rows before the first token
    the two route apart (every row without one)."""
    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.tree import flatten

    cfg = get_config(name).scaled(n_layers=n_layers, **edit)
    seed = DECODE_SEED + 10 + sorted(ARCHS).index(name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    rows, n = DECODE_CUT_ROWS, DECODE_CUT_PROMPT
    stream = TokenStream(cfg.vocab_size, seed=seed).sample(rows, n + DECODE_CUT_STEPS)
    batch = {"tokens": torch.from_numpy(stream[:, :n]).cuda()}
    if cfg.n_frontend_tokens:
        batch["frontend"] = torch.randn((rows, cfg.n_frontend_tokens, cfg.d_model),
                                        generator=gen, device="cuda")
    seq = n + cfg.n_frontend_tokens + DECODE_CUT_STEPS
    feed = torch.from_numpy(stream[:, n:])
    out = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to_cpu(params)
        probe = MoEProbe(routes=True)
        t = time.perf_counter()
        with probe:
            lg, _, cache, _, _ = _decode(p, cfg, {k: v.to(dev) for k, v in batch.items()},
                                         init_cache(cfg, rows, seq, torch.float32, device=dev),
                                         DECODE_CUT_STEPS, feed.to(dev))
        out[dev] = (lg.cpu(), _to_cpu(cache), probe, time.perf_counter() - t)
        del p
    (lg, cache, probe, card_s), (want, cache_cpu, probe_cpu, cpu_s) = out["cuda"], out["cpu"]
    ok = _moe_first_row(probe, probe_cpu, rows)
    bound = NEURAL_TOL * max(1.0, float(want.abs().max()))
    err = float((lg[:ok] - want[:ok]).abs().max()) if ok else 0.0
    if not (torch.isfinite(lg).all() and err <= bound):
        raise AssertionError(f"decode {cfg.name} {n_layers}-layer cut {edit}: card vs CPU "
                             f"logits max abs err {err} > {bound} (rows {ok}/{rows})")
    leaf_err = 0.0
    if ok == rows:
        for (path, a), (_, b) in zip(flatten(cache), flatten(cache_cpu)):
            if a.is_floating_point():
                e = float((a.float() - b.float()).abs().max())
                leaf_err = max(leaf_err, e)
                if e > NEURAL_TOL * max(1.0, float(b.float().abs().max())):
                    raise AssertionError(f"decode {cfg.name} cut: cache leaf {path} err {e}")
            elif not torch.equal(a, b):
                raise AssertionError(f"decode {cfg.name} cut: cache leaf {path} differs")
    n_flips = int(sum(f.size for f in probe.flips(probe_cpu)))
    log(f"[phase 4l] {cfg.name} {n_layers}-layer cut ({''.join(cfg.layer_kinds())}"
        f"{', mla_absorb' if cfg.mla_absorb else ''}) at full widths, {rows} x "
        f"({cfg.n_frontend_tokens} + {n}) prefill + {DECODE_CUT_STEPS} steps: logits card vs "
        f"CPU max abs err {err:.3g} <= {bound:.3g} (rows {ok}/{rows}), cache leaves "
        f"{leaf_err:.3g}; {len(probe.routes)} MoE calls, {probe_cpu.n_ties} near ties, "
        f"{n_flips} routed apart; card {card_s:.1f}s, CPU {cpu_s:.1f}s")
    return dict(layers=n_layers, kinds="".join(cfg.layer_kinds()), mla_absorb=cfg.mla_absorb,
                rows_checked=ok, max_abs_err=err, bound=bound, cache_err=leaf_err,
                routed_apart=n_flips, near_ties=probe_cpu.n_ties, card_s=card_s, cpu_s=cpu_s)


def phase_decode(report: dict, launches: dict) -> dict:
    """Phase 4l: decode at Qwen3-1.7B's published widths (28 layers,
    d_model 2048, 16 / 8 heads of 128, d_ff 6144, vocab 151936), random f32
    weights drawn on the card from ``DECODE_SEED``: 8 prompts of 512 tokens
    of the seed's ``TokenStream``, ``make_prefill_step`` into an f32
    ``init_cache`` of 544 positions, then 32 greedy ``make_decode_step``
    calls.  Every step's logits (and the prefill's last) within
    ``DECODE_TOL * max|full|`` of the cache-less ``forward(serve=True)``
    over the 544 tokens (causal: position p sees the tokens so far), each
    greedy token equal to that forward's argmax wherever its top-2 gap
    exceeds twice that; the same tokens through a bf16 cache (the
    reference's default) finite and within ``DECODE_BF16_TOL * max|f32|``
    of the f32 cache's, the greedy tokens that differ counted.  The
    prefill wall, each decode step's wall (a second f32 run on the same
    tokens) and ``max_memory_allocated``.  Then ``DECODE_CUTS``: the other
    families' cuts card against CPU (``decode_cut_vs_cpu``)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import make_decode_step
    from repro_torch.models.transformer import forward, init_cache, init_params

    card = report["card"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(DECODE_SEED),
                         device="cuda")
    prompt = TokenStream(cfg.vocab_size, seed=DECODE_SEED).sample(DECODE_B, DECODE_PROMPT)
    batch = {"tokens": torch.from_numpy(prompt).cuda()}
    seq = DECODE_PROMPT + DECODE_STEPS

    def run(dtype, feed=None):
        cache = init_cache(cfg, DECODE_B, seq, dtype, device="cuda")
        return _decode(params, cfg, batch, cache, DECODE_STEPS, feed)

    lg32, fed, _, _, _ = counted(launches, "decode/f32", lambda: run(torch.float32))
    _, _, cache, prefill_s, walls = run(torch.float32, fed)
    decode = make_decode_step(cfg)
    work = profile_device(lambda: decode(params, cache, fed[:, -1:], seq - 1))
    step_profile = device_breakdown(work, statistics.median(walls))
    del cache
    with torch.no_grad():
        full, _ = forward(params, cfg, torch.cat([batch["tokens"], fed], 1),
                          torch.arange(seq, device="cuda"), serve=True)
    want = full[:, DECODE_PROMPT - 1:]
    del full
    tol = DECODE_TOL * float(want.abs().max())
    gap = float((lg32 - want).abs().max())
    top2 = want[:, :-1].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = fed == want[:, :-1].argmax(-1)
    if not (torch.isfinite(lg32).all() and gap <= tol and bool(agree[clear].all())):
        raise AssertionError(f"decode: logits gap {gap} > {tol} or greedy tokens "
                             f"{int((~agree & clear).sum())} apart from the full forward")
    lg16, _, cache16, _, _ = counted(launches, "decode/bf16", lambda: run(torch.bfloat16, fed))
    gap16 = float((lg16 - lg32).abs().max())
    tol16 = DECODE_BF16_TOL * float(lg32.abs().max())
    differ16 = int((lg16[:, :-1].argmax(-1) != fed).sum())
    if not (torch.isfinite(lg16).all() and gap16 <= tol16
            and cache16["stack"]["k"].dtype == torch.bfloat16):
        raise AssertionError(f"decode: bf16 cache logits gap {gap16} > {tol16}")
    step_ms = statistics.median(walls) * 1e3
    out = dict(card=card, batch=DECODE_B, prompt=DECODE_PROMPT, steps=DECODE_STEPS,
               prefill_s=prefill_s, decode_step_ms=step_ms,
               decode_step_p90_ms=float(np.percentile(walls, 90)) * 1e3,
               tokens_per_s=DECODE_B / (step_ms / 1e3), tol=tol, max_gap=gap,
               greedy_clear=int(clear.sum()), greedy_agree=int(agree.sum()),
               bf16_tol=tol16, bf16_gap=gap16, bf16_greedy_differ=differ16,
               step_profile=step_profile,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"[phase 4l] {cfg.name} ({card}): {DECODE_B} x {DECODE_PROMPT} prefill "
        f"{prefill_s * 1e3:.1f} ms, decode step median {step_ms:.2f} ms (p90 "
        f"{out['decode_step_p90_ms']:.2f}), {out['tokens_per_s']:.0f} tokens/s; logits vs the "
        f"cache-less forward max gap {gap:.3g} <= {tol:.3g}; greedy == argmax on "
        f"{int(agree.sum())}/{agree.numel()} ({int(clear.sum())} clear of the gap); bf16 cache "
        f"gap {gap16:.3g} <= {tol16:.3g}, {differ16} greedy tokens differ; peak "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"[phase 4l] one decode step: {_fmt_breakdown(step_profile)}")
    del params, lg32, lg16, cache16, want, top2
    gc.collect()
    torch.cuda.empty_cache()
    cuts = {}
    for name, n_layers, edit in DECODE_CUTS:
        key = name + ("/mla_absorb" if edit.get("mla_absorb") else "")
        cuts[key] = counted(launches, f"decode/{key}",
                            lambda: decode_cut_vs_cpu(name, n_layers, edit))
        gc.collect()
        torch.cuda.empty_cache()
    out["cuts"] = cuts
    out["phase_s"] = time.perf_counter() - t_phase
    report["decode"] = out
    return out


def _band_check(what: str, got, want, bands, lr: float) -> int:
    """tests/test_torch_train.py's updated-params rule: ``got`` within 1e-6
    of ``want`` outside each leaf's band (``bands``, a bool tensor a leaf in
    flatten order), within ``2 lr + 1e-6`` inside it -> the count of
    elements in the band past 1e-6, held under ``TRAIN_MOVED_SHARE``."""
    from repro_torch.tree import flatten

    moved = total = 0
    for (path, a), (_, b), band in zip(flatten(got), flatten(want), bands, strict=True):
        d = (a.float() - b.float().to(a.device)).abs()
        band = band.to(a.device)
        out = float(d[~band].max()) if bool((~band).any()) else 0.0
        if out > 1e-6 or float(d.max()) > 2 * lr + 1e-6:
            raise AssertionError(f"train {what}: {path} max abs err {out} outside the band, "
                                 f"{float(d.max())} in all")
        moved += int((d[band] > 1e-6).sum())
        total += d.numel()
    if moved > TRAIN_MOVED_SHARE * total:
        raise AssertionError(f"train {what}: {moved} of {total} band elements moved past 1e-6")
    return moved


def _bands(grads) -> list:
    from repro_torch.tree import leaves

    return [g.abs() < TRAIN_BAND * g.abs().max() for g in leaves(grads)]


def train_cut_vs_cpu(cfg) -> dict:
    """Phase 4m: a 2-layer cut of ``cfg``'s widths, weights drawn on the
    card, one train step on the card and on the CPU from the same weights
    and batch: loss and ``grad_norm`` within 1e-5 relative, the gradients
    within ``1e-5 * max|g_cpu| + 1e-7`` a leaf, the params under the band
    rule; then the card's updated params through ``save_checkpoint`` and
    ``restore_checkpoint`` (a temporary directory), bit for bit."""
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data.tokens import make_batches
    from repro_torch.models.steps import _grads_of, make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten, leaves

    cut = cfg.scaled(n_layers=2)
    params = init_params(cut, torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 1),
                         device="cuda")
    raw = next(make_batches(cut.vocab_size, TRAIN_CUT_B, TRAIN_CUT_S, seed=1))
    step = make_train_step(cut, lr=TRAIN_LR, clip=TRAIN_CLIP)
    res = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to_cpu(params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        t = time.perf_counter()
        _, grads = _grads_of(p, cut, batch, False)
        new_p, _, m = step(p, adamw_init(p), batch)
        res[dev] = (new_p, m, grads, time.perf_counter() - t)
    (p_card, m_card, g_card, card_s), (p_cpu, m_cpu, g_cpu, cpu_s) = res["cuda"], res["cpu"]
    for k in ("loss", "grad_norm"):
        a, b = float(m_card[k]), float(m_cpu[k])
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"train cut: {k} card {a} vs CPU {b}")
    g_err = 0.0
    for (path, a), b in zip(flatten(g_card), leaves(g_cpu)):
        e = float((a.cpu() - b).abs().max())
        g_err = max(g_err, e / max(float(b.abs().max()), 1e-30))
        if e > 1e-5 * float(b.abs().max()) + 1e-7:
            raise AssertionError(f"train cut: gradient {path} card vs CPU max abs err {e}")
    moved = _band_check("cut card vs CPU", p_card, p_cpu, _bands(g_cpu), TRAIN_LR)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, p_card)
        back = restore_checkpoint(d, 1, p_card, device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(p_card)))
    if not same:
        raise AssertionError("train cut: checkpoint round trip is not bit-equal")
    log(f"[phase 4m] {cut.name} 2-layer cut at full widths, batch {TRAIN_CUT_B} x "
        f"{TRAIN_CUT_S}: loss card {float(m_card['loss']):.6f} vs CPU "
        f"{float(m_cpu['loss']):.6f}, grad_norm {float(m_card['grad_norm']):.6f} vs "
        f"{float(m_cpu['grad_norm']):.6f}, gradients within {g_err:.3g} of max|g|, params "
        f"under the band rule ({moved} band elements past 1e-6); checkpoint round trip "
        f"bit-equal; card {card_s:.1f}s, CPU {cpu_s:.1f}s")
    return dict(loss_card=float(m_card["loss"]), loss_cpu=float(m_cpu["loss"]),
                grad_norm_card=float(m_card["grad_norm"]), grad_norm_cpu=float(m_cpu["grad_norm"]),
                grad_rel_err=g_err, band_moved=moved, checkpoint_equal=same, card_s=card_s,
                cpu_s=cpu_s)


def phase_train(report: dict, launches: dict) -> dict:
    """Phase 4m: training at Qwen3-1.7B's published widths: f32 masters
    and moments (``init_train_state`` from ``TRAIN_SEED``),
    ``make_batches(vocab, 4, 256, seed=0)``, lr 3e-4, clip 1.0.  From the
    initial state on the first batch: a ``remat=True`` step's loss within
    1e-6 relative of the plain step's and its params under the band rule
    (the embedding's backward adds atomically on the card, so its sums
    vary); a ``microbatch=2`` step's loss within 1e-5 and params under the
    band rule; a ``compute_dtype=bfloat16`` step's loss finite and within
    ``TRAIN_BF16_LOSS`` relative.  Then 6 plain steps and 2 remat steps
    timed (wall, ``max_memory_allocated`` of the steps and of a forward and
    backward alone, TFLOP/s at 6 N tokens), every loss and ``grad_norm``
    finite; the 2-layer cut card vs CPU (``train_cut_vs_cpu``); and
    ``python -m repro_torch.launch.train`` at its defaults in a process of
    its own on the card, which must print ``OK``."""
    import gc
    import os

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batches
    from repro_torch.models.steps import _grads_of, init_train_state, make_train_step
    from repro_torch.tree import leaves

    card = report["card"]
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params, opt = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                                   device="cuda")
    n_params = sum(p.numel() for p in leaves(params))
    batches = make_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    data = [{k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}
            for _ in range(TRAIN_STEPS + TRAIN_REMAT_STEPS)]
    flop = 6 * n_params * TRAIN_B * TRAIN_S

    def one(b, **kw):
        new_p, _, m = make_train_step(cfg, lr=TRAIN_LR, clip=TRAIN_CLIP, **kw)(params, opt, b)
        return new_p, {k: float(v) for k, v in m.items()}

    def variants():
        _, grads = _grads_of(params, cfg, data[0], False)
        bands = _bands(grads)
        del grads
        p1, m1 = one(data[0])
        pr, mr = one(data[0], remat=True)
        if abs(mr["loss"] - m1["loss"]) > 1e-6 * abs(m1["loss"]):
            raise AssertionError(f"train: remat loss {mr['loss']} vs {m1['loss']}")
        moved_r = _band_check("remat vs plain", pr, p1, bands, TRAIN_LR)
        del pr
        pm, mm = one(data[0], microbatch=2)
        if abs(mm["loss"] - m1["loss"]) > 1e-5:
            raise AssertionError(f"train: microbatch loss {mm['loss']} vs {m1['loss']}")
        moved_m = _band_check("microbatch vs whole batch", pm, p1, bands, TRAIN_LR)
        del pm, p1, bands
        _, mb = one(data[0], compute_dtype=torch.bfloat16)
        if not (math.isfinite(mb["loss"])
                and abs(mb["loss"] - m1["loss"]) <= TRAIN_BF16_LOSS * abs(m1["loss"])):
            raise AssertionError(f"train: bf16 compute loss {mb['loss']} vs {m1['loss']}")
        return dict(loss=m1["loss"], grad_norm=m1["grad_norm"], remat_loss=mr["loss"],
                    remat_band_moved=moved_r, microbatch_loss=mm["loss"],
                    microbatch_band_moved=moved_m, bf16_loss=mb["loss"],
                    bf16_grad_norm=mb["grad_norm"])

    out = dict(card=card, n_params=n_params, flop_per_step=flop,
               **counted(launches, "train/variants", variants))
    gc.collect()
    torch.cuda.empty_cache()

    def run(n, first, remat):
        nonlocal params, opt
        step = make_train_step(cfg, lr=TRAIN_LR, clip=TRAIN_CLIP, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        walls, losses, norms = [], [], []
        for b in data[first:first + n]:
            t = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"train: losses {losses}, grad norms {norms}")
        step_s = statistics.median(walls)
        return dict(walls_s=walls, losses=losses, grad_norms=norms, step_s=step_s,
                    tflops=flop / step_s / 1e12, max_memory_allocated=torch.cuda.max_memory_allocated())

    out["plain"] = counted(launches, "train/steps", lambda: run(TRAIN_STEPS, 0, False))
    out["remat"] = counted(launches, "train/remat", lambda: run(TRAIN_REMAT_STEPS, TRAIN_STEPS,
                                                                True))
    step = make_train_step(cfg, lr=TRAIN_LR, clip=TRAIN_CLIP)
    work = profile_device(lambda: step(params, opt, data[0]))
    out["plain"]["step_profile"] = device_breakdown(work, out["plain"]["step_s"])
    for remat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        _grads_of(params, cfg, data[0], remat)
        out["remat" if remat else "plain"]["grads_max_memory_allocated"] = \
            torch.cuda.max_memory_allocated()
    for key in ("plain", "remat"):
        r = out[key]
        log(f"[phase 4m] {cfg.name} ({card}) {key}: step median {r['step_s'] * 1e3:.1f} ms "
            f"({r['tflops']:.1f} TFLOP/s at 6 x {n_params / 1e9:.3f}e9 x {TRAIN_B * TRAIN_S}), "
            f"peak {r['max_memory_allocated'] / 2**30:.2f} GiB (forward + backward alone "
            f"{r['grads_max_memory_allocated'] / 2**30:.2f} GiB); losses "
            + ", ".join(f"{v:.4f}" for v in r["losses"]))
    log(f"[phase 4m] one plain step: {_fmt_breakdown(out['plain']['step_profile'])}")
    log(f"[phase 4m] first batch: loss {out['loss']:.6f}, remat {out['remat_loss']:.6f} "
        f"({out['remat_band_moved']} band elements past 1e-6), microbatch 2 "
        f"{out['microbatch_loss']:.6f} ({out['microbatch_band_moved']}), bf16 compute "
        f"{out['bf16_loss']:.6f}")
    del params, opt, data
    gc.collect()
    torch.cuda.empty_cache()
    out["cut"] = counted(launches, "train/cut", lambda: train_cut_vs_cpu(cfg))
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"],
                         env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    lines = cli.stdout.strip().splitlines()
    if cli.returncode or not lines or "(OK)" not in lines[-1]:
        raise AssertionError(f"repro_torch.launch.train: rc {cli.returncode}, "
                             f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    out["launch_train"] = dict(wall_s=time.perf_counter() - t, first=lines[0], last=lines[-1])
    log(f"[phase 4m] python -m repro_torch.launch.train (defaults) in "
        f"{out['launch_train']['wall_s']:.1f}s: {lines[-1]}")
    out["phase_s"] = time.perf_counter() - t_phase
    report["train"] = out
    return out


def phase_gate(report: dict) -> None:
    """Phase 4f: the port's billing gate (``benchmarks/torch/perf_gate.py
    --device cuda --check``) on the card: the reference gate's fixtures
    through the port's kernels and captured loops, every reachable key
    equal to ``benchmarks/results/baseline_billing.json``, every other key
    pending with its queue item."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_perf_gate", ROOT / "benchmarks" / "torch" / "perf_gate.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    baseline = json.loads(gate.BASELINE.read_text())["counters"]
    counters = gate.collect_counters("cuda")
    failures = gate.compare(baseline, counters)
    if failures:
        raise AssertionError("perf gate: " + "; ".join(failures))
    pending = sorted(k for k in baseline if gate.pending_reason(k) is not None)
    if (len(counters), len(pending)) != (51, 76):
        raise AssertionError(f"perf gate: {len(counters)} reachable keys, {len(pending)} "
                             "pending; expected 51 and 76")
    traces = {k: v for k, v in counters.items() if k.endswith(".traces")}
    report["perf_gate"] = dict(reachable=len(counters), pending=len(pending), counters=counters)
    log(f"[phase 4f] perf gate on the card: {len(counters)} reachable keys == baseline "
        f"(traces {traces}), {len(pending)} pending, {len(baseline)} accounted for")


def flush_latency(make_server, x, label: str, megakernels=(None, False),
                  captures=(True,)) -> dict:
    """Median and p90 flush latency at batch 128 / 256 / 1024, fused
    (megakernel on, the default) and unfused, or only ``megakernels``, for
    the servers ``make_server(batch_size=, backend_opts=)`` builds: the
    captured loop (one CUDA graph a server) and, in ``captures``, the eager
    loop (``capture=False``, keys ending in ``_eager``)."""
    lat = {}
    for batch, megakernel, capture in itertools.product((128, 256, 1024), megakernels, captures):
        # (a tree without the option runs its eager loop: a paired bench's parent)
        opts = {"megakernel": megakernel, **({} if capture else {"capture": False})}
        srv = make_server(batch_size=batch, backend_opts=opts)
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
        key = (f"batch{batch}" + ("" if megakernel is None else "_unfused")
               + ("" if capture else "_eager"))
        # p90 of 100 samples has 10 beyond it
        lat[key] = dict(
            median_ms=statistics.median(times),
            p90_ms=statistics.quantiles(times, n=10)[-1],
            min_ms=min(times), max_ms=max(times), n=len(times),
        )
        log(f"[phase 5] {label} flush latency batch {batch} "
            f"({'fused' if megakernel is None else 'unfused'}, "
            f"{'captured' if capture else 'eager loop'}): median "
            f"{lat[key]['median_ms']:.3f} ms, p90 {lat[key]['p90_ms']:.3f} ms "
            f"over {len(times)} flushes")
    return lat


def busy_share(srv, x, median_ms: float, label: str, tries: int = 3) -> dict:
    """Device busy share of one steady batch-256 flush of ``srv``: the
    profiler's device time over the unprofiled median flush ``median_ms``
    (the profiler slows the host, so its own wall would understate it).
    The kernel launches of one unprofiled flush (a replayed graph's counted
    at its capture) are checked against the port's kernels the profile
    sees: more fails at once; fewer (the profiler lost records: 61 of 65
    once, in one captured flush) profiles the flush again, at most
    ``tries`` times in all, and fails if no profile sees them all."""
    import torch

    from repro_torch.kernels import _build

    # a program's first flush runs eagerly, its second captures it
    serve(srv, x[:256])
    serve(srv, x[:256])
    wall = {}

    def fill():  # 255 rows queued: the next submit flushes
        for row in x[256:511]:
            srv.submit(row)

    def flush():
        t = time.perf_counter()
        srv.submit(x[511])  # the 256th row: one flush
        wall["us"] = (time.perf_counter() - t) * 1e6

    # the launches of one flush, and its span on the device between two
    # CUDA events
    fill()
    _build.LAUNCHES.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    flush()
    end.record()
    torch.cuda.synchronize()
    launched = sum(_build.LAUNCHES.values())
    span_us = start.elapsed_time(end) * 1e3
    for attempt in range(tries):
        by_name = profile_device(flush, prepare=fill)
        events = sum(c for _, c in port_kernels(by_name).values())
        if events > launched:
            raise AssertionError(f"{label}: the profile saw {events} of the port's kernels "
                                 f"for {launched} launches")
        if events == launched:
            break
        log(f"[phase 5] {label}: profile {attempt + 1}/{tries} saw {events} of the port's "
            f"kernels for {launched} launches")
    else:
        raise AssertionError(f"{label}: no profile of {tries} saw the flush's {launched} "
                             f"launches")
    busy = sum(v[0] for v in by_name.values())
    wall_unprofiled_us = median_ms * 1e3
    log(f"[phase 5] {label} one flush (batch 256): device busy {busy:.0f} us = "
        f"{busy / wall_unprofiled_us:.2%} of the unprofiled median flush "
        f"{wall_unprofiled_us:.0f} us (wall under the profiler {wall['us']:.0f} us); the "
        f"profile saw {events} of the port's kernels for {launched} launches; device span "
        f"{span_us:.0f} us (CUDA events)")
    return dict(
        device_busy_us=busy, wall_unprofiled_median_us=wall_unprofiled_us,
        busy_share=busy / wall_unprofiled_us, wall_profiled_us=wall["us"],
        port_events=events, launches=launched, profiles=attempt + 1, device_span_us=span_us,
        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
        port=port_kernels(by_name),
    )


class OpCount:
    """Counts the PyTorch operator calls (aten ops: allocations, gathers,
    scatters, elementwise ops, copies) made while it is entered, in all
    (``n``) and by name (``by_name``)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                counter.by_name[str(func.overloadpacket)] += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.by_name = collections.Counter()
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def unfused_calls(srv, x, label: str) -> dict:
    """The PyTorch operator calls of one steady batch-256 flush of the
    unfused server ``srv``: in all, a stage of its plan, and by name.
    Fails if the flush makes a cumsum, or a gather (``aten.index``) a
    stage: the decide's compaction and its ``g[rows]``, which B2's step
    form does on the card."""
    import torch

    serve(srv, x[:256])
    for row in x[256:511]:
        srv.submit(row)
    with OpCount() as ops:
        srv.submit(x[511])  # the 256th row: one flush
    torch.cuda.synchronize()
    S = srv._dev[0].dplan.S
    by_name = dict(ops.by_name)
    if by_name.get("aten.cumsum", 0) or by_name.get("aten.index", 0) >= S:
        raise AssertionError(f"{label} unfused flush: {by_name.get('aten.cumsum', 0)} "
                             f"cumsums, {by_name.get('aten.index', 0)} gathers over {S} stages")
    log(f"[phase 5] {label} unfused flush (batch 256): {ops.n} PyTorch calls, "
        f"{ops.n / S:.1f} a stage over {S} stages; no cumsum, "
        f"{by_name.get('aten.index', 0)} gathers")
    return dict(torch_ops=ops.n, stages=S, torch_ops_per_stage=ops.n / S, by_name=by_name)


def stream_timing(make_server, x, label: str, rate: float = STREAM_RATES[0]) -> dict:
    """Streaming at ``rate`` requests per step (default the heavy rate,
    phase 4c's first): ``N_DRAINS`` drains of the test rows after one
    warm-up drain, each wave timed on the host clock (a wave ends in its
    results' transfer); then one wave's PyTorch operator calls, and one
    wave profiled for the device busy share over the unprofiled median
    wave."""
    import numpy as np

    arrivals = poisson_arrivals(x.shape[0], rate)
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
    out["ops_by_name"] = dict(ops.by_name.most_common())
    by_name = profile_device(wave, prepare=fill)
    busy = sum(v[0] for v in by_name.values())
    med_us = out["wave_median_ms"] * 1e3
    out.update(
        device_busy_us=busy, busy_share=busy / med_us,
        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
        port=port_kernels(by_name),
    )
    log(f"[phase 5] {label} streaming (rate {rate:g}, cap {STREAM_CAP}, window "
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


def rank_timing(rmain: dict, capture: bool = True) -> dict:
    """Phase 4d's card server (its eager loop with ``capture=False``),
    host clock, each drain ending in its results' transfer: its first drain
    of the test queries (every program's first run, eager) and its second
    (each program captured, then replayed); ``N_RANK_DRAINS`` drains of the
    same queries after them; one drain of each never-seen query set of
    ``rmain["fresh"]``; one drain's PyTorch operator calls per grouped
    stage enqueued; one drain profiled for the device busy share over the
    unprofiled median."""
    make, x, off, S = rmain["server"], rmain["x"], rmain["offsets"], rmain["S"]
    srv = make(capture)

    def drain_ms(xq, oq) -> float:
        t = time.perf_counter()
        submit_queries(srv, xq, oq)
        return (time.perf_counter() - t) * 1e3

    first, second = drain_ms(x, off), drain_ms(x, off)
    walls = [drain_ms(x, off) for _ in range(N_RANK_DRAINS)]
    # (a tree without traces, timed by bench_capture.py, counts none)
    traces = getattr(srv.executor, "traces", 0)
    fresh = [drain_ms(xq, oq) for xq, oq in rmain["fresh"]]
    fresh_traces = getattr(srv.executor, "traces", 0) - traces
    waves = srv.stats.n_waves
    with OpCount() as ops:
        submit_queries(srv, x, off)
    waves = srv.stats.n_waves - waves
    by_name = profile_device(lambda: submit_queries(srv, x, off))
    busy = sum(v[0] for v in by_name.values())
    med, fmed = statistics.median(walls), statistics.median(fresh)
    out = dict(
        drain_median_ms=med, drain_p90_ms=statistics.quantiles(walls, n=10)[-1],
        drains=len(walls), queries=off.size - 1, waves_per_drain=waves,
        first_drain_ms=first, second_drain_ms=second,
        fresh_drain_median_ms=fmed, fresh_drain_p90_ms=statistics.quantiles(fresh, n=10)[-1],
        fresh_drains=len(fresh), fresh_new_programs=fresh_traces,
        torch_ops_per_stage=ops.n / (waves * S), device_busy_us=busy,
        busy_share=busy / (med * 1e3),
        top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
        ops_by_name=dict(ops.by_name.most_common()),
        sort_kernels=[k for k in by_name if "sort" in k.lower()],
        sort_calls=ops.by_name["aten.sort"],
    )
    log(f"[phase 5] ranking drain ({'captured' if capture else 'eager loop'}) of "
        f"{off.size - 1} queries ({waves} waves of {S} stages): first {first:.3f} ms, second "
        f"{second:.3f} ms, then median {med:.3f} ms, p90 {out['drain_p90_ms']:.3f} ms over "
        f"{len(walls)} drains; never-seen queries ({len(fresh)} drains of {RANK_FRESH}, "
        f"{fresh_traces} new programs): median {fmed:.3f} ms, p90 "
        f"{out['fresh_drain_p90_ms']:.3f} ms; {out['torch_ops_per_stage']:.1f} PyTorch ops "
        f"per grouped stage; one drain's device busy {busy:.0f} us = "
        f"{out['busy_share']:.2%} of the median drain")
    return out


def rank_stream_timing(rsmain: dict, capture: bool = True) -> dict:
    """Phase 4g's streaming ranking server (skip-ahead; with ``capture``
    False its eager loop), five drains of the test queries at their
    Poisson arrivals, host clock, each ending in its results' transfer:
    the first (every program's first run, eager), then one profiled with
    the profiler's warm-up step as the second drain (each program
    captured) and its recorded step as the third (replayed), then two
    timed drains.  Each wave (one ``run_stream_grouped``) is timed too.
    Reports the drain and wave walls, the steps run, enqueued and the
    syncs a wave, and the profiled drain's device busy share of the timed
    drains' median."""
    import numpy as np

    srv = rsmain["server"]("cuda", RANK_POLICIES[0], capture)
    x, off, arr = rsmain["x"], rsmain["offsets"], rsmain["arrivals"]
    ex = srv.executor
    run, walls = ex.run_stream_grouped, []

    def timed_wave(*a, **kw):
        t = time.perf_counter()
        out = run(*a, **kw)
        walls.append((time.perf_counter() - t) * 1e3)
        return out

    ex.run_stream_grouped = timed_wave

    def drain_ms() -> float:
        t = time.perf_counter()
        submit_stream(srv, x, off, arr + (math.ceil(srv._clock) + 1.0 if srv._seq else 0.0))
        return (time.perf_counter() - t) * 1e3

    first = drain_ms()
    by_name = profile_device(drain_ms)
    walls.clear()
    n0 = len(srv.stream_results)
    drains = [drain_ms() for _ in range(2)]
    waves = srv.stream_results[n0:]
    busy = sum(v[0] for v in by_name.values())
    med = statistics.median(drains)
    out = dict(
        first_drain_ms=first, drains_ms=drains, drain_median_ms=med,
        wave_median_ms=statistics.median(walls), wave_max_ms=max(walls), waves=len(walls),
        steps_run_per_wave=float(np.mean([w.steps_run for w in waves])),
        steps_enqueued_per_wave=float(np.mean([w.steps_enqueued for w in waves])),
        syncs_per_wave=float(np.mean([w.syncs for w in waves])),
        device_busy_us=busy, busy_share=busy / (med * 1e3), traces=ex.traces,
        graphs=len(ex._graphs), top=sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12],
        port=port_kernels(by_name),
    )
    log(f"[phase 5] ranking streaming drain ({'captured' if capture else 'eager loop'}, "
        f"{RANK_POLICIES[0]}, {off.size - 1} queries at {RANK_STREAM_RATE:g} a step): first "
        f"{first:.3f} ms, then {drains[0]:.3f} / {drains[1]:.3f} ms; wave median "
        f"{out['wave_median_ms']:.3f} ms, max {out['wave_max_ms']:.3f} ms over {len(walls)} "
        f"waves; {out['steps_run_per_wave']:.1f} steps run, "
        f"{out['steps_enqueued_per_wave']:.1f} enqueued, {out['syncs_per_wave']:.1f} syncs per "
        f"wave; one drain's device busy {busy:.0f} us = {out['busy_share']:.2%} of the median "
        f"drain; {ex.traces} programs, {len(ex._graphs)} graphs")
    return out


def eager_timing(make_batch, make_stream, x, label: str) -> dict:
    """exp1's eager path (``score_fn``: one B3 score matrix a flush or wave,
    then B4 matrix a stage or B7 matrix a step enqueued): the flush latency
    at batch 128 / 256 / 1024, one batch-256 flush's device busy share and
    top kernels, and the streaming server's waves at each rate of
    ``STREAM_RATES``.  ``make_batch(batch_size=, backend_opts=)`` and
    ``make_stream()`` build the servers."""
    lat = flush_latency(make_batch, x, label, megakernels=(None,))
    return dict(
        flush_latency=lat,
        profile_flush256=busy_share(make_batch(), x, lat["batch256"]["median_ms"], label),
        stream={f"r{rate:g}": stream_timing(make_stream, x, label, rate=rate)
                for rate in STREAM_RATES},
    )


def quant_timing(qmain: dict) -> dict:
    """exp1's trees served by phase 4e's fused servers at f32 and at bf16
    slabs, in turns: one batch-256 flush (host clock, median and p90 of
    ``N_FLUSH`` flushes after ``N_WARM``; one flush's device busy time) and
    one streaming wave at 256 requests/step (``stream_timing``)."""
    c = qmain["cells"]["tree"]
    x = c["x"]
    out = {}
    for quant in (None, "bf16"):
        label = f"exp1 tree {quant or 'f32'}"
        srv = qmain["batch_server"](c, c["params"], quant, "cuda")
        times = []
        for k in range(N_WARM + N_FLUSH):
            start = (k * 256) % (x.shape[0] - 256)
            for row in x[start : start + 255]:
                srv.submit(row)
            t = time.perf_counter()
            srv.submit(x[start + 255])  # the 256th row: one flush
            times.append((time.perf_counter() - t) * 1e3)
        times = times[N_WARM:]
        med = statistics.median(times)
        r = dict(flush_median_ms=med, flush_p90_ms=statistics.quantiles(times, n=10)[-1])
        log(f"[phase 5] {label} flush (batch 256, kernel policy, fused): median {med:.3f} ms, "
            f"p90 {r['flush_p90_ms']:.3f} ms over {len(times)} flushes")
        r["profile_flush256"] = busy_share(
            qmain["batch_server"](c, c["params"], quant, "cuda"), x, med, label)
        r["stream"] = stream_timing(
            lambda: qmain["stream_server"](c, c["params"], quant, "cuda"), x, label)
        out[quant or "f32"] = r
    return out


def phase_times(ctx: dict, main: dict, lmain: dict, smain: dict, rmain: dict, qmain: dict,
                rsmain: dict, launches: dict, check: Check, report: dict) -> list:
    """Phase 5: flush latency, streaming wave times, the ranking drain and
    per-kernel device times."""
    import numpy as np
    import torch

    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.cascade_kernel import (
        cascade_chunk_kernel,
        cascade_chunk_plain,
        cascade_chunk_step,
        cascade_chunk_step_plain,
        cascade_group_kernel,
        cascade_group_plain,
        cascade_kernel,
        cascade_lane_kernel,
        cascade_lane_step,
        cascade_lane_step_plain,
        cascade_plain,
        group_topk_rows,
    )
    from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
    from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain

    # each served path captured (the default) and, beside it, its eager loop
    # (capture=False): walls, busy shares, PyTorch calls
    ds, server = main["ds"], main["server"]
    lat = flush_latency(lambda **kw: server("both", "cuda", **kw), ds.x_test, "exp1_adult",
                        captures=(True, False))
    report["flush_latency"] = lat
    lds, lserver = lmain["ds"], lmain["server"]
    llat = flush_latency(lambda **kw: lserver("cuda", **kw), lds.x_test, "exp4_rw2_joint",
                         captures=(True, False))
    report["lattice_flush_latency"] = llat
    for capture, sfx in ((True, ""), (False, "_eager")):
        opts = {} if capture else {"capture": False}
        label = "captured" if capture else "eager loop"
        report[f"profile_flush256{sfx}"] = busy_share(
            server("both", "cuda", backend_opts=opts), ds.x_test,
            lat[f"batch256{sfx}"]["median_ms"], f"exp1_adult {label}")
        report[f"lattice_profile_flush256{sfx}"] = busy_share(
            lserver("cuda", backend_opts=opts), lds.x_test,
            llat[f"batch256{sfx}"]["median_ms"], f"exp4_rw2_joint {label}")
        # the unfused batch stage (B3 or B5, then B2's step form): its calls
        unfused = {"megakernel": False, **opts}
        report[f"unfused_calls{sfx}"] = {
            "exp1_adult": unfused_calls(server("both", "cuda", backend_opts=unfused),
                                        ds.x_test, f"exp1_adult {label}"),
            "exp4_rw2_joint": unfused_calls(lserver("cuda", backend_opts=unfused),
                                            lds.x_test, f"exp4_rw2_joint {label}"),
        }
        report[f"stream_timing{sfx}"] = {
            cell: stream_timing(lambda c=cell: smain["server"](c, "cuda", dict(opts)),
                                smain["cells"][cell]["ds"].x_test, f"{cell} {label}")
            for cell in smain["cells"]
        }
        # the unfused step (lane_fn + B6's step form), both cells at the heavy rate
        report[f"stream_timing_unfused{sfx}"] = {
            cell: stream_timing(lambda c=cell: smain["server"](c, "cuda", dict(unfused)),
                                smain["cells"][cell]["ds"].x_test, f"{cell} unfused {label}")
            for cell in smain["cells"]
        }
        report[f"rank_stream_timing{sfx}"] = rank_stream_timing(rsmain, capture=capture)
        rt = report[f"rank_timing{sfx}"] = rank_timing(rmain, capture=capture)
        # B8 picks each group's top k: the drain sorts nothing on the card
        if rt["sort_kernels"] or rt["sort_calls"]:
            raise AssertionError(f"ranking drain: sort kernels {rt['sort_kernels']}, "
                                 f"{rt['sort_calls']} aten.sort calls")
    report["eager_timing"] = eager_timing(
        lambda **kw: server("both", "cuda", scorer=None, score_fn=main["score_fn"], **kw),
        lambda: smain["server"]("exp1_adult", "cuda", eager=True), ds.x_test, "exp1_adult eager",
    )

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
    stage, t0 = 5, int(dplan.stage_t0[5])
    kernels = []

    def entry(name, fn, plain, nbytes, ops, shape, extra=None):
        # device time per launch, the plain version's per call (fewer reps:
        # its hundreds of small launches a call make a profile slow to read)
        t = time.perf_counter()
        ms, plain_ms = device_time_ms(fn), device_time_ms(plain, reps=N_PLAIN_REPS, tries=1)
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
            f"bound {b * 1e3:.4f} us ({by}); timed in {time.perf_counter() - t:.1f}s")

    def other_shape(name, label, fn, plain, nbytes, ops, shape, reps=50):
        # another shape a path gives the kernel, beside the stage entry
        ms = device_time_ms(fn, reps=reps)
        plain_ms = device_time_ms(plain, reps=max(2, reps // 10), tries=1)
        b, by = bound(nbytes, ops)
        log(f"[phase 5] {name} {label} {shape}: device {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.1f} us, bound {b * 1e3:.4f} us ({by})")
        return {label: dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)}

    def calibration(name, fn, plain, nbytes, ops, shape):
        # the one-off calibration shape, beside the serving shape's entry
        e = other_shape(name, "calibration", fn, plain, nbytes, ops, shape, reps=20)
        c = e["calibration"]
        return dict(calib_shape=shape, calib_ms=c["ms"], calib_plain_ms=c["plain_ms"],
                    calib_bound_ms=c["bound_ms"], calib_bound_by=c["bound_by"], shapes=e)

    entry(
        "cascade_chunk",
        lambda: cascade_chunk_kernel(g0, chunk, ep, en, 0, block_n=64, n_valid=nv),
        lambda: cascade_chunk_plain(g0, chunk, ep, en, 0, n_valid=nv),
        nbytes=4 * (m + m * ct + 2 * ct) + 16 * m, ops=3 * m * ct,
        shape=f"m={m} ct={ct}",
    )
    # B2's step form as the unfused batch stage calls it (g read through
    # permuted row ids, stage 5's tables in place, the pack written); beside
    # it the parent's chain (the gather, the column mask, B2 in the
    # reference's form, the cumsum pack) and that form alone
    g_slots = torch.cat([g0, torch.zeros(1, device="cuda")])
    rows_perm = torch.from_numpy(np.random.default_rng(5).permutation(m)).cuda()
    col_valid = ctx["lanes"]["col_valid"]
    lane_m = torch.arange(m, device="cuda")
    step_in = (g_slots, rows_perm, chunk, 5, eps_pos, eps_neg, col_valid)

    def chunk_chain():
        sc = torch.where(col_valid[5][None, :], chunk, 0.0)
        g, act, dpos, ex = cascade_chunk_kernel(g_slots[rows_perm], sc.contiguous(), eps_pos[5],
                                                eps_neg[5], 0, block_n=64, n_valid=nv)
        keep = act.bool() & (lane_m < nv)
        pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=torch.int32) - 1, m)
        return g, act, dpos, ex, pack, keep.sum(dtype=torch.int32)

    step_extra = dict(chain_ms=device_time_ms(chunk_chain))
    log(f"[phase 5] cascade_chunk_step: the parent's chain (gather, mask, B2, cumsum pack) "
        f"{step_extra['chain_ms'] * 1e3:.2f} us")
    entry(
        "cascade_chunk_step",
        lambda: cascade_chunk_step(*step_in, n_valid=nv, block_n=64),
        lambda: cascade_chunk_step_plain(*step_in, n_valid=nv),
        # a lane's row id, g and scores; the stage's threshold rows and
        # column mask, n_valid; g, active, decided, exit, pack, n_keep
        nbytes=m * (8 + 4 + 4 * ct) + 9 * ct + 4 + 20 * m + 4, ops=3 * m * ct,
        shape=f"cap={m} W={ct}, stage 5, step form", extra=step_extra,
    )
    N, T = x_cal.shape[0], feats.shape[0]
    extra = calibration(
        "gbt_scores", lambda: gbt_scores_kernel(feats, thrs, leaves, x_cal),
        lambda: gbt_scores_plain(feats, thrs, leaves, x_cal),
        4 * N * d + T * (8 * depth + 4 * L) + 4 * N * T, N * T * depth, f"{N}x{T}",
    )
    # the sort key (the first model on the flush's rows) and the eager and
    # ranking score matrices (a batch of 256 x every tree)
    x_b = x_buf[:256]
    extra["shapes"].update(other_shape(
        "gbt_scores", "sort_key",
        lambda: gbt_scores_kernel(feats, thrs, leaves, x_b, block_n=64, t0=0, t1=1, n_valid=256),
        lambda: gbt_scores_plain(feats, thrs, leaves, x_b, block_n=64, t0=0, t1=1, n_valid=256),
        256 * 4 * d + 8 * depth + 4 * L + 4 * 256, 256 * depth, "256x1",
    ))
    extra["shapes"].update(other_shape(
        "gbt_scores", "eager", lambda: gbt_scores_kernel(feats, thrs, leaves, x_b),
        lambda: gbt_scores_plain(feats, thrs, leaves, x_b),
        256 * 4 * d + T * (8 * depth + 4 * L) + 4 * 256 * T, 256 * T * depth, f"256x{T}",
    ))
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
    # B4 matrix as the eager path calls it, reading F in place through rows
    # (8 B a lane)
    entry(
        "mega_stage_matrix",
        lambda: mk.mega_stage_kernel(matrix.slabs, F, g_buf, stage, t0, nv,
                                     eps_pos, eps_neg, block_n=64, rows=rows_all),
        lambda: mk.mega_stage_plain(matrix.slabs, F, g_buf, stage, t0, nv,
                                    eps_pos, eps_neg, block_n=64, rows=rows_all),
        nbytes=256 * (8 + 4 * (W + 1)) + 8 * W + 4 + out_bytes,
        ops=256 * W * 3, shape=f"cap=256 W={W} T_pad={F.shape[1]}, rows=",
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
    # the sort key (team form) and the eager test matrix (one thread a pair)
    xl_test = torch.from_numpy(lds.x_test).cuda()
    Ne = xl_test.shape[0]
    xl_b = xl_test[:256]
    extra["shapes"].update(other_shape(
        "lattice_scores", "sort_key",
        lambda: lattice_scores_kernel(theta, lfeats, xl_b, block_n=64, t0=0, t1=1, n_valid=256),
        lambda: lattice_scores_plain(theta, lfeats, xl_b, block_n=64, t0=0, t1=1, n_valid=256),
        256 * 4 * Dl + 4 * (P + S) + 4 * 256, 256 * flops, f"256x1 S={S}",
    ))
    extra["shapes"].update(other_shape(
        "lattice_scores", "eager", lambda: lattice_scores_kernel(theta, lfeats, xl_test),
        lambda: lattice_scores_plain(theta, lfeats, xl_test),
        4 * Ne * Dl + Tl * 4 * (P + S) + 4 * Ne * Tl, Ne * Tl * flops, f"{Ne}x{Tl} S={S}",
        reps=20,
    ))
    xl_buf = xl_test[:257].contiguous()
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
    # B6 as the unfused streaming step calls it (raw scores, the tables
    # read at each lane's stage, the pack written); beside it the parent's
    # chain (the tables gathered and the scores masked by PyTorch, B6 in the
    # reference's form, the cumsum compaction) and that form alone
    raw, col_valid = lanes["raw"], lanes["col_valid"]
    step_args = (g0, raw, stage, eps_pos, eps_neg, col_valid)

    def lane_chain():
        sc = torch.where(col_valid[stage], raw, 0.0)
        g, act, dpos, ex = cascade_lane_kernel(g0, sc, eps_pos[stage], eps_neg[stage],
                                               block_n=64, n_valid=nv)
        keep = act.bool() & ~(stage >= dplan.S - 1)
        pack = torch.where(keep, torch.cumsum(keep, dim=0, dtype=torch.int32) - 1, m)
        return g, act, dpos, ex, pack, keep.sum(dtype=torch.int32)

    lane_extra = dict(
        chain_ms=device_time_ms(lane_chain),
        old_form_ms=device_time_ms(lambda: cascade_lane_kernel(
            g0, lanes["scores"], lep_, len_l, block_n=64, n_valid=nv)),
    )
    log(f"[phase 5] cascade_lane: the parent's chain (gathers, mask, B6, compaction) "
        f"{lane_extra['chain_ms'] * 1e3:.2f} us, the reference's form alone "
        f"{lane_extra['old_form_ms'] * 1e3:.2f} us")
    entry(
        "cascade_lane",
        lambda: cascade_lane_step(*step_args, n_valid=nv, block_n=64),
        lambda: cascade_lane_step_plain(*step_args, n_valid=nv),
        # g0, scores and stage a lane, each stage's threshold rows and
        # column mask once, n_valid; g, active, decided, exit, pack, n_keep
        nbytes=4 * (m + m * ct + m) + n_st * ct * 9 + 4 + 20 * m + 4, ops=3 * m * ct,
        shape=f"m={m} ct={ct}, lanes at {n_st} stages, step form", extra=lane_extra,
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

    # B4 and B7 at quantised slabs, on phase 3's main-path-shaped inputs
    # (raw payloads; B4 at stage 5 as above, B7 on the mixed-stage buffer);
    # the payload counts 2 B (bf16) or 1 B (int8) a value, the matrix
    # operand 2 B, each stage's f32 scale 4 B
    for (variant, q), scorer in ctx["quant"].items():
        pb = {"bf16": 2, "int8": 1}[q]
        deq = 0 if q == "bf16" else 1  # one multiply per int8 value staged or read
        slabs, name = scorer.slabs, f"{variant}_{q}"
        if variant == "tree":
            xq, (ep_q, en_q) = x_buf, (eps_pos, eps_neg)
            slab_b, w_ops = W * (8 * depth + pb * L) + 4, W * (depth + 3)
            row_b, lane_x = 256 * 4 * (d + 1), 256 * 4 * d
            stage_ops = W * L * deq
            shape = f"cap=256 W={W} d={d} depth={depth}"
        elif variant == "lattice":
            xq, (ep_q, en_q) = xl_buf, (lep, len_)
            slab_b, w_ops = W * (4 * S + pb * P) + 4, W * (flops + 3)
            row_b, lane_x = 256 * 4 * (Dl + 1), 256 * 4 * Dl
            stage_ops = W * P * deq
            shape = f"cap=256 W={W} d={Dl} S={S}"
        else:
            xq, (ep_q, en_q) = ctx["F_bf16"], (eps_pos, eps_neg)
            # B4 reads F in place through rows (8 B a lane), as the eager path
            slab_b, w_ops, row_b, lane_x, stage_ops = 8, W * 3, 256 * (2 * W + 12), 256 * 2 * W, 0
            shape = f"cap=256 W={W} T_pad={F.shape[1]}"
        xr_q = xq[rows_all].contiguous()
        b4_x, b4_kw, b4_shape = xr_q, {}, shape
        if variant == "matrix":
            b4_x, b4_kw, b4_shape = xq, dict(rows=rows_all), shape + ", rows="
        entry(
            f"mega_stage_{name}",
            lambda: mk.mega_stage_kernel(slabs, b4_x, g_buf, 5, t0, nv, ep_q, en_q, block_n=64,
                                         **b4_kw),
            lambda: mk.mega_stage_plain(slabs, b4_x, g_buf, 5, t0, nv, ep_q, en_q, block_n=64,
                                        **b4_kw),
            nbytes=row_b + slab_b + 8 * W + out_bytes, ops=256 * w_ops + stage_ops,
            shape=f"{b4_shape}, {q}",
        )
        lane_ops = 256 * W * deq * (1 if variant == "tree" else P)
        entry(
            f"mega_lane_{name}",
            lambda: mk.mega_lane_kernel(slabs, xq, rows_all, g_buf, stage, stop, nv, ep_q, en_q,
                                        block_n=64),
            lambda: mk.mega_lane_plain(slabs, xq, rows_all, g_buf, stage, stop, nv, ep_q, en_q,
                                       block_n=64),
            nbytes=lane_in + lane_x + n_st * slab_b, ops=256 * w_ops + lane_ops,
            shape=f"{shape}, {q}, {n_st} stages",
        )
    report["quant_timing"] = quant_timing(qmain)

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

    # B8 on the main path's widest bucket wave, its first stage's input:
    # g and valid read once, eps and n_live read, margin and exit written;
    # about one compare a lane per pass
    gq, vq, eq, k, nl, rq = rmain["b8"]
    Gq, Bq = gq.shape

    def b8_plain():
        return (*cascade_group_plain(gq, vq, eq, k, n_live=nl), group_topk_rows(gq, vq, rq, k))

    # beside it: the parent's chain (B8 for the margin, group_topk_rows for
    # the picks), B8 without rows, and the stable sort alone, the
    # yardstick of the pick half
    key = torch.randint(-(1 << 40), 1 << 40, (Gq, Bq), device="cuda")
    b8_extra = dict(
        chain_ms=device_time_ms(lambda: (cascade_group_kernel(gq, vq, eq, k, n_live=nl),
                                         group_topk_rows(gq, vq, rq, k))),
        margin_only_ms=device_time_ms(lambda: cascade_group_kernel(gq, vq, eq, k, n_live=nl)),
        sort_ms=device_time_ms(lambda: torch.sort(key, dim=1, descending=True, stable=True)),
    )
    log(f"[phase 5] cascade_group: the parent's chain (B8 + group_topk_rows) "
        f"{b8_extra['chain_ms'] * 1e3:.2f} us, B8 without rows "
        f"{b8_extra['margin_only_ms'] * 1e3:.2f} us, the stable sort of ({Gq}, {Bq}) int64 "
        f"{b8_extra['sort_ms'] * 1e3:.2f} us")
    entry(
        "cascade_group",
        lambda: cascade_group_kernel(gq, vq, eq, k, n_live=nl, rows=rq),
        b8_plain,
        # g, valid and rows read once, eps and n_live read; margin, exit
        # and k picks written
        nbytes=16 * Gq * Bq + 4 * Gq + 4 + 8 * Gq + 4 * k * Gq, ops=(k + 1) * Gq * Bq,
        shape=rmain["b8_shape"] + ", rows=", extra=b8_extra,
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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[phase 1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  driver {driver}  devices {torch.cuda.device_count()}")
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
    # every tree and lattice instantiation of mega_stage.cu's step kernel,
    # and every instantiation of its matrix step kernel, keeps its arrays in
    # registers
    steps = {}
    for mangled, res in _build.kernel_resources("mega_stage").items():
        label = _build.step_kernel_label(mangled)
        if label:
            steps[label] = res
    report["step_kernels"] = steps
    for label in sorted(k for k in steps if " tree " in k or " matrix " in k):
        log(f"[phase 2] {label}: {steps[label]['registers']} registers, "
            f"{steps[label]['stack']} bytes stack, {steps[label]['spill']} bytes spilled")
    held = {k: v for k, v in steps.items() if v["stack"] or v["spill"]}
    if len(steps) != 2 * 3 * (1 + 8) + 2 * 2 or held:
        return fail(f"step kernels: {len(steps)} built, stack or spills in {held}")

    phase_s = report["phase_s"] = {}
    # every degradation the ladder records is logged at warning level: only
    # phase 4i injects faults, so any other phase that logs one fails
    ladder = LadderWatch()
    logging.getLogger("repro_torch.api").addHandler(ladder)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        if name != "4i" and ladder.events:
            raise AssertionError(f"phase {name}: degradation events {ladder.events}")
        ladder.events.clear()
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
    rank_ctx = timed("4d", phase_ranking, report, launches, main_ctx)
    quant_ctx = timed("4e", phase_quant, report, launches, main_ctx, lattice_ctx)
    timed("4f", phase_gate, report)
    rank_stream_ctx = timed("4g", phase_rank_stream, report, launches, rank_ctx)
    timed("4h", phase_baselines, report, launches, main_ctx)
    timed("4i", phase_guarded, report, launches, main_ctx, ctx)
    timed("4j", phase_neural, report, launches, check)
    timed("4k", phase_families, report, launches)
    timed("4l", phase_decode, report, launches)
    timed("4m", phase_train, report, launches)

    # phase 5: times
    kernels = timed("5", phase_times, ctx, main_ctx, lattice_ctx, stream_ctx, rank_ctx,
                    quant_ctx, rank_stream_ctx, launches, check, report)
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
