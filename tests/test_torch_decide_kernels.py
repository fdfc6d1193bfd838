"""The decide kernels B8 (group decide with its top-k picks), B6 (lane
decide with the streaming step's compaction) and B2's step form (the
unfused batch stage's decide with its compaction) of the PyTorch port
against the JAX package on the CPU.

Inputs are made with numpy from seeds and go through both packages.  The
tolerance is zero: the arithmetic is f32 adds, compares and selects, so
every output is compared exactly (``g`` and margins by their bits).  Two
margin cases are compared by value instead of bits, because the reference
itself does not fix the bits there: a NaN margin (JAX keeps the sign of a
negative NaN, the port's subtraction gives a positive one) and a zero
margin between a -0.0 and a +0.0 (the reference's max reduction returns
either zero of a tie, and JAX and PyTorch return different ones).  Picks,
exits, ``g``, exit steps and pack positions carry no such freedom.

* B8's plain version with ``rows`` (``cascade_group_kernel`` on CPU
  tensors) equals ``cascade_group_pallas`` (interpret mode, as the JAX
  package's own tests run it) followed by JAX's ``group_topk_rows``, on
  groups with a valid NaN or -NaN, -inf on valid lanes and -0.0 / +0.0
  ties (``tests/test_torch_ranking.py`` holds ``group_topk_rows`` alone to
  the JAX function on such groups).
* B6's step form (``cascade_lane_step`` on CPU tensors) equals
  ``cascade_lane_pallas`` (interpret mode) on the scores masked by each
  lane's stage and the thresholds gathered at it, followed by the
  reference's cumsum compaction (``device_executor.py:1073-1076``).
* B2's step form (``cascade_chunk_step`` on CPU tensors) equals the
  reference's unfused batch stage (``device_executor.py:832-849``): each
  lane's partial sum gathered through its row id, the scores masked by the
  stage's column row, ``cascade_chunk_pallas`` (interpret mode), then the
  cumsum compaction, with the last stage's survivors kept.
* The launch geometry of both kernels, and the block-prefix combine that
  B6 and B2's step form run past 1024 lanes, as pure functions.
* ``run_grouped`` with a NaN document, the unfused ``run_stream`` past
  1024 lanes and the unfused batch ``DeviceExecutor.run`` (one step-form
  call a stage) against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.core import CascadePlan as JPlan
from repro.core import fit_qwyc as j_fit
from repro.kernels import device_executor as jde
from repro.kernels.cascade_kernel import (
    cascade_chunk_pallas,
    cascade_group_pallas,
    cascade_lane_pallas,
)
from repro_torch.convert import qwyc_model_from_numpy
from repro_torch.core import CascadePlan
from repro_torch.kernels.cascade_kernel import (
    MAX_CTA_GROUPS,
    MAX_GROUP_WIDTH,
    cascade_chunk_step,
    cascade_chunk_step_plain,
    cascade_group_kernel,
    cascade_lane_step,
    cascade_lane_step_plain,
    combine_blocks,
    group_geometry,
    group_topk_rows,
    lane_geometry,
)
from repro_torch.kernels import device_executor as tde
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
)

NEG_NAN = np.float32(-np.nan)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _same_margin(got, want) -> bool:
    """Bits, except by value where both are NaN or both are zero (see the
    module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got)
    if not np.array_equal(nan, np.isnan(want)):
        return False
    zero = (got == 0) & (want == 0)
    strict = ~nan & ~zero
    return np.array_equal(_bits(got[strict]), _bits(want[strict]))


def _groups(rng, G: int, B: int, k: int):
    """(g, valid, rows) of G groups in width B, each row a case: integer
    ties, ±0.0 ties, -inf on valid lanes, a valid NaN, a valid -NaN, a NaN
    on an invalid lane only, an empty group, then drawn groups."""
    g = rng.integers(-2, 3, size=(G, B)).astype(np.float32)
    g[G // 2 :] += rng.normal(scale=0.3, size=(G - G // 2, B)).astype(np.float32)
    valid = (rng.uniform(size=(G, B)) < 0.75).astype(np.int32)
    valid[:6, 0] = 1  # every special row has a valid lane 0
    g[1] = np.where(rng.uniform(size=B) < 0.5, -0.0, 0.0).astype(np.float32)
    g[2, ::2] = -np.inf
    g[3, rng.integers(B)] = np.nan
    valid[3] = 1
    g[4, 0] = NEG_NAN
    g[5, 0] = np.nan
    valid[5, 0] = 0
    valid[6] = 0
    rows = rng.integers(0, 10_000, size=(G, B)).astype(np.int64)
    return g, valid, rows


@pytest.mark.parametrize("n_live", [None, 0, 9, "host"])
@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("B", [4, 32, 40])
def test_cascade_group_rows_plain_matches_pallas(B, k, n_live):
    """B8's plain version with ``rows``: margin, exit and picks equal
    ``cascade_group_pallas`` + JAX's ``group_topk_rows``."""
    rng = np.random.default_rng(7 * B + k)
    G = 21
    g, valid, rows = _groups(rng, G, B, k)
    eps = rng.uniform(0.0, 1.5, size=G).astype(np.float32)
    eps[7], eps[8] = np.inf, 0.0
    nl = {None: None, 0: 0, 9: 9, "host": 15}[n_live]
    jm, je = cascade_group_pallas(
        jnp.asarray(g), jnp.asarray(valid), jnp.asarray(eps), k, interpret=True,
        n_live=None if nl is None else jnp.int32(nl),
    )
    jp = np.asarray(jde.group_topk_rows(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(rows), k))
    nl_t = torch.tensor(nl, dtype=torch.int32) if n_live in (0, 9) else nl
    m, e, p = cascade_group_kernel(
        torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(eps), k,
        n_live=nl_t, rows=torch.from_numpy(rows),
    )
    assert _same_margin(m.numpy(), jm)
    assert np.array_equal(e.numpy(), np.asarray(je))
    assert np.array_equal(p.numpy(), jp)
    # without rows the wrapper keeps the reference's two outputs
    m2, e2 = cascade_group_kernel(
        torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(eps), k, n_live=nl_t
    )
    assert torch.equal(e2, e) and np.array_equal(_bits(m2.numpy()), _bits(m.numpy()))
    # a NaN group with more than k documents never exits
    if valid[3].sum() > k:
        assert np.isnan(m[3].item()) and e[3].item() == 0


def _lane_case(seed: int, cap: int, S: int, W: int, last_w: int):
    """A mixed-stage lane buffer: stages spread over S (every stage among
    the first lanes), the last stage ``last_w`` columns wide (its padded
    columns ±inf, masked), some lanes with ±inf thresholds that never
    exit."""
    rng = np.random.default_rng(seed)
    stage = rng.integers(0, S, size=cap).astype(np.int32)
    stage[: min(S, cap)] = np.arange(min(S, cap))
    ep = rng.uniform(0.3, 2.0, size=(S, W)).astype(np.float32)
    en = -rng.uniform(0.3, 2.0, size=(S, W)).astype(np.float32)
    col = np.ones((S, W), bool)
    col[S - 1, last_w:] = False
    ep[S - 1, last_w:], en[S - 1, last_w:] = np.inf, -np.inf
    ep[1], en[1] = np.inf, -np.inf
    scores = rng.normal(size=(cap, W)).astype(np.float32)
    g0 = rng.normal(scale=0.5, size=cap).astype(np.float32)
    return g0, scores, stage, ep, en, col


@pytest.mark.parametrize("n_live", [None, 0, 45, "host"])
@pytest.mark.parametrize("cap", [64, 200, 1100])
def test_cascade_lane_step_plain_matches_pallas(cap, n_live):
    """B6's step form on the CPU: the six outputs equal
    ``cascade_lane_pallas`` on the masked scores and gathered thresholds,
    then the reference's cumsum compaction, with lanes at the last stage
    left out."""
    S, W = 9, 6
    nl = {None: None, 0: 0, 45: 45, "host": cap - 3}[n_live]
    g0, scores, stage, ep, en, col = _lane_case(cap + S, cap, S, W, 4)
    masked = np.where(col[stage], scores, 0.0).astype(np.float32)
    jg, ja, jd, jx = cascade_lane_pallas(
        jnp.asarray(g0), jnp.asarray(masked), jnp.asarray(ep[stage]), jnp.asarray(en[stage]),
        block_n=64, interpret=True, n_valid=None if nl is None else jnp.int32(nl),
    )
    lane = np.arange(cap)
    keep = (lane < (cap if nl is None else nl)) & (np.asarray(ja) != 0) & (stage < S - 1)
    pos = np.cumsum(keep.astype(np.int32)) - 1
    want_pack = np.where(keep, pos, cap)
    t = torch.from_numpy
    nl_t = torch.tensor(nl, dtype=torch.int32) if n_live in (0, 45) else nl
    got = cascade_lane_step(t(g0), t(scores), t(stage), t(ep), t(en), t(col), n_valid=nl_t,
                            block_n=64)
    g, act, dec, ex, pack, n_keep = (x.numpy() for x in got)
    assert np.array_equal(_bits(g), _bits(jg))
    assert np.array_equal(act, np.asarray(ja)) and np.array_equal(dec, np.asarray(jd))
    assert np.array_equal(ex, np.asarray(jx))
    assert pack.dtype == np.int32 and np.array_equal(pack, want_pack)
    assert got[5].dtype == torch.int32 and got[5].shape == () and int(n_keep) == keep.sum()
    assert all(torch.equal(a, b) for a, b in zip(got, cascade_lane_step_plain(
        t(g0), t(scores), t(stage), t(ep), t(en), t(col), nl_t)))
    if nl != 0:
        assert keep.any() and (np.asarray(jx) > 0).any()


def _chunk_step_case(seed: int, cap: int, W: int, n_live: int):
    """A batch stage's buffers: the (cap + 1,) partial sums by slot (the
    trash slot at cap, -0.0 entries), row ids permuted over the first
    n_live slots and the trash slot past them, NaN scores, and S = 5
    stage tables: stage 1 at ±inf (never exits), stage 4 the ragged last
    one (its padded columns ±inf and masked)."""
    rng = np.random.default_rng(seed)
    S = 5
    g = rng.normal(scale=0.5, size=cap + 1).astype(np.float32)
    g[::7] = -0.0
    rows = np.full(cap, cap, np.int64)
    rows[:n_live] = rng.permutation(cap)[:n_live]
    scores = rng.normal(size=(cap, W)).astype(np.float32)
    scores[rng.integers(cap), rng.integers(W)] = np.nan
    ep = rng.uniform(0.3, 2.0, size=(S, W)).astype(np.float32)
    en = -rng.uniform(0.3, 2.0, size=(S, W)).astype(np.float32)
    ep[1], en[1] = np.inf, -np.inf
    col = np.ones((S, W), bool)
    col[S - 1, max(1, W - 2):] = False
    ep[S - 1, max(1, W - 2):], en[S - 1, max(1, W - 2):] = np.inf, -np.inf
    return g, rows, scores, ep, en, col


@pytest.mark.parametrize("n_valid", [None, 0, "mid", "cap", "host"])
@pytest.mark.parametrize("W", [8, 3])
@pytest.mark.parametrize("cap", [1, 31, 256, 1025])
def test_cascade_chunk_step_plain_matches_pallas(cap, W, n_valid):
    """B2's step form on the CPU at a mid stage, a ±inf stage and the
    ragged last stage: the six outputs equal the reference's unfused batch
    stage (gather through the row ids, column mask, ``cascade_chunk_pallas``
    in interpret mode, cumsum compaction), the last stage's survivors
    kept; ``g`` by its bits."""
    nl = {None: None, 0: 0, "mid": cap // 2 + 1, "cap": cap, "host": max(cap - 3, 0)}[n_valid]
    live = cap if nl is None else min(nl, cap)
    g, rows, scores, ep, en, col = _chunk_step_case(cap * 10 + W, cap, W, live)
    t = torch.from_numpy
    nl_t = torch.tensor(nl, dtype=torch.int32) if n_valid in (0, "mid", "cap") else nl
    lane = np.arange(cap)
    kept = 0
    for s in (2, 1, 4):
        masked = jnp.where(jnp.asarray(col[s])[None, :], jnp.asarray(scores), 0.0)
        jg, ja, jd, jx = cascade_chunk_pallas(
            jnp.take(jnp.asarray(g), jnp.asarray(rows), axis=0), masked,
            jnp.asarray(ep[s]), jnp.asarray(en[s]), 0, block_n=64, interpret=True,
            n_valid=None if nl is None else jnp.int32(nl),
        )
        keep = (np.asarray(ja) != 0) & (lane < live)
        want_pack = np.where(keep, np.cumsum(keep.astype(np.int32)) - 1, cap)
        got = cascade_chunk_step(t(g), t(rows), t(scores), s, t(ep), t(en), t(col),
                                 n_valid=nl_t, block_n=64)
        gn, act, dec, ex, pack, n_keep = (x.numpy() for x in got)
        assert np.array_equal(_bits(gn), _bits(jg)), s
        assert np.array_equal(act, np.asarray(ja)) and np.array_equal(dec, np.asarray(jd))
        assert np.array_equal(ex, np.asarray(jx))
        assert pack.dtype == np.int32 and np.array_equal(pack, want_pack)
        assert got[5].dtype == torch.int32 and got[5].shape == () and int(n_keep) == keep.sum()
        plain = cascade_chunk_step_plain(t(g), t(rows), t(scores), s, t(ep), t(en), t(col), nl_t)
        assert torch.equal(got[0].view(torch.int32), plain[0].view(torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(got[1:], plain[1:]))
        if s == 1:  # ±inf: every live lane survives (a NaN lane too)
            assert int(n_keep) == live and not ex.any()
        kept += int(n_keep)
    if live > 1:
        assert kept > 0


@pytest.mark.parametrize("block_n", [1, 32, 64, 100, 256, 1024])
@pytest.mark.parametrize("cap", [1, 31, 32, 256, 1024, 1025, 5000])
def test_lane_geometry(cap, block_n):
    """B6's launch covers every lane; its compaction modes take whole
    warps, one CTA up to 1024 lanes."""
    mode, blocks, threads = lane_geometry(cap, block_n, compact=False)
    assert (mode, threads) == (0, block_n) and blocks * threads >= cap > (blocks - 1) * threads
    mode, blocks, threads = lane_geometry(cap, block_n, compact=True)
    assert threads % 32 == 0 and threads <= 1024 and blocks * threads >= cap
    if cap <= 1024:
        assert (mode, blocks) == (1, 1) and threads < cap + 32
    else:
        assert mode == 2 and threads == -(-block_n // 32) * 32
        assert (blocks - 1) * threads < cap


def test_lane_geometry_and_step_refuse_bad_blocks():
    for bn in (0, 1025):
        with pytest.raises(ValueError, match="block_n"):
            lane_geometry(64, bn, compact=True)


@pytest.mark.parametrize("G", [1, 8, 37, 256, 2000])
@pytest.mark.parametrize("B", [1, 4, 32, 33, 256, 1024, 1500, MAX_GROUP_WIDTH])
def test_group_geometry(G, B):
    """B8: a warp a group up to 32 lanes, spread over the SMs; a CTA a
    group past that, its scores in shared memory."""
    sms = 132
    blocks, threads, smem = group_geometry(G, B, sms)
    if B <= 32:
        per = threads // 32
        assert threads % 32 == 0 and 1 <= per <= MAX_CTA_GROUPS and smem == 0
        assert blocks * per >= G > (blocks - 1) * per
        assert blocks >= min(G, sms) // 2  # a serving wave spreads over the card
    else:
        assert blocks == G and smem == 4 * B
        assert threads % 32 == 0 and threads == min(1024, -(-B // 32) * 32)


def test_group_geometry_raises_past_its_widths():
    for B in (0, MAX_GROUP_WIDTH + 1):
        with pytest.raises(ValueError, match="MAX_GROUP_WIDTH"):
            group_geometry(8, B, 132)


@pytest.mark.parametrize("bn", [32, 64, 96])
@pytest.mark.parametrize("cap", [1025, 1300, 2048])
def test_combine_blocks_equals_cumsum_compaction(cap, bn):
    """The block-prefix path of B6 past 1024 lanes: per-block inclusive
    prefixes minus one and counts, combined, give the reference's cumsum
    pack positions and count."""
    rng = np.random.default_rng(cap + bn)
    act = torch.from_numpy((rng.uniform(size=cap) < 0.6).astype(np.int32))
    stop = torch.from_numpy(rng.uniform(size=cap) < 0.2)
    keep = act.bool() & ~stop
    nb = -(-cap // bn)
    padded = torch.zeros(nb * bn, dtype=torch.int32)
    padded[:cap] = keep.to(torch.int32)
    pfx = (torch.cumsum(padded.reshape(nb, bn), dim=1, dtype=torch.int32) - 1).reshape(-1)[:cap]
    cnt = padded.reshape(nb, bn).sum(dim=1, dtype=torch.int32)
    g = torch.zeros(cap)
    *_, pack, n_keep = combine_blocks((g, act, act, act, pfx, cnt), cap, bn, stop=stop)
    want = torch.where(keep, torch.cumsum(keep, dim=0, dtype=torch.int32) - 1, cap)
    assert torch.equal(pack, want) and int(n_keep) == int(keep.sum())


def _ragged_groups(seed, G=19, T=24, lo=1, hi=30):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=G).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), T)) * 0.15 + quality[:, None]
    return F, sizes


@pytest.mark.parametrize("fixture", ["clean", "NaN document"])
def test_run_grouped_matches_jax(fixture):
    """The grouped loop with B8's picks: verdicts, exit stages and margins
    equal JAX's ``run_grouped``, also where a document scores NaN (its
    group never exits and ranks nothing)."""
    from repro.ranking import bucketing as jb
    from repro.ranking import fit_grouped as j_fit_grouped
    from repro_torch.convert import grouped_plan_from_numpy

    F, sizes = _ragged_groups(11)
    k = 4
    jgp = j_fit_grouped(F, sizes, k, alpha=0.1, chunk_t=6)
    m = jgp.model
    gp = grouped_plan_from_numpy(
        qwyc_model_from_numpy(m.order, m.eps_pos, m.eps_neg, m.beta, m.costs, m.alpha, m.mode),
        jgp.eps_g, jgp.k, jgp.buckets, jgp.plan.chunk_t,
        train_exit_stage=jgp.train_exit_stage, train_disagreement=jgp.train_disagreement,
    )
    ordered = np.ascontiguousarray(F.astype(np.float32)[:, gp.plan.order])
    off = jb.group_offsets(sizes)
    nan_group = int(np.flatnonzero(sizes > k)[0])
    if fixture == "NaN document":  # a document of a group of more than k
        ordered[off[nan_group] + 1, 0] = np.nan
    dplan = DevicePlan.from_plan(gp.plan)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=16, device="cpu")
    jdplan = jde.DevicePlan.from_plan(jgp.plan)
    jex = jde.DeviceExecutor(jdplan, scorer=jde.matrix_stage_scorer(jdplan), block_n=16,
                             megakernel=False)
    for b, gidx in sorted(jb.pack_by_bucket(sizes, jgp.buckets).items()):
        layout = jb.bucket_layout(sizes[gidx], b, offsets=off[gidx])
        r = ex.run_grouped(ordered, *layout, len(gidx), gp.eps_g, k)
        jr = jex.run_grouped(ordered, *layout, len(gidx), jgp.eps_g, k)
        assert np.array_equal(r.verdicts, np.asarray(jr.verdicts))
        assert np.array_equal(r.exit_stage, np.asarray(jr.exit_stage))
        assert _same_margin(r.margin, jr.margin)
        if fixture == "NaN document" and nan_group in gidx:
            i = int(np.flatnonzero(gidx == nan_group)[0])
            assert (r.verdicts[i] == -1).all() and r.exit_stage[i] == gp.S


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_run_stream_unfused_past_1024_lanes_matches_jax(mode):
    """The unfused streaming loop (``lane_fn`` + B6's step form) at a
    capacity past one CTA of lanes: every field of the result equals JAX's
    ``run_stream``."""
    rng = np.random.default_rng(71)
    n = 1300
    F = make_scores(rng, n=n, t=20)
    jm = j_fit(F, beta=0.0, alpha=0.02, mode=mode)
    m = qwyc_model_from_numpy(jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs,
                              jm.alpha, jm.mode)
    x = F[:, jm.order].astype(np.float32)
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=6))
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=6))
    jex = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=64,
                             megakernel=False)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
                        megakernel=False, device="cpu")
    arr = np.floor(np.cumsum(rng.exponential(1.0 / 400, size=n))).astype(np.int32)
    want = jex.run_stream(x, n, arrivals=arr, capacity=1088)
    got = ex.run_stream(x, n, arrivals=arr, capacity=1088)
    assert got.capacity == 1088 > 1024
    for key in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
        assert np.array_equal(getattr(got, key), np.asarray(getattr(want, key))), key
    assert np.array_equal(_bits(got.g_final), _bits(want.g_final))
    assert (got.steps_run, got.scores_computed) == (int(want.steps_run), int(want.scores_computed))


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("n", [300, 1100])
def test_device_executor_unfused_matches_jax(n, mode):
    """The unfused batch stage loop (the matrix scorer + B2's step form,
    one call a stage) at one CTA of lanes and past it (1100 rows: cap 1152,
    block prefixes and a combine), a ragged last stage (T 47, chunk 6) and
    a row of NaN scores: decisions, exits, ``g_final`` (bits) and billing
    equal JAX's ``DeviceExecutor(megakernel=False)``."""
    rng = np.random.default_rng(n + len(mode))
    F = make_scores(rng, n=n, t=47)
    jm = j_fit(F, beta=0.0, alpha=0.02, mode=mode)
    m = qwyc_model_from_numpy(jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs,
                              jm.alpha, jm.mode)
    x = F[:, jm.order].astype(np.float32)
    x[5] = np.nan
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=6))
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=6))
    jex = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=64,
                             megakernel=False)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
                        megakernel=False, device="cpu")
    order = rng.permutation(n)
    want = jex.run(x, n, row_order=order)
    calls = []

    def counted(*args, **kw):
        calls.append(args[3])
        return cascade_chunk_step(*args, **kw)

    orig, tde.cascade_chunk_step = tde.cascade_chunk_step, counted
    try:
        got = ex.run(x, n, row_order=order)
    finally:
        tde.cascade_chunk_step = orig
    assert calls == list(range(dplan.S))
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    assert np.array_equal(_bits(got.g_final), _bits(want.g_final))
    assert [(c.n_in, c.n_exited, c.scores_computed) for c in got.chunk_stats] == [
        (c.n_in, c.n_exited, c.scores_computed) for c in want.chunk_stats]
    assert got.scores_computed == want.scores_computed
    assert got.exit_step[5] == 47  # the NaN row walks every stage
