"""The port's kernels on the CPU: each plain version against the JAX
package (Pallas in interpret mode, or its jnp oracle) and against the
port's own unfused path, with zero tolerance.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executor import decide_chunk_reference
from repro.ensembles.gbt import apply_gbt as j_apply_gbt
from repro.kernels import ref as j_ref
from repro.core import QWYCModel as JModel
from repro.core import evaluate_cascade as j_evaluate_cascade
from repro.kernels.cascade_kernel import cascade_chunk_pallas, cascade_pallas
from repro_torch.core.executor import CascadePlan
from repro_torch.ensembles.gbt import apply_gbt
from repro_torch.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_chunk_plain,
    cascade_geometry,
    cascade_kernel,
    cascade_plain,
)
from repro_torch.kernels.device_executor import (
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.kernels.megakernel import mega_stage, mega_stage_plain
from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain


def _chunk_case(seed, m=100, ct=8, pad_cols=0):
    rng = np.random.default_rng(seed)
    g0 = rng.normal(size=m).astype(np.float32)
    chunk = rng.normal(size=(m, ct)).astype(np.float32)
    eps_pos = rng.uniform(0.5, 2.5, size=ct).astype(np.float32)
    eps_neg = -rng.uniform(0.5, 2.5, size=ct).astype(np.float32)
    if pad_cols:
        chunk[:, ct - pad_cols:] = 0.0
        eps_pos[ct - pad_cols:] = np.inf
        eps_neg[ct - pad_cols:] = -np.inf
    return g0, chunk, eps_pos, eps_neg


@pytest.mark.parametrize("n_valid", [None, 0, 37, 64, 100])
@pytest.mark.parametrize("pad_cols", [0, 3])
def test_cascade_chunk_plain_matches_pallas_and_reference(n_valid, pad_cols):
    g0, chunk, ep, en = _chunk_case(7, pad_cols=pad_cols)
    t0 = 16
    out = cascade_chunk_plain(
        torch.from_numpy(g0), torch.from_numpy(chunk), torch.from_numpy(ep),
        torch.from_numpy(en), t0, n_valid=n_valid,
    )
    jout = cascade_chunk_pallas(
        jnp.asarray(g0), jnp.asarray(chunk), jnp.asarray(ep), jnp.asarray(en),
        t0, block_n=64, interpret=True, n_valid=n_valid,
    )
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the wrapper on a CPU tensor is the plain version
    wrapped = cascade_chunk_kernel(
        torch.from_numpy(g0), torch.from_numpy(chunk), torch.from_numpy(ep),
        torch.from_numpy(en), t0, n_valid=n_valid,
    )
    for a, b in zip(out, wrapped):
        assert torch.equal(a, b)
    if n_valid is None:
        g, act, dec, ex = decide_chunk_reference(g0, chunk, ep, en, t0)
        np.testing.assert_array_equal(out[0].numpy(), g)
        np.testing.assert_array_equal(out[1].numpy().astype(bool), act)
        np.testing.assert_array_equal(out[2].numpy().astype(bool), dec)
        np.testing.assert_array_equal(out[3].numpy(), ex)


def _forest(seed, T=20, depth=4, d=9, n=150):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, d, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(size=(T, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    return feats, thrs, leaves, x


def test_tree_oracle_matches_jax_oracle():
    feats, thrs, leaves, x = _forest(3)
    ours = ref.gbt_scores_ref(*map(torch.from_numpy, (feats, thrs, leaves, x)))
    theirs = j_ref.gbt_scores_ref(*map(jnp.asarray, (feats, thrs, leaves, x)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_full_ensemble_logit_matches_jax():
    """Leaves on a 1/1024 grid keep every sum exact, so the two packages'
    summation orders give the same bits."""
    feats, thrs, leaves, x = _forest(5)
    leaves = (np.round(leaves * 1024) / 1024).astype(np.float32)
    ours = apply_gbt(
        dict(zip(("feats", "thrs", "leaves"), map(torch.from_numpy, (feats, thrs, leaves)))),
        torch.from_numpy(x), base_score=-0.25,
    )
    theirs = j_apply_gbt(
        dict(zip(("feats", "thrs", "leaves"), map(jnp.asarray, (feats, thrs, leaves)))),
        jnp.asarray(x), base_score=-0.25,
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("seed", [0, 1])
def test_cascade_oracle_matches_jax_oracle(seed):
    """Scores on a 1/8 grid keep the cumulative sums exact in either
    package's scan order; thresholds sit between grid points."""
    rng = np.random.default_rng(seed)
    T = 24
    F = (rng.integers(-8, 9, size=(300, T)) / 8).astype(np.float32)
    ep = (rng.integers(4, 24, size=T) / 8 + 1 / 16).astype(np.float32)
    en = -(rng.integers(4, 24, size=T) / 8 + 1 / 16).astype(np.float32)
    ours = ref.cascade_ref(*map(torch.from_numpy, (F, ep, en)), 0.0)
    theirs = j_ref.cascade_ref(*map(jnp.asarray, (F, ep, en)), 0.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int((ours[1] < T).sum()) < F.shape[0]


def _b1_case(seed, n, T, grid, full_eval_cols=0, never_exit_rows=0):
    """An ordered score matrix with thresholds.  ``grid`` puts scores on a
    1/8 grid and thresholds between grid points, so every cumulative sum is
    exact in f32 and f64 and in any summation order.  The last
    ``full_eval_cols`` positions get the ±inf "full evaluation"
    thresholds; the first ``never_exit_rows`` rows score 0 and never exit."""
    rng = np.random.default_rng(seed)
    if grid:
        F = (rng.integers(-8, 9, size=(n, T)) / 8).astype(np.float32)
        ep = (rng.integers(4, 24, size=T) / 8 + 1 / 16).astype(np.float32)
        en = -(rng.integers(4, 24, size=T) / 8 + 1 / 16).astype(np.float32)
    else:
        F = rng.normal(size=(n, T)).astype(np.float32)
        ep = rng.uniform(1.0, 4.0, size=T).astype(np.float32)
        en = -rng.uniform(1.0, 4.0, size=T).astype(np.float32)
    if full_eval_cols:
        ep[T - full_eval_cols:], en[T - full_eval_cols:] = np.inf, -np.inf
    F[:never_exit_rows] = 0.0
    return F, ep, en


@pytest.mark.parametrize(
    "grid,T,chunk_t,full_eval_cols,beta",
    [(True, 37, 8, 0, 0.0), (True, 24, 5, 24, 0.0), (True, 40, 8, 6, -0.5),
     (False, 37, 8, 0, 0.0), (False, 41, 4, 41, 0.25), (False, 13, 16, 3, 0.0)],
)
def test_cascade_plain_matches_pallas_ref_and_evaluate(grid, T, chunk_t, full_eval_cols, beta):
    """Plain B1 against ``cascade_pallas`` (interpret mode) on any scores,
    and on grid scores also against ``ref.cascade_ref`` and
    ``evaluate_cascade``: decisions and 1-based exit steps equal, with T
    not a multiple of ``chunk_t``, rows that never exit, and ±inf
    thresholds that send every row to the full ensemble."""
    F, ep, en = _b1_case(T + chunk_t, 300, T, grid, full_eval_cols, never_exit_rows=7)
    got = cascade_plain(*map(torch.from_numpy, (F, ep, en)), beta, chunk_t=chunk_t)
    assert got[0].dtype == got[1].dtype == torch.int32
    wrapped = cascade_kernel(*map(torch.from_numpy, (F, ep, en)), beta, chunk_t=chunk_t)
    via_ops = ops.cascade_decide(*map(torch.from_numpy, (F, ep, en)), beta, chunk_t=chunk_t)
    for a, b, c in zip(got, wrapped, via_ops):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = cascade_pallas(
        *map(jnp.asarray, (F, ep, en)), beta, block_n=64, chunk_t=chunk_t, interpret=True
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dec, ex = (a.numpy() for a in got)
    assert (ex[:7] == T).all()  # rows that never exit
    if full_eval_cols == T:
        assert (ex == T).all()
    else:
        assert (ex < T).any()
    if grid:
        for a, b in zip(got, j_ref.cascade_ref(*map(jnp.asarray, (F, ep, en)), beta)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        m = JModel(
            order=np.arange(T), eps_pos=ep.astype(np.float64),
            eps_neg=en.astype(np.float64), beta=beta, costs=np.ones(T), alpha=0.0,
            mode="both",
        )
        ev = j_evaluate_cascade(m, F.astype(np.float64))
        np.testing.assert_array_equal(dec.astype(bool), ev["decisions"])
        np.testing.assert_array_equal(ex, ev["exit_step"])


@pytest.mark.parametrize("chunk_t", [1, 7, 32, 33])
@pytest.mark.parametrize("block_n", [1, 32, 64, 100, 1024])
def test_cascade_plain_matches_pallas_every_block(block_n, chunk_t):
    """B1's ``block_n`` and ``chunk_t`` change no result: the plain version
    (and the wrapper on CPU tensors, which takes every ``block_n`` the
    kernel's geometry accepts) equals ``cascade_pallas`` at the same
    ``block_n`` and ``chunk_t``, with T odd (the kernel's unaligned rows)
    and not a multiple of either, rows that never exit and ±inf
    thresholds at the end."""
    F, ep, en = _b1_case(block_n + chunk_t, 45, 37, False, 3, never_exit_rows=4)
    args = tuple(map(torch.from_numpy, (F, ep, en)))
    got = cascade_kernel(*args, 0.1, block_n=block_n, chunk_t=chunk_t)
    for a, b in zip(got, cascade_plain(*args, 0.1, chunk_t=chunk_t)):
        assert torch.equal(a, b)
    want = cascade_pallas(
        *map(jnp.asarray, (F, ep, en)), 0.1, block_n=block_n, chunk_t=chunk_t, interpret=True
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1][:4] == 37).all() and (got[1] < 37).any()


@pytest.mark.parametrize("block_n", [1, 32, 33, 64, 256, 1024])
@pytest.mark.parametrize("n", [1, 31, 33, 2000, 4096, 100_000])
def test_cascade_geometry(n, block_n):
    """B1's launch: a CTA of one warp of 32 rows, every row covered once,
    whatever ``block_n`` in [1, 1024] asks for (N = 2000: 63 CTAs, not 8);
    ``block_n`` outside it is refused."""
    blocks, threads = cascade_geometry(n, block_n)
    assert threads == 32 and (blocks - 1) * threads < n <= blocks * threads
    if n == 2000:
        assert blocks == 63
    for bad in (0, 1025):
        with pytest.raises(ValueError, match="block_n"):
            cascade_geometry(n, bad)


def test_cascade_plain_decides_survivors_with_f32_beta():
    """A row still active at T compares its f32 sum with beta rounded to
    f32, as the reference compares with its static Python float."""
    F = np.array([[0.1, 0.2]], dtype=np.float32)
    g = np.float32(np.float32(0.1) + np.float32(0.2))
    inf = np.full(2, np.inf, np.float32)
    for beta in (float(g), float(g) + 1e-12, float(np.nextafter(g, np.float32(1)))):
        got = cascade_plain(torch.from_numpy(F), torch.from_numpy(inf), -torch.from_numpy(inf), beta)
        want = cascade_pallas(jnp.asarray(F), jnp.asarray(inf), -jnp.asarray(inf), beta, interpret=True)
        assert int(got[0][0]) == int(want[0][0])
        assert int(got[1][0]) == int(want[1][0]) == 2


@pytest.mark.parametrize(
    "t0,t1,use_rows,n_valid",
    [(0, None, False, None), (4, 12, False, None), (3, 11, True, None),
     (3, 11, True, 70), (0, 20, True, 0), (5, 6, False, 130)],
)
def test_gbt_scores_plain_matches_oracle(t0, t1, use_rows, n_valid):
    feats, thrs, leaves, x = _forest(4)
    block_n = 64
    rows = np.random.default_rng(1).permutation(x.shape[0])[:120] if use_rows else None
    args = [torch.from_numpy(a) for a in (feats, thrs, leaves, x)]
    kw = dict(block_n=block_n, t0=t0, t1=t1, n_valid=n_valid,
              rows=None if rows is None else torch.from_numpy(rows))
    out = gbt_scores_plain(*args, **kw)
    assert torch.equal(out, gbt_scores_kernel(*args, **kw))
    xs = x if rows is None else x[rows]
    t1_ = feats.shape[0] if t1 is None else t1
    want = np.asarray(
        j_ref.gbt_scores_ref(
            jnp.asarray(feats[t0:t1_]), jnp.asarray(thrs[t0:t1_]),
            jnp.asarray(leaves[t0:t1_]), jnp.asarray(xs),
        )
    )
    if n_valid is not None:  # row blocks at or past the live count emit 0
        dead = np.arange(xs.shape[0]) // block_n * block_n >= n_valid
        want = np.where(dead[:, None], 0.0, want)
    np.testing.assert_array_equal(out.numpy(), want)


def _stage_case(seed, variant, n=120, T=21, chunk_t=8, lead_t=1):
    """A plan with a narrow lead stage and a ragged last stage, survivor
    buffers with retired rows scattered mid-block."""
    feats, thrs, leaves, x = _forest(seed, T=T, n=n)
    rng = np.random.default_rng(seed)
    plan = CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(1.0, 4.0, size=T),
        eps_neg=-rng.uniform(1.0, 4.0, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=chunk_t, lead_t=lead_t,
    )
    dplan = DevicePlan.from_plan(plan)
    if variant == "tree":
        scorer = tree_stage_scorer(dplan, feats, thrs, leaves, device="cpu")
        xop = scorer.prepare(x)
    elif variant == "lattice":
        S = 4
        theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
        lfeats = np.stack([rng.choice(x.shape[1], S, replace=False) for _ in range(T)])
        scorer = lattice_stage_scorer(dplan, theta, lfeats, device="cpu")
        xop = scorer.prepare(x)
    else:
        F = ref.gbt_scores_ref(*map(torch.from_numpy, (feats, thrs, leaves, x)))
        scorer = matrix_stage_scorer(dplan, device="cpu")
        xop = scorer.prepare(F.numpy())
    return dplan, scorer, xop, rng


def _unfused_stage(dplan, scorer, x, rows, g_rows, s, n_active, block_n):
    """The port's multi-kernel stage: B3 or B5 -> column mask -> B2 ->
    cumsum pack."""
    cap = rows.shape[0]
    t0 = int(dplan.stage_t0[s])
    scores = scorer.fn(x, rows, t0, n_active)
    scores = torch.where(torch.from_numpy(dplan.col_valid[s])[None, :], scores, 0.0)
    g, act, dec, ex = cascade_chunk_kernel(
        g_rows, scores, torch.from_numpy(dplan.eps_pos[s]),
        torch.from_numpy(dplan.eps_neg[s]), 0, block_n=block_n, n_valid=n_active,
    )
    keep = act.bool() & (torch.arange(cap) < n_active)
    pack = torch.where(keep, torch.cumsum(keep, 0, dtype=torch.int32) - 1, cap)
    return g, act, dec, ex, pack, keep.sum(dtype=torch.int32)


@pytest.mark.parametrize("variant", ["tree", "matrix", "lattice"])
@pytest.mark.parametrize("n_active", [0, 1, 63, 64, 100, 120])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_mega_stage_plain_matches_unfused_stage(variant, n_active, stage):
    dplan, scorer, x, rng = _stage_case(11, variant)
    cap = 128
    # survivor buffer: a permutation of batch rows, trash (= cap) past n_active
    rows = torch.full((cap,), cap, dtype=torch.int64)
    rows[:n_active] = torch.from_numpy(rng.permutation(x.shape[0])[:n_active])
    # the operand padded to cap rows plus its trash row at index cap
    xpad = torch.nn.functional.pad(x, (0, 0, 0, cap + 1 - x.shape[0]))
    g_rows = torch.from_numpy(rng.normal(scale=0.5, size=cap).astype(np.float32))
    nv = torch.tensor(n_active, dtype=torch.int32)
    t0 = int(dplan.stage_t0[stage])
    eps_pos, eps_neg = torch.from_numpy(dplan.eps_pos), torch.from_numpy(dplan.eps_neg)
    fused = mega_stage(
        scorer.slabs, xpad[rows], g_rows, stage, t0, nv, eps_pos, eps_neg, block_n=64
    )
    unfused = _unfused_stage(dplan, scorer, xpad, rows, g_rows, stage, nv, 64)
    valid = torch.arange(cap) < n_active
    # outputs of live lanes agree exactly; dead lanes only need to be inert
    for a, b in zip(fused[:4], unfused[:4]):
        assert torch.equal(a[valid], b[valid])
    assert torch.equal(fused[4], unfused[4])  # pack
    assert torch.equal(fused[5], unfused[5])  # n_keep
    assert not fused[1][~valid].any() and not fused[3][~valid].any()
    raw = mega_stage_plain(
        scorer.slabs, xpad[rows], g_rows, stage, t0, nv, eps_pos, eps_neg, block_n=64
    )
    assert raw[5].shape == (cap // 64,) and int(raw[5].sum()) == int(fused[5])
    if n_active >= 63:  # the case is not trivial: rows retire mid-block
        exited = fused[3][valid] > 0
        assert exited.any() and (~exited).any()
