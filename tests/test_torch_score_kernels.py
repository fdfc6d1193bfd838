"""The score kernels B3 (oblivious trees) and B5 (lattices) on the CPU:
their plain versions against the JAX package's oracles, bit for bit, at
the shapes the kernels' launch geometry tells apart, and that geometry
(B3's tiles and passes, B5's regime) as pure functions of the shapes.

``gbt_scores_pallas`` and ``lattice_scores_pallas`` do not run under the
installed jax (``pl.load``, ROADMAP C1), so the plain versions are held
against ``repro.kernels.ref`` and ``repro.ensembles.gbt``, which the
Pallas kernels' own tests use as their oracles.  The CUDA kernels are
held against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ensembles.gbt import apply_gbt_scores as j_apply_gbt_scores
from repro.kernels import ref as j_ref
from repro_torch.core.executor import CascadePlan
from repro_torch.kernels import lattice_kernel as lk
from repro_torch.kernels import tree_kernel as tk_
from repro_torch.kernels.device_executor import DevicePlan, tree_stage_scorer
from repro_torch.kernels.lattice_kernel import lattice_scores_plain
from repro_torch.kernels.tree_kernel import gbt_scores_plain

H100_SMS = 132
BLOCK_N = 16
N_X = 70  # rows of x; the row gathers index past both ends


def _rows(rng, n):
    """n row ids with negative and past-the-end ones (clamped)."""
    rows = rng.integers(-5, N_X + 5, size=n)
    rows[:2] = (-3, N_X + 2)[:n]
    return rows.astype(np.int64)


def _live(n, n_valid):
    """The plain versions' mask: rows whose block starts below n_valid."""
    if n_valid is None:
        return np.ones(n, bool)
    return np.arange(n) // BLOCK_N * BLOCK_N < int(n_valid)


# (rows gather or None, n_valid): None, 0, partial and all, as an int and
# as a tensor, with a ragged last block (n = 45 is not a multiple of 16)
CASES = [
    (None, None), (None, 0), (None, 20), (None, 45),
    (45, None), (45, torch.tensor(33, dtype=torch.int32)),
    (45, torch.tensor(45, dtype=torch.int32)), (45, 0), (0, None), (0, 0),
]


def _forest(rng, T, depth, d=11):
    feats = rng.integers(0, d, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(size=(T, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(N_X, d)).astype(np.float32)
    x[:5, feats[0]] = thrs[0]  # values on a threshold: the compare is strict
    return feats, thrs, leaves, x


@pytest.mark.parametrize("depth", [1, 5, 9, 12])
@pytest.mark.parametrize("tk", [1, 7, 8, 33])
def test_gbt_scores_plain_matches_jax(depth, tk):
    rng = np.random.default_rng(100 * depth + tk)
    T = tk + 3
    feats, thrs, leaves, x = _forest(rng, T, depth)
    t0 = 2
    params = [torch.from_numpy(a) for a in (feats, thrs, leaves)]
    for n_rows, n_valid in CASES:
        rows = None if n_rows is None else _rows(rng, n_rows)
        got = gbt_scores_plain(
            *params, torch.from_numpy(x), block_n=BLOCK_N, t0=t0, t1=t0 + tk,
            rows=None if rows is None else torch.from_numpy(rows), n_valid=n_valid,
        ).numpy()
        xg = x if rows is None else x[np.clip(rows, 0, N_X - 1)]
        sl = slice(t0, t0 + tk)
        want = np.asarray(j_ref.gbt_scores_ref(
            jnp.asarray(feats[sl]), jnp.asarray(thrs[sl]), jnp.asarray(leaves[sl]),
            jnp.asarray(xg),
        ))
        want_gbt = np.asarray(j_apply_gbt_scores(
            {"feats": jnp.asarray(feats[sl]), "thrs": jnp.asarray(thrs[sl]),
             "leaves": jnp.asarray(leaves[sl])}, jnp.asarray(xg),
        ))
        np.testing.assert_array_equal(want, want_gbt)
        want = np.where(_live(xg.shape[0], n_valid)[:, None], want, np.float32(0.0))
        assert got.shape == (xg.shape[0], tk)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("tk", [1, 8, 33])
def test_lattice_scores_plain_matches_jax(S, tk):
    rng = np.random.default_rng(10 * S + tk)
    T, d = tk + 2, 12
    theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
    feats = np.stack([rng.choice(d, S, replace=False) for _ in range(T)]).astype(np.int32)
    x = rng.uniform(size=(N_X, d)).astype(np.float32)
    x[:6] = np.round(x[:6])  # the cube's corners
    t0 = 1
    for n_rows, n_valid in CASES:
        rows = None if n_rows is None else _rows(rng, n_rows)
        got = lattice_scores_plain(
            torch.from_numpy(theta), torch.from_numpy(feats), torch.from_numpy(x),
            block_n=BLOCK_N, t0=t0, t1=t0 + tk,
            rows=None if rows is None else torch.from_numpy(rows), n_valid=n_valid,
        ).numpy()
        xg = x if rows is None else x[np.clip(rows, 0, N_X - 1)]
        sl = slice(t0, t0 + tk)
        want = np.asarray(j_ref.lattice_scores_ref(
            jnp.asarray(theta[sl]), jnp.asarray(feats[sl]), jnp.asarray(xg)
        )).reshape(xg.shape[0], tk)
        want = np.where(_live(xg.shape[0], n_valid)[:, None], want, np.float32(0.0))
        assert got.shape == (xg.shape[0], tk)
        np.testing.assert_array_equal(got, want)


# the paths' shapes (n, tk, depth): the sort key, a stage slab, the eager
# and ranking matrices, calibration; then the tile and depth edges
TREE_SHAPES = [
    (256, 1, 5), (256, 8, 5), (256, 500, 5), (1000, 500, 5), (8000, 500, 5),
    (45, 7, 1), (45, 33, 9), (300, 33, 12), (77, 8, 15), (77, 1, 16),
    (50, 40, 30), (1, 1, 0), (513, 64, 8),
]


def _tree_cover(geo, n, tk):
    """How many times each (row, tree) output is written by ``geo``'s
    launch, following the kernel's index arithmetic."""
    gx, gy = geo.grid
    bx, by, tid, p = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(geo.threads), np.arange(geo.passes),
        indexing="ij",
    )
    run = geo.rows * geo.passes
    jj = tid % geo.tile
    i = bx * run + tid // geo.tile + p * geo.rows
    t = by * geo.tile + jj
    ok = (i < np.minimum(n, (bx + 1) * run)) & (jj < np.minimum(geo.tile, tk - by * geo.tile))
    cover = np.zeros((n, tk), np.int64)
    np.add.at(cover, (i[ok], t[ok]), 1)
    return cover


def _resident(ctas):
    """A card whose SMs hold ``ctas`` CTAs of every B3 kernel at once."""
    return lambda staged, threads, smem: ctas


@pytest.mark.parametrize("n,tk,depth", TREE_SHAPES)
@pytest.mark.parametrize("n_sms,ctas", [(H100_SMS, 4), (H100_SMS, 8), (1, 1)])
def test_tree_geometry_covers_every_output_once(n, tk, depth, n_sms, ctas):
    geo = tk_.tree_geometry(n, tk, depth, n_sms, _resident(ctas))
    assert (_tree_cover(geo, n, tk) == 1).all()
    # within the card's limits and the kernel's templates
    assert 1 <= geo.threads <= tk_.THREADS and geo.grid[1] <= 65535
    assert geo.smem <= tk_.STAGE_SMEM
    params, leaves = 8 * depth * geo.tile, geo.tile * 4 * ((1 << depth) + 1)
    assert geo.staged == (params + leaves <= tk_.STAGE_SMEM)
    assert geo.smem == params + (leaves if geo.staged else 0)
    # trees fastest, and no idle lane while the tile is all of tk
    assert geo.rows == tk_.THREADS // geo.tile
    if tk <= tk_.TILE:
        assert geo.tile == tk
    # one wave: no more CTAs than the card holds, unless one a tile is more
    assert geo.grid[0] * geo.grid[1] <= max(n_sms * ctas, geo.grid[1])


def test_tree_geometry_at_the_paths_shapes():
    """The sort key and a stage slab take one pass a CTA; the eager matrix
    one pass a CTA of 8 rows x 32 trees; the calibration matrix fills one
    wave of the card (132 SMs x 4 CTAs), each CTA staging its tile once for
    31 passes."""
    res = _resident(4)
    key = tk_.tree_geometry(256, 1, 5, H100_SMS, res)
    assert (key.tile, key.rows, key.passes, key.grid, key.staged) == (1, 256, 1, (1, 1), True)
    stage = tk_.tree_geometry(256, 8, 5, H100_SMS, res)
    assert (stage.tile, stage.rows, stage.passes, stage.grid) == (8, 32, 1, (8, 1))
    eager = tk_.tree_geometry(256, 500, 5, H100_SMS, res)
    assert (eager.tile, eager.rows, eager.passes, eager.grid) == (32, 8, 1, (32, 16))
    cal = tk_.tree_geometry(8000, 500, 5, H100_SMS, res)
    assert (cal.tile, cal.passes, cal.grid, cal.staged) == (32, 31, (33, 16), True)
    assert tk_.tree_geometry(300, 33, 12, H100_SMS, res).tile == 17  # 33 -> 17 + 16
    deep = tk_.tree_geometry(77, 8, 15, H100_SMS, res)
    assert (deep.staged, deep.smem) == (False, 8 * 15 * 8)


def test_tree_depth_limit_is_named():
    """The kernel takes depths 0 to 30 (an int leaf index; deep tables read
    in place), at least B4 tree's 15; past it the error names the limit."""
    assert tk_.MAX_DEPTH == 30
    for depth in (0, 5, 10, 11, 15, 16, 30):
        tk_.check_tree_depth(depth)
        tk_.tree_geometry(10, 3, depth, H100_SMS, _resident(4))
    for depth in (-1, 31):
        with pytest.raises(ValueError, match=rf"gbt_scores: tree depth {depth} not in \[0, 30\]"):
            tk_.check_tree_depth(depth)
    # the plain version takes any depth
    rng = np.random.default_rng(4)
    feats, thrs, leaves, x = _forest(rng, 2, 17)
    out = gbt_scores_plain(*(torch.from_numpy(a) for a in (feats, thrs, leaves, x)))
    assert out.shape == (N_X, 2)


# (n, tk, S): the paths' shapes (sort key, stage slab, eager and
# calibration matrices), the switch's either side, and other edges
LATTICE_SHAPES = [
    (256, 1, 8), (256, 8, 8), (2000, 500, 8), (8000, 500, 8), (256, 8, 1),
    (45, 33, 4), (1, 1, 5), (1055, 8, 8), (1056, 8, 8), (1057, 8, 8), (700, 100, 3),
]


def _lattice_cover(reg, n, tk):
    """How many times each (row, lattice) output is written by ``reg``'s
    launch, following the kernel's index arithmetic."""
    cover = np.zeros((n, tk), np.int64)
    gx, gy = reg.grid
    if reg.team:
        b, j = np.meshgrid(np.arange(gx), np.arange(reg.threads), indexing="ij")
        pair = b * (reg.threads // reg.lanes) + j // reg.lanes
        ok = (pair < n * tk) & (j % reg.lanes == 0)  # the team's first lane writes
        np.add.at(cover, (pair[ok] // tk, pair[ok] % tk), 1)
    else:
        rows, lats = lk.THREAD_TILE
        bx, by, tx, ty = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(rows),
                                     np.arange(lats), indexing="ij")
        i, t = bx * rows + tx, by * lats + ty
        ok = (i < n) & (t < tk)
        np.add.at(cover, (i[ok], t[ok]), 1)
    return cover


@pytest.mark.parametrize("n,tk,S", LATTICE_SHAPES)
@pytest.mark.parametrize("n_sms", [H100_SMS, 8])
def test_lattice_regime_covers_every_output_once(n, tk, S, n_sms):
    reg = lk.lattice_regime(n, tk, S, n_sms)
    assert (_lattice_cover(reg, n, tk) == 1).all()
    lanes = min(32, 1 << S)
    assert reg.team == (n * tk * lanes <= n_sms * lk.TEAM_THREADS_PER_SM)
    assert reg.threads <= 1024 and reg.threads % 32 == 0 and reg.grid[1] <= 65535
    if reg.team:
        assert reg.lanes == lanes and reg.grid[1] == 1
        assert 32 <= reg.threads <= lk.TEAM_THREADS
        # spread over the SMs: a smaller CTA only while the grid is short
        assert reg.threads == 32 or reg.grid[0] >= n_sms
    else:
        assert reg.lanes == 1 and reg.threads == 256


def test_lattice_regime_at_the_paths_shapes():
    """The serving shapes (sort key, stage slab) take the team form, the
    eager and calibration matrices one thread a pair; at S = 8 the switch
    is at 8448 pairs on 132 SMs (a warp a pair, 2048 threads an SM)."""
    assert lk.lattice_regime(256, 1, 8, H100_SMS).team
    assert lk.lattice_regime(256, 8, 8, H100_SMS).team
    assert not lk.lattice_regime(2000, 500, 8, H100_SMS).team
    assert not lk.lattice_regime(8000, 500, 8, H100_SMS).team
    assert lk.lattice_regime(1056, 8, 8, H100_SMS).team
    assert not lk.lattice_regime(1057, 8, 8, H100_SMS).team
    key = lk.lattice_regime(256, 1, 8, H100_SMS)
    assert (key.threads, key.grid) == (32, (256, 1))
    with pytest.raises(ValueError, match="lattice_regime"):
        lk.lattice_regime(10, 3, 9, H100_SMS)


def test_tree_scorer_prepare_checks_the_width():
    """``tree_stage_scorer.prepare`` refuses rows narrower than the
    largest feature id + 1 (the kernel reads x[r, f] unchecked), on the
    host, once a batch; rows at that width or wider pass."""
    rng = np.random.default_rng(9)
    T = 12
    plan = CascadePlan(
        order=np.arange(T), eps_pos=np.full(T, 2.0), eps_neg=np.full(T, -2.0),
        beta=0.0, costs=np.ones(T), chunk_t=4,
    )
    feats = rng.integers(0, 6, size=(T, 3)).astype(np.int32)
    feats[5, 1] = 8  # the largest id: rows need 9 features
    scorer = tree_stage_scorer(
        DevicePlan.from_plan(plan), feats, rng.uniform(size=(T, 3)),
        rng.normal(size=(T, 8)), device="cpu",
    )
    for d in (9, 12):
        assert scorer.prepare(np.zeros((4, d))).shape == (4, d)
    for bad in (np.zeros((4, 8)), np.zeros(9)):
        with pytest.raises(ValueError, match=r"expected \(n, >= 9\) feature rows for the trees"):
            scorer.prepare(bad)
