"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA tensors (exact), and the device executor on the
card against the same executor on the CPU.

Marked ``cuda``: without a card these skip.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.api.scorers import LatticeScorer, TreeScorer
from repro_torch.core import fit_qwyc
from repro_torch.core.executor import CascadePlan
from repro_torch.data.synthetic import make_dataset
from repro_torch.ensembles.gbt import apply_gbt_scores, train_gbt
from repro_torch.kernels import _build, device_executor
from repro_torch.ensembles.lattice import init_lattice_ensemble
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_chunk_plain,
    cascade_group_plain,
    cascade_kernel,
    cascade_lane_kernel,
    cascade_lane_plain,
    cascade_plain,
)
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
from repro_torch.kernels.megakernel import (
    build_tree_slabs,
    mega_lane_kernel,
    mega_lane_plain,
    mega_stage_kernel,
    mega_stage_plain,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import gbt_scores
from repro_torch.kernels.tree_kernel import gbt_scores_kernel, gbt_scores_plain
from repro_torch.launch import serve
from repro_torch.serving.engine import BACKENDS, QWYCServer, StreamingServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _plan(rng, T=37, chunk_t=8, lead_t=1):
    return CascadePlan(
        order=np.arange(T), eps_pos=rng.uniform(1.0, 4.0, size=T),
        eps_neg=-rng.uniform(1.0, 4.0, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=chunk_t, lead_t=lead_t,
    )


@pytest.mark.parametrize("n_valid", [None, 0, 77, 200])
def test_cascade_chunk_kernel_equals_plain(dev, n_valid):
    rng = np.random.default_rng(1)
    g0, s = _t(rng.normal(size=200).astype(np.float32), dev), _t(
        rng.normal(size=(200, 8)).astype(np.float32), dev
    )
    ep = _t(rng.uniform(0.5, 3, size=8).astype(np.float32), dev)
    en = -_t(rng.uniform(0.5, 3, size=8).astype(np.float32), dev)
    nv = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["cascade_chunk"]
    got = cascade_chunk_kernel(g0, s, ep, en, 5, block_n=64, n_valid=nv)
    assert _build.LAUNCHES["cascade_chunk"] == before + 1
    for a, b in zip(got, cascade_chunk_plain(g0, s, ep, en, 5, n_valid=nv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_valid", [None, 0, 70])
def test_gbt_scores_kernel_equals_plain(dev, n_valid):
    rng = np.random.default_rng(2)
    T, depth, d = 45, 5, 14
    feats = _t(rng.integers(0, d, size=(T, depth)).astype(np.int32), dev)
    thrs = _t(rng.uniform(size=(T, depth)).astype(np.float32), dev)
    leaves = _t(rng.normal(size=(T, 1 << depth)).astype(np.float32), dev)
    x = _t(rng.uniform(size=(300, d)).astype(np.float32), dev)
    rows = _t(rng.permutation(300)[:150], dev)
    for kw in (dict(), dict(t0=3, t1=40, rows=rows, n_valid=n_valid)):
        a = gbt_scores_kernel(feats, thrs, leaves, x, block_n=64, **kw)
        b = gbt_scores_plain(feats, thrs, leaves, x, block_n=64, **kw)
        assert torch.equal(a, b)


def _score_rows(rng, n, n_x, dev):
    """n row ids with negative and past-the-end ones (the kernels clamp)."""
    rows = rng.integers(-4, n_x + 4, size=n)
    rows[: min(n, 2)] = (-2, n_x + 1)[: min(n, 2)]
    return _t(rows.astype(np.int64), dev)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15, 16])
@pytest.mark.parametrize("tk", [1, 7, 8, 33, 500])
def test_gbt_scores_kernel_equals_plain_every_geometry(dev, depth, tk):
    """B3 at every tile shape (tk 1, 7, 8: one tile of tk trees; 33: 17 +
    16; 500: 16 tiles of at most 32), every depth with a kernel of its own
    (1-8), the any-depth kernel with staged (0, 9, 12) and in-place leaf
    tables (15 and 16, past the old limit of 10), rows clamped at both ends,
    n_valid None / 0 / partial / all, n = 0, and n not a multiple of
    block_n; one launch a call."""
    rng = np.random.default_rng(depth * 1000 + tk)
    T, d, n_x = tk + 3, 14, 300
    feats = _t(rng.integers(0, d, size=(T, depth)).astype(np.int32), dev)
    thrs = _t(rng.uniform(size=(T, depth)).astype(np.float32), dev)
    leaves = _t(rng.normal(size=(T, 1 << depth)).astype(np.float32), dev)
    x = _t(rng.uniform(size=(n_x, d)).astype(np.float32), dev)
    nv = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    cases = [
        dict(), dict(n_valid=130), dict(rows=_score_rows(rng, 257, n_x, dev), n_valid=nv(200)),
        dict(rows=_score_rows(rng, 257, n_x, dev), n_valid=nv(0)),
        dict(rows=_score_rows(rng, 100, n_x, dev), n_valid=nv(100)),
        dict(rows=_score_rows(rng, 0, n_x, dev)),
    ]
    before = _build.LAUNCHES["gbt_scores"]
    for kw in cases:
        a = gbt_scores_kernel(feats, thrs, leaves, x, block_n=64, t0=2, t1=2 + tk, **kw)
        torch.cuda.synchronize()
        b = gbt_scores_plain(feats, thrs, leaves, x, block_n=64, t0=2, t1=2 + tk, **kw)
        assert torch.equal(a, b), kw
    assert _build.LAUNCHES["gbt_scores"] == before + len(cases) - 1  # n = 0 launches nothing


def test_gbt_scores_kernel_at_depth_30_and_past_the_limit(dev):
    """B3 reads a 2^30-leaf table in place (one tree, 4 GiB) with its int
    leaf index; a depth-31 forest is refused with the limit named."""
    rng = np.random.default_rng(30)
    feats = _t(rng.integers(0, 40, size=(1, 30)).astype(np.int32), dev)
    thrs = _t(rng.uniform(size=(1, 30)).astype(np.float32), dev)
    leaves = torch.arange(1 << 30, dtype=torch.float32, device=dev)[None]
    x = _t(rng.uniform(size=(200, 40)).astype(np.float32), dev)
    a = gbt_scores_kernel(feats, thrs, leaves, x)
    torch.cuda.synchronize()
    assert torch.equal(a, gbt_scores_plain(feats, thrs, leaves, x))
    del leaves
    with pytest.raises(ValueError, match=r"gbt_scores: tree depth 31 not in \[0, 30\]"):
        gbt_scores_kernel(torch.zeros(1, 31, dtype=torch.int32, device=dev),
                          torch.zeros(1, 31, device=dev), torch.zeros(1, 2, device=dev), x)


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("side", ["team", "thread"])
def test_lattice_scores_kernel_equals_plain_both_regimes(dev, S, side):
    """B5 on either side of its regime switch (``lattice_regime``, from the
    card's SM count): the switch's last row count takes the team form, one
    more the thread form; each with rows clamped at both ends, n_valid None
    / 0 / partial, a single-lattice slab and n = 0."""
    from repro_torch.kernels.lattice_kernel import lattice_regime

    rng = np.random.default_rng(S + (100 if side == "thread" else 0))
    tk, d, n_x = 8, 30, 400
    sms = _build.sm_count(dev)
    n_switch = sms * 2048 // (tk * min(32, 1 << S))  # the last team row count
    n = n_switch if side == "team" else n_switch + 1
    assert lattice_regime(n, tk, S, sms).team == (side == "team")
    T = tk + 2
    theta = _t(rng.normal(size=(T, 1 << S)).astype(np.float32), dev)
    feats = _t(np.stack([rng.choice(d, S, replace=False) for _ in range(T)]).astype(np.int32), dev)
    xl = rng.uniform(size=(n_x, d)).astype(np.float32)
    xl[:30] = np.round(xl[:30])
    x = _t(xl, dev)
    rows = _score_rows(rng, n, n_x, dev)
    nv = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    cases = [
        dict(t0=1, t1=1 + tk, rows=rows), dict(t0=1, t1=1 + tk, rows=rows, n_valid=nv(0)),
        dict(t0=1, t1=1 + tk, rows=rows, n_valid=nv(n // 2 + 5)),
        dict(t0=1, t1=1 + tk, rows=rows, n_valid=n // 3),
        dict(t0=T - 1, rows=rows[:257]), dict(t0=0, t1=tk, rows=rows[:0]),
    ]
    for kw in cases:
        a = lattice_scores_kernel(theta, feats, x, block_n=64, **kw)
        torch.cuda.synchronize()
        b = lattice_scores_plain(theta, feats, x, block_n=64, **kw)
        assert torch.equal(a, b), kw


@pytest.mark.parametrize("chunk_t", [1, 8, 64])
def test_cascade_kernel_equals_plain(dev, chunk_t):
    """B1 with T not a multiple of chunk_t, rows that never exit and ±inf
    "full evaluation" thresholds on the last positions."""
    rng = np.random.default_rng(5)
    n, T = 1000, 101
    F = rng.normal(size=(n, T)).astype(np.float32)
    F[:9] = 0.0
    ep = rng.uniform(1.0, 4.0, size=T).astype(np.float32)
    en = -rng.uniform(1.0, 4.0, size=T).astype(np.float32)
    ep[-7:], en[-7:] = np.inf, -np.inf
    args = (_t(F, dev), _t(ep, dev), _t(en, dev), 0.1)
    before = _build.LAUNCHES["cascade"]
    got = cascade_kernel(*args, block_n=256, chunk_t=chunk_t)
    assert _build.LAUNCHES["cascade"] == before + 1
    want = cascade_plain(*args, chunk_t=chunk_t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[1][:9] == T).all() and (got[1] < T).any()


@pytest.mark.parametrize("kind", ["drawn", "inf"])
@pytest.mark.parametrize("n,T,chunk_t,block_n", [
    (2000, 500, 8, 256), (1, 1, 8, 256), (33, 7, 8, 64), (2000, 499, 7, 256),
    (77, 37, 3, 32), (4096, 513, 8, 256), (4096, 512, 8, 64),
])
def test_cascade_kernel_shapes_equal_plain(dev, n, T, chunk_t, block_n, kind):
    """B1 at the eager path's shape (2000, 500) with Filter-and-Score-like
    thresholds (negative exits only, rows that never exit) and at ±inf
    ("full evaluation"), and at the edges of its tiles and warps: one row
    and one column, 33 x 7, T odd (rows not 16-byte aligned: 4-byte
    copies), T = 499 with chunk 7, 4096 rows past one tile multiple and on
    it (tensor-map tiles), any ``block_n``; one launch, both outputs
    equal."""
    rng = np.random.default_rng(n + T)
    F = (rng.normal(scale=0.3, size=(n, T)) + rng.normal(scale=0.05, size=(n, 1))).astype(
        np.float32)
    F[: min(n, 5)] = np.abs(F[: min(n, 5)])  # never below a negative threshold
    if kind == "drawn":
        ep = np.full(T, np.inf, np.float32)
        en = -rng.uniform(0.5, 3.0, size=T).astype(np.float32)
    else:
        ep, en = np.full(T, np.inf, np.float32), np.full(T, -np.inf, np.float32)
    args = (_t(F, dev), _t(ep, dev), _t(en, dev), 0.05)
    before = _build.LAUNCHES["cascade"]
    got = cascade_kernel(*args, block_n=block_n, chunk_t=chunk_t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["cascade"] == before + 1
    want = cascade_plain(*args, chunk_t=chunk_t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (got[1][: min(n, 5)] == T).all()
    if kind == "inf":
        assert (got[1] == T).all()


@pytest.mark.parametrize("W", ["8", "8 misaligned", "3", "12"])
@pytest.mark.parametrize("n_valid", [None, 0, "mid", "host"])
@pytest.mark.parametrize("cap", [1, 31, 256, 1024, 1025, 1300])
def test_cascade_chunk_step_equals_plain(dev, cap, n_valid, W):
    """B2's step form: partial sums read through row ids from a (cap + 1,)
    buffer (the trash slot past the live lanes, -0.0 entries), the (S, W)
    tables at a full stage, a ±inf stage and the ragged last stage (its
    survivors kept), a NaN score, n_valid mid-block; W 8 with the rows
    aligned and 4 bytes off, W 3 (scalar loads) and 12 (a partial group);
    one launch a call (one CTA up to 1024 lanes, block prefixes and a
    combine past that), all six outputs equal (``g`` by its bits)."""
    from repro_torch.kernels.cascade_kernel import cascade_chunk_step, cascade_chunk_step_plain

    w = int(W.split()[0])
    rng = np.random.default_rng(cap * 100 + w)
    S = 5
    g = rng.normal(scale=0.5, size=cap + 1).astype(np.float32)
    g[::7] = -0.0
    nv = {None: None, 0: 0, "mid": min(cap, cap // 2 + 5), "host": cap // 3}[n_valid]
    live = cap if nv is None else nv
    rows = np.full(cap, cap, np.int64)
    rows[:live] = rng.permutation(cap)[:live]
    scores = rng.normal(size=(cap, w)).astype(np.float32)
    scores[rng.integers(cap), rng.integers(w)] = np.nan
    ep = rng.uniform(0.3, 2.0, size=(S, w)).astype(np.float32)
    en = -rng.uniform(0.3, 2.0, size=(S, w)).astype(np.float32)
    col = np.ones((S, w), bool)
    ep[1], en[1] = np.inf, -np.inf
    col[S - 1, w - 2:], ep[S - 1, w - 2:], en[S - 1, w - 2:] = False, np.inf, -np.inf
    sc = _t(scores, dev)
    if W == "8 misaligned":
        sc = torch.empty(cap * w + 1, device=dev)[1:].view(cap, w).copy_(sc)
        assert sc.data_ptr() % 16 == 4
    nv_arg = torch.tensor(nv, dtype=torch.int32, device=dev) if n_valid in (0, "mid") else nv
    g_t, rows_t = _t(g, dev), _t(rows, dev)
    tables = [_t(a, dev) for a in (ep, en, col)]
    for s in (2, 1, S - 1):
        before = _build.LAUNCHES["cascade_chunk_step"]
        got = cascade_chunk_step(g_t, rows_t, sc, s, *tables, n_valid=nv_arg, block_n=64)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["cascade_chunk_step"] == before + 1
        want = cascade_chunk_step_plain(g_t, rows_t, sc, s, *tables, n_valid=nv_arg)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        if s == 1:
            assert int(got[5]) == live


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("n_valid", [None, 0, 70])
def test_lattice_scores_kernel_equals_plain(dev, S, n_valid):
    rng = np.random.default_rng(S)
    T, d = 45, 30
    theta = _t(rng.normal(size=(T, 1 << S)).astype(np.float32), dev)
    feats = _t(np.stack([rng.choice(d, S, replace=False) for _ in range(T)]).astype(np.int32), dev)
    x = rng.uniform(size=(300, d)).astype(np.float32)
    x[:40] = np.round(x[:40])  # the cube's corners
    x = _t(x, dev)
    rows = _t(rng.permutation(300)[:150], dev)
    nv = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32, device=dev)
    for kw in (dict(), dict(t0=3, t1=40, rows=rows, n_valid=nv), dict(t0=44, n_valid=n_valid)):
        a = lattice_scores_kernel(theta, feats, x, block_n=64, **kw)
        b = lattice_scores_plain(theta, feats, x, block_n=64, **kw)
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["tree", "matrix", "lattice"])
@pytest.mark.parametrize("n_valid", [0, 1, 100, 128])
def test_mega_stage_kernel_equals_plain(dev, variant, n_valid):
    rng = np.random.default_rng(3)
    dplan = DevicePlan.from_plan(_plan(rng))
    T, depth, d = 37, 5, 14
    if variant == "tree":
        scorer = tree_stage_scorer(
            dplan, rng.integers(0, d, size=(T, depth)), rng.uniform(size=(T, depth)),
            rng.normal(size=(T, 1 << depth)), device=dev,
        )
        x = _t(rng.uniform(size=(128, d)).astype(np.float32), dev)
    elif variant == "lattice":
        d, S = 30, 8
        scorer = lattice_stage_scorer(
            dplan, rng.normal(size=(T, 1 << S)),
            np.stack([rng.choice(d, S, replace=False) for _ in range(T)]), device=dev,
        )
        x = _t(rng.uniform(size=(128, d)).astype(np.float32), dev)
    else:
        scorer = matrix_stage_scorer(dplan, device=dev)
        x = scorer.prepare(rng.normal(size=(128, T)))
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = _t(rng.normal(scale=0.5, size=128).astype(np.float32), dev)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    for stage in range(dplan.S):
        t0 = int(dplan.stage_t0[stage])
        args = (scorer.slabs, x, g0, stage, t0, nv, *eps)
        for a, b in zip(mega_stage_kernel(*args, block_n=64), mega_stage_plain(*args, block_n=64)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("megakernel", [None, False])
def test_device_executor_on_card_equals_cpu(dev, megakernel):
    rng = np.random.default_rng(4)
    plan = _plan(rng, T=40, chunk_t=4)
    dplan = DevicePlan.from_plan(plan)
    F = rng.normal(size=(150, 40)).astype(np.float32)
    order = rng.permutation(150)
    res = [
        DeviceExecutor(
            dplan, matrix_stage_scorer(dplan, device=d), megakernel=megakernel, device=d
        ).run(F, 150, row_order=order, capacity=256)
        for d in (dev, "cpu")
    ]
    np.testing.assert_array_equal(res[0].decisions, res[1].decisions)
    np.testing.assert_array_equal(res[0].exit_step, res[1].exit_step)
    np.testing.assert_array_equal(res[0].g_final, res[1].g_final)
    assert res[0].chunk_stats == res[1].chunk_stats


@pytest.fixture(scope="module")
def small_gbt():
    ds = make_dataset("adult", scale=0.1)
    g = train_gbt(ds.x_train, ds.y_train, n_trees=40, depth=5, device="cpu")
    F = apply_gbt_scores(g.stacked(), torch.from_numpy(ds.x_train)).numpy()
    return ds, g, fit_qwyc(F.astype(np.float64), beta=-g.base_score, alpha=0.01)


@pytest.mark.parametrize("policy", BACKENDS)
@pytest.mark.parametrize("exec_backend", ["host", "device"])
def test_server_on_card_equals_cpu(dev, small_gbt, policy, exec_backend):
    """Both backends and all three policies: on the host backend the card
    runs B3 per stage through the lazy producer and B2 as the decide."""
    ds, g, m = small_gbt
    out = []
    for d in (dev, "cpu"):
        params = {k: v.to(d) for k, v in g.stacked().items()}

        def chunk_score_fn(x, rows, t0, t1, params=params, d=d):
            order = torch.as_tensor(m.order, device=d)
            f, th, lv = (params[k][order] for k in ("feats", "thrs", "leaves"))
            return gbt_scores(f, th, lv, x, t0=t0, t1=t1, rows=rows, block_n=64)

        kw = (
            {"scorer": TreeScorer(g.feats, g.thrs, g.leaves)}
            if exec_backend == "device"
            else {"chunk_score_fn": chunk_score_fn, "score_block_n": 64}
        )
        srv = QWYCServer(m, exec_backend=exec_backend, device=d, backend=policy,
                         batch_size=64, **kw)
        for row in ds.x_test:
            srv.submit(row)
        out.append((srv.drain(), srv.stats))
    (a, sa), (b, sb) = out
    assert a == b
    assert sa.scores_computed == sb.scores_computed
    assert sa.chunk_survivors == sb.chunk_survivors


def test_cli_serves_on_card(dev, capsys):
    serve.main(["--T", "40", "--scale", "0.1", "--alpha", "0.01", "--audit"])
    out = capsys.readouterr().out
    assert "(device backend, sorted-kernel policy, lazy)" in out
    assert "diff vs full 0." in out


@pytest.mark.parametrize("megakernel", [None, False])
def test_lattice_server_on_card_equals_cpu(dev, megakernel):
    """exp4_rw2_joint's path at a small size, fused and unfused, on the card
    against the same server on the CPU."""
    ds = make_dataset("rw2", scale=0.1)
    lat = init_lattice_ensemble(40, ds.D, 8, seed=0, device="cpu")
    F = ops.lattice_scores(lat["theta"], lat["feats"], torch.from_numpy(ds.x_train))
    m = fit_qwyc(F.numpy().astype(np.float64), beta=0.0, alpha=0.01, mode="neg_only")
    out = []
    for d in (dev, "cpu"):
        srv = QWYCServer(
            m, scorer=LatticeScorer(lat["theta"], lat["feats"]), exec_backend="device",
            device=d, batch_size=64, backend_opts={"megakernel": megakernel},
        )
        for row in ds.x_test:
            srv.submit(row)
        out.append((srv.drain(), srv.stats))
    (a, sa), (b, sb) = out
    assert a == b
    assert sa.scores_computed == sb.scores_computed
    assert sa.chunk_survivors == sb.chunk_survivors


def test_lattice_cli_serves_on_card(dev, capsys):
    serve.main(["--dataset", "rw2", "--ensemble", "lattice", "--T", "40", "--scale", "0.1",
                "--alpha", "0.01", "--mode", "neg_only", "--audit"])
    out = capsys.readouterr().out
    assert "(device backend, sorted-kernel policy, lazy)" in out
    assert "diff vs full 0." in out


@pytest.mark.parametrize("n_valid", [None, 0, 77, 256])
def test_cascade_lane_kernel_equals_plain(dev, n_valid):
    """B6: per-lane threshold rows with ±inf padded columns on a third of
    the lanes (a ragged stage), relative exits."""
    rng = np.random.default_rng(11)
    m, ct = 256, 8
    s = rng.normal(size=(m, ct)).astype(np.float32)
    ep = rng.uniform(0.5, 3, size=(m, ct)).astype(np.float32)
    en = -rng.uniform(0.5, 3, size=(m, ct)).astype(np.float32)
    ragged = rng.random(m) < 0.3
    ep[ragged, 5:], en[ragged, 5:], s[ragged, 5:] = np.inf, -np.inf, 0.0
    g0 = _t(rng.normal(size=m).astype(np.float32), dev)
    s, ep, en = _t(s, dev), _t(ep, dev), _t(en, dev)
    nv = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["cascade_lane"]
    got = cascade_lane_kernel(g0, s, ep, en, block_n=64, n_valid=nv)
    assert _build.LAUNCHES["cascade_lane"] == before + 1
    for a, b in zip(got, cascade_lane_plain(g0, s, ep, en, n_valid=nv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["tree", "matrix", "lattice"])
@pytest.mark.parametrize("n_valid", [0, 1, 100, 256])
def test_mega_lane_kernel_equals_plain(dev, variant, n_valid):
    """B7: lanes over every stage in one block, last-stage (stop) lanes,
    rows retiring mid-block, the ragged last stage, trash rows."""
    rng = np.random.default_rng(12)
    dplan = DevicePlan.from_plan(_plan(rng))
    T, depth, d, cap = 37, 5, 14, 256
    if variant == "tree":
        scorer = tree_stage_scorer(
            dplan, rng.integers(0, d, size=(T, depth)), rng.uniform(size=(T, depth)),
            rng.normal(size=(T, 1 << depth)), device=dev,
        )
        x = _t(rng.uniform(size=(300, d)).astype(np.float32), dev)
    elif variant == "lattice":
        d, S = 30, 8
        scorer = lattice_stage_scorer(
            dplan, rng.normal(size=(T, 1 << S)),
            np.stack([rng.choice(d, S, replace=False) for _ in range(T)]), device=dev,
        )
        x = _t(rng.uniform(size=(300, d)).astype(np.float32), dev)
    else:
        scorer = matrix_stage_scorer(dplan, device=dev)
        x = scorer.prepare(rng.normal(size=(300, T)))
    stage = rng.integers(0, dplan.S, size=cap).astype(np.int32)
    stage[: dplan.S] = np.arange(dplan.S)
    rows = rng.permutation(300)[:cap]
    rows[n_valid:] = 299
    stage_t, stop = _t(stage, dev), _t(stage >= dplan.S - 1, dev)
    g0 = _t(rng.normal(scale=0.5, size=cap).astype(np.float32), dev)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    args = (scorer.slabs, x, _t(rows, dev), g0, stage_t, stop, nv,
            _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev))
    before = _build.LAUNCHES[f"mega_lane_{variant}"]
    got = mega_lane_kernel(*args, block_n=64)
    assert _build.LAUNCHES[f"mega_lane_{variant}"] == before + 1
    for a, b in zip(got, mega_lane_plain(*args, block_n=64)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block_n", [64, 50])
@pytest.mark.parametrize("W", [1, 8, 13])
@pytest.mark.parametrize("quant", ["f32", "bf16"])
def test_matrix_step_kernels_equal_plain(dev, quant, W, block_n):
    """B4 and B7 matrix (``matrix_step_kernel``) against their plain
    versions: B4 in the gathered form and reading the operand in place
    through ``rows`` (trash row ids, ids past the operand), at the lead, a
    middle and the ragged last stage (starts t0 = 1 + W k: misaligned); B7
    with lanes over every stage or all at the ragged last one, stop lanes;
    n_valid 0, partial and all."""
    rng = np.random.default_rng(20 + W)
    dplan = DevicePlan.from_plan(_plan(rng, T=61, chunk_t=W), quant=quant)
    scorer = matrix_stage_scorer(dplan, device=dev)
    cap, S = 256, dplan.S
    x = scorer.prepare(rng.normal(scale=0.4, size=(300, 61)))
    if quant == "bf16":
        x = x.to(torch.bfloat16)
    rows = rng.permutation(300)[:cap]
    rows[-9:] = cap  # the executor's trash row id
    rows[-2:] = [300, 10**6]  # past the operand: clamped
    rows = _t(rows, dev)
    xg = x[torch.clamp(rows, 0, x.shape[0] - 1)].contiguous()
    spread = rng.integers(0, S, size=cap).astype(np.int32)
    spread[:S] = np.arange(S)
    last = np.full(cap, S - 1, np.int32)
    g0 = _t(rng.normal(scale=0.5, size=cap).astype(np.float32), dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    key = "matrix" if quant == "f32" else f"matrix_{quant}"
    for n_valid in (0, 77, cap):
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        for stage in (0, S // 2, S - 1):
            t0 = int(dplan.stage_t0[stage])
            want = mega_stage_plain(scorer.slabs, xg, g0, stage, t0, nv, *eps, block_n=block_n)
            for xs, kw in ((xg, {}), (x, dict(rows=rows))):
                before = _build.LAUNCHES[f"mega_stage_{key}"]
                got = mega_stage_kernel(scorer.slabs, xs, g0, stage, t0, nv, *eps,
                                        block_n=block_n, **kw)
                assert _build.LAUNCHES[f"mega_stage_{key}"] == before + 1
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
        for st in (spread, last):
            stop = _t(st >= S - 1, dev) if st is spread else _t(np.arange(cap) % 2 == 0, dev)
            args = (scorer.slabs, x, rows, g0, _t(st, dev), stop, nv, *eps)
            before = _build.LAUNCHES[f"mega_lane_{key}"]
            got = mega_lane_kernel(*args, block_n=block_n)
            assert _build.LAUNCHES[f"mega_lane_{key}"] == before + 1
            for a, b in zip(got, mega_lane_plain(*args, block_n=block_n)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("megakernel", [None, False])
@pytest.mark.parametrize("ensemble", ["gbt", "lattice"])
def test_streaming_server_on_card_equals_cpu(dev, small_gbt, ensemble, megakernel):
    """The streaming server (B7, or lane_fn + B6) on the card against the
    same server on the CPU under one Poisson trace: results, every
    streaming stat and every wave's timeline and ``g_final``."""
    if ensemble == "gbt":
        ds, g, m = small_gbt
        scorer = TreeScorer(g.feats, g.thrs, g.leaves)
    else:
        ds = make_dataset("rw2", scale=0.1)
        lat = init_lattice_ensemble(40, ds.D, 8, seed=0, device="cpu")
        F = ops.lattice_scores(lat["theta"], lat["feats"], torch.from_numpy(ds.x_train))
        m = fit_qwyc(F.numpy().astype(np.float64), beta=0.0, alpha=0.01, mode="neg_only")
        scorer = LatticeScorer(lat["theta"], lat["feats"])
    arrivals = np.cumsum(np.random.default_rng(2028).exponential(1 / 16.0, size=len(ds.x_test)))
    out = []
    for d in (dev, "cpu"):
        srv = StreamingServer(
            m, scorer=scorer, exec_backend="device", device=d, batch_size=64, window=128,
            backend_opts={"megakernel": megakernel},
        )
        for row, a in zip(ds.x_test, arrivals):
            srv.submit(row, arrival=a)
        out.append((srv.drain(), srv))
    (a, sa), (b, sb) = out
    assert a == b
    for k in ("scores_computed", "stream_steps", "stream_slot_steps", "latency_steps"):
        assert getattr(sa.stats, k) == getattr(sb.stats, k), k
    for ra, rb in zip(sa.stream_results, sb.stream_results):
        for k in ("decisions", "exit_step", "g_final", "admit_step", "done_step"):
            np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))
        assert ra.steps_enqueued == rb.steps_enqueued


def test_streaming_cli_serves_on_card(dev, capsys):
    serve.main(["--T", "40", "--scale", "0.1", "--alpha", "0.01", "--streaming",
                "--arrival-rate", "16", "--batch-size", "64"])
    out = capsys.readouterr().out
    assert "[serve] streaming: 200 admitted" in out
    assert "(device backend, streaming, lazy)" in out


# -- ranking: B8 and the grouped stage loop ---------------------------------


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("B", [4, 32, 64, 256])
@pytest.mark.parametrize("n_live", [None, 0, 5, 23])
def test_cascade_group_kernel_equals_plain(dev, B, k, n_live):
    """Ties (integer scores), groups of at most k documents, eps +inf and 0
    beside drawn thresholds, n_live 0 and below G: margin and exit equal."""
    from repro_torch.kernels.cascade_kernel import cascade_group_kernel, cascade_group_plain

    rng = np.random.default_rng(B + k)
    G = 23
    g = rng.integers(-3, 4, size=(G, B)).astype(np.float32)
    g[::2] += rng.normal(scale=0.3, size=(G, B))[::2].astype(np.float32)
    sizes = rng.integers(1, B + 1, size=G)
    sizes[:3] = [1, min(k, B), min(k + 1, B)]
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    eps = rng.uniform(0.0, 2.0, size=G).astype(np.float32)
    eps[3], eps[4] = np.inf, 0.0
    nl = None if n_live is None else torch.tensor(n_live, dtype=torch.int32, device=dev)
    args = [_t(g, dev), _t(valid, dev), _t(eps, dev), k]
    before = _build.LAUNCHES["cascade_group"]
    got = cascade_group_kernel(*args, n_live=nl)
    want = cascade_group_plain(*args, n_live=nl)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["cascade_group"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _group_case(seed, G, B, kind):
    """(g, valid, rows) for B8's picks: integer ties, -0.0 / +0.0 ties, -inf
    on valid lanes, or a group with a valid NaN and one with a valid -NaN
    among drawn ones; ragged sizes, an empty group."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-3, 4, size=(G, B)).astype(np.float32)
    if kind == "signed zeros":
        g = np.where(g == 0, np.where(rng.uniform(size=(G, B)) < 0.5, -0.0, 0.0), g)
        g = g.astype(np.float32)
    elif kind == "-inf":
        g[rng.uniform(size=(G, B)) < 0.3] = -np.inf
    elif kind == "nan":
        g[1::2] += rng.normal(scale=0.3, size=(G, B))[1::2].astype(np.float32)
        g[2, rng.integers(B)] = np.nan
        g[5, rng.integers(B)] = -np.float32(np.nan)
    sizes = rng.integers(1, B + 1, size=G)
    sizes[:2] = [0, B]
    if kind == "nan":
        sizes[2] = sizes[5] = B
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    rows = rng.integers(0, 1 << 30, size=(G, B)).astype(np.int64)
    return g, valid, rows


def _same_margin(a, b) -> bool:
    """Bits, except that a zero margin between a -0.0 and a +0.0 may take
    either sign: the plain version's max returns either zero of a tie."""
    zero = (a == 0) & (b == 0)
    return torch.equal(torch.where(zero, 0, a.view(torch.int32)),
                       torch.where(zero, 0, b.view(torch.int32)))


@pytest.mark.parametrize("kind", ["ties", "signed zeros", "-inf", "nan"])
@pytest.mark.parametrize("k_of", ["1", "10", "B+3"])
@pytest.mark.parametrize("B", [1, 4, 31, 32, 33, 64, 256])
def test_cascade_group_picks_equal_plain(dev, B, k_of, kind):
    """B8 with ``rows``: picks, exits and margins equal the plain version
    (``cascade_group_plain`` + ``group_topk_rows``) for n_live None, a
    device scalar (0 and below G) and a host int; one launch a call."""
    from repro_torch.kernels.cascade_kernel import cascade_group_kernel

    k = {"1": 1, "10": 10, "B+3": B + 3}[k_of]
    G = 37
    g, valid, rows = _group_case(B + 7 * k, G, B, kind)
    eps = np.random.default_rng(B).uniform(0.0, 2.0, size=G).astype(np.float32)
    eps[3], eps[4] = np.inf, 0.0
    args = [_t(g, dev), _t(valid, dev), _t(eps, dev), k]
    r, cpu = _t(rows, dev), [torch.from_numpy(a) for a in (g, valid, eps)] + [k]
    for n_live in (None, 0, 20, "host"):
        nl = {None: None, "host": 29}.get(n_live)
        if isinstance(n_live, int):
            nl = torch.tensor(n_live, dtype=torch.int32, device=dev)
        before = _build.LAUNCHES["cascade_group"]
        m, e, p = cascade_group_kernel(*args, n_live=nl, rows=r)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["cascade_group"] == before + 1
        wm, we, wp = cascade_group_kernel(*cpu, n_live=None if nl is None else int(nl),
                                          rows=torch.from_numpy(rows))
        assert torch.equal(p.cpu(), wp) and torch.equal(e.cpu(), we)
        pm, pe = cascade_group_plain(*args, n_live=nl)
        assert _same_margin(m, pm) and torch.equal(e, pe)
    if kind == "nan":
        assert (p[2] == -1).all() and (p[5] == -1).all()


@pytest.mark.parametrize("n_valid", [None, 0, 100, "host"])
@pytest.mark.parametrize("cap", [256, 1024, 1300])
def test_cascade_lane_step_equals_plain(dev, cap, n_valid):
    """B6's step form: lanes spread over S stages, a last stage narrower
    than W (masked columns), stop lanes, -0.0 partial sums; one launch
    (one CTA up to 1024 lanes, block prefixes and a combine past that)
    and all six outputs equal the plain version (``g`` by its bits)."""
    from repro_torch.kernels.cascade_kernel import cascade_lane_step, cascade_lane_step_plain

    rng = np.random.default_rng(cap)
    S, W = 64, 8
    stage = rng.integers(0, S, size=cap).astype(np.int32)
    stage[:S] = np.arange(S)
    ep = rng.uniform(0.5, 3.0, size=(S, W)).astype(np.float32)
    en = -rng.uniform(0.5, 3.0, size=(S, W)).astype(np.float32)
    col = np.ones((S, W), bool)
    col[S - 1, 5:] = False
    ep[S - 1, 5:], en[S - 1, 5:] = np.inf, -np.inf
    scores = rng.normal(size=(cap, W)).astype(np.float32)
    g0 = rng.normal(size=cap).astype(np.float32)
    g0[::5] = -0.0
    args = [_t(a, dev) for a in (g0, scores, stage, ep, en, col)]
    nv = {None: None, "host": cap - 17}.get(n_valid)
    if isinstance(n_valid, int):
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["cascade_lane"]
    got = cascade_lane_step(*args, n_valid=nv, block_n=64)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["cascade_lane"] == before + 1
    want = cascade_lane_step_plain(*args, n_valid=nv)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if n_valid != 0:
        assert 0 < int(got[5]) < cap and (got[3] > 0).any()


def test_run_grouped_on_card_equals_cpu(dev):
    from repro_torch.ranking import bucketing, fit_grouped, full_cascade_topk

    rng = np.random.default_rng(8)
    sizes = rng.integers(1, 40, size=37).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), 48)) * 0.15 + quality[:, None]
    gp = fit_grouped(F, sizes, 5, alpha=0.05, chunk_t=8)
    ordered = F.astype(np.float32)[:, gp.plan.order]
    off = bucketing.group_offsets(sizes)
    full = full_cascade_topk(F, sizes, gp.k, order=gp.plan.order)
    dplan = DevicePlan.from_plan(gp.plan)
    for eps in (gp.eps_g, np.full(gp.S, np.inf, np.float32)):
        for b, gidx in bucketing.pack_by_bucket(sizes, gp.buckets).items():
            rows, valid = bucketing.bucket_layout(sizes[gidx], b, offsets=off[gidx])
            res = [
                DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=d), device=d)
                .run_grouped(ordered, rows, valid, len(gidx), eps, gp.k, capacity_groups=40)
                for d in (dev, "cpu")
            ]
            np.testing.assert_array_equal(res[0].verdicts, res[1].verdicts)
            np.testing.assert_array_equal(res[0].exit_stage, res[1].exit_stage)
            np.testing.assert_array_equal(res[0].margin.view(np.int32), res[1].margin.view(np.int32))
            assert res[0].chunk_stats == res[1].chunk_stats
            if np.isinf(eps).all():
                np.testing.assert_array_equal(res[0].verdicts, full[gidx])


def test_grouped_server_on_card_equals_cpu(dev, small_gbt):
    """The ranking front door on the card: api.fit(groups=) -> compile ->
    serve with B3 as score_fn, against the same on the CPU and the host."""
    from repro_torch import api
    from repro_torch.launch.serve import _ragged_sizes
    from repro_torch.ranking import group_offsets

    ds, g, _ = small_gbt
    F = apply_gbt_scores(g.stacked(), torch.from_numpy(ds.x_train)).numpy()
    rng = np.random.default_rng(2031)
    sizes_tr = _ragged_sizes(len(ds.y_train), 8, rng)
    sizes_te = _ragged_sizes(len(ds.y_test), 8, rng)
    fitted = api.fit(F, groups=sizes_tr, topk=5, alpha=0.05, beta=-g.base_score)
    off = group_offsets(sizes_te)
    out = []
    for backend, d in (("device", dev), ("device", "cpu"), ("host", "cpu")):
        params = {k: v.to(d) for k, v in g.stacked().items()}
        srv = fitted.compile(backend, device=d).serve(
            score_fn=lambda x, p=params: apply_gbt_scores(p, x), batch_size=16
        )
        for i in range(sizes_te.size):
            srv.submit(ds.x_test[off[i] : off[i + 1]])
        out.append(srv.drain())
    assert out[0] == out[1]
    assert [r["ranking"] for r in out[0]] == [r["ranking"] for r in out[2]]
    assert [r["exit_stage"] for r in out[0]] == [r["exit_stage"] for r in out[2]]


def test_ranking_cli_serves_on_card(dev, capsys):
    serve.main(["--T", "40", "--scale", "0.1", "--alpha", "0.05", "--groups", "8",
                "--topk", "5"])
    out = capsys.readouterr().out
    assert "(device backend, batch)" in out and "NDCG@5 " in out


# -- quantised slabs (bf16, int8): B4 and B7 at each storage ------------------

QUANT_CASES = [("tree", "bf16"), ("tree", "int8"), ("lattice", "bf16"), ("lattice", "int8"),
               ("matrix", "bf16")]


def _quant_scorer(rng, variant, quant, dplan, dev, n_rows):
    """A scorer at ``quant`` with raw payloads (off the grid), and its
    operand at the slabs' storage dtype."""
    T, depth, d = 37, 5, 14
    if variant == "tree":
        sc = tree_stage_scorer(
            dplan, rng.integers(0, d, size=(T, depth)), rng.uniform(size=(T, depth)),
            rng.normal(size=(T, 1 << depth)), quant=quant, device=dev,
        )
        return sc, _t(rng.uniform(size=(n_rows, d)).astype(np.float32), dev)
    if variant == "lattice":
        d, S = 30, 8
        sc = lattice_stage_scorer(
            dplan, rng.normal(size=(T, 1 << S)),
            np.stack([rng.choice(d, S, replace=False) for _ in range(T)]), quant=quant,
            device=dev,
        )
        return sc, _t(rng.uniform(size=(n_rows, d)).astype(np.float32), dev)
    sc = matrix_stage_scorer(dplan, quant=quant, device=dev)
    return sc, sc.prepare(rng.normal(size=(n_rows, T))).to(torch.bfloat16)


@pytest.mark.parametrize("variant,quant", QUANT_CASES)
@pytest.mark.parametrize("n_valid", [0, 1, 100, 128])
def test_mega_stage_kernel_equals_plain_quantized(dev, variant, quant, n_valid):
    """B4 at bf16/int8 slabs equals its plain version exactly, at every
    stage (the lead, full ones, the ragged last), and counts its launches
    under ``mega_stage_{variant}_{quant}``."""
    rng = np.random.default_rng(31)
    dplan = DevicePlan.from_plan(_plan(rng), quant=quant)
    scorer, x = _quant_scorer(rng, variant, quant, dplan, dev, 128)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = _t(rng.normal(scale=0.5, size=128).astype(np.float32), dev)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    key = f"mega_stage_{variant}_{quant}"
    before = _build.LAUNCHES[key]
    for stage in range(dplan.S):
        t0 = int(dplan.stage_t0[stage])
        args = (scorer.slabs, x, g0, stage, t0, nv, *eps)
        for a, b in zip(mega_stage_kernel(*args, block_n=64), mega_stage_plain(*args, block_n=64)):
            assert torch.equal(a, b)
    assert _build.LAUNCHES[key] == before + dplan.S


@pytest.mark.parametrize("variant,quant", QUANT_CASES)
@pytest.mark.parametrize("n_valid", [0, 1, 100, 256])
def test_mega_lane_kernel_equals_plain_quantized(dev, variant, quant, n_valid):
    """B7 at bf16/int8 slabs equals its plain version exactly: lanes over
    every stage in one block (each with its own stage's scale), stop
    lanes, rows retiring mid-block, trash rows."""
    rng = np.random.default_rng(32)
    dplan = DevicePlan.from_plan(_plan(rng), quant=quant)
    scorer, x = _quant_scorer(rng, variant, quant, dplan, dev, 300)
    cap = 256
    stage = rng.integers(0, dplan.S, size=cap).astype(np.int32)
    stage[: dplan.S] = np.arange(dplan.S)
    rows = rng.permutation(300)[:cap]
    rows[n_valid:] = 299
    g0 = _t(rng.normal(scale=0.5, size=cap).astype(np.float32), dev)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    args = (scorer.slabs, x, _t(rows, dev), g0, _t(stage, dev), _t(stage >= dplan.S - 1, dev),
            nv, _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev))
    key = f"mega_lane_{variant}_{quant}"
    before = _build.LAUNCHES[key]
    got = mega_lane_kernel(*args, block_n=64)
    assert _build.LAUNCHES[key] == before + 1
    for a, b in zip(got, mega_lane_plain(*args, block_n=64)):
        assert torch.equal(a, b)


def test_quantized_wrappers_name_a_wrong_dtype(dev):
    """A payload, scale or operand at the wrong dtype raises naming it."""
    import dataclasses

    rng = np.random.default_rng(33)
    dplan = DevicePlan.from_plan(_plan(rng), quant="int8")
    tree, x = _quant_scorer(rng, "tree", "int8", dplan, dev, 128)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = torch.zeros(128, device=dev)
    rows, stage = torch.arange(128, device=dev), torch.zeros(128, dtype=torch.int32, device=dev)
    stop = torch.zeros(128, dtype=torch.bool, device=dev)
    bad_leaves = dataclasses.replace(
        tree.slabs, data={**tree.slabs.data, "payload": tree.slabs.data["payload"].float()})
    bad_scale = dataclasses.replace(tree.slabs, scale=tree.slabs.scale.double())
    for slabs, label in ((bad_leaves, "leaves"), (bad_scale, "scale")):
        with pytest.raises(ValueError, match=f"{label} has dtype"):
            mega_stage_kernel(slabs, x, g0, 0, 0, 128, *eps, block_n=64)
        with pytest.raises(ValueError, match=f"{label} has dtype"):
            mega_lane_kernel(slabs, x, rows, g0, stage, stop, 128, *eps, block_n=64)
    mplan = DevicePlan.from_plan(_plan(rng), quant="bf16")
    matrix, xq = _quant_scorer(rng, "matrix", "bf16", mplan, dev, 128)
    with pytest.raises(ValueError, match="x has dtype"):
        mega_stage_kernel(matrix.slabs, xq.float(), g0, 0, 0, 128, *eps, block_n=64)
    with pytest.raises(ValueError, match="x has dtype"):
        mega_lane_kernel(matrix.slabs, xq.float(), rows, g0, stage, stop, 128, *eps, block_n=64)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("ensemble", ["gbt", "lattice"])
@pytest.mark.parametrize("streaming", [False, True])
def test_quantized_server_on_card_equals_cpu(dev, small_gbt, ensemble, quant, streaming):
    """A quantised server (``TreeScorer``/``LatticeScorer(quant=)``,
    ``megakernel=True``) on the card against the same server on the CPU:
    results, billing and every per-row g bit for bit; the card ran only the
    quantised kernels of its path."""
    if ensemble == "gbt":
        ds, g, m = small_gbt
        scorer = TreeScorer(g.feats, g.thrs, g.leaves, quant=quant)
    else:
        ds = make_dataset("rw2", scale=0.1)
        lat = init_lattice_ensemble(40, ds.D, 8, seed=0, device="cpu")
        F = ops.lattice_scores(lat["theta"], lat["feats"], torch.from_numpy(ds.x_train))
        m = fit_qwyc(F.numpy().astype(np.float64), beta=0.0, alpha=0.01, mode="neg_only")
        scorer = LatticeScorer(lat["theta"], lat["feats"], quant=quant)
    arrivals = np.cumsum(np.random.default_rng(2028).exponential(1 / 16.0, size=len(ds.x_test)))
    variant = "tree" if ensemble == "gbt" else "lattice"
    out = []
    for d in (dev, "cpu"):
        kw = dict(scorer=scorer, exec_backend="device", device=d, batch_size=64,
                  backend_opts={"megakernel": True})
        srv = (StreamingServer(m, window=128, **kw) if streaming
               else QWYCServer(m, backend="kernel", **kw))
        _build.LAUNCHES.clear()
        for row, a in zip(ds.x_test, arrivals):
            srv.submit(row, arrival=a) if streaming else srv.submit(row)
        res = srv.drain()
        torch.cuda.synchronize()
        launched = {k for k, v in _build.LAUNCHES.items() if v}
        out.append((res, srv))
        want = set() if d == "cpu" else {f"mega_{'lane' if streaming else 'stage'}_{variant}_{quant}"}
        assert launched == want
    (a, sa), (b, sb) = out
    assert a == b
    assert sa.stats.scores_computed == sb.stats.scores_computed
    results = "stream_results" if streaming else "flush_results"
    for ra, rb in zip(getattr(sa, results), getattr(sb, results)):
        for k in ("decisions", "exit_step", "g_final"):
            np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))


# -- B4 and B7 lattice over every team shape, storage and block geometry ------

LATTICE_DIMS = [1, 2, 4, 5, 6, 8]  # sub-warp teams (S < 5), one warp, 2-8 values a lane


def _bits_equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _lattice_case(seed, S, quant, n_rows, dev):
    """A lattice scorer over 37 lattices of S of 30 features at ``quant``
    (raw normal vertex values, off every grid), stages of 8 with a ragged
    last one and thresholds that retire rows mid-block, and ``n_rows``
    feature rows (the first 10 at the cube's corners), all on ``dev``."""
    rng = np.random.default_rng(seed)
    T, d = 37, 30
    dplan = DevicePlan.from_plan(
        CascadePlan(order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
                    eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
                    chunk_t=8, lead_t=1),
        quant=quant,
    )
    scorer = lattice_stage_scorer(
        dplan, rng.normal(size=(T, 1 << S)),
        np.stack([rng.choice(d, S, replace=False) for _ in range(T)]), quant=quant, device=dev,
    )
    x = rng.uniform(size=(n_rows, d)).astype(np.float32)
    x[:10] = np.round(x[:10])
    return rng, dplan, scorer.slabs, _t(x, dev)


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S", LATTICE_DIMS)
def test_mega_stage_lattice_equals_plain_every_geometry(dev, S, quant):
    """B4 lattice equals its plain version bit for bit at every stage (the
    lead, full ones, the ragged last), n_valid 0 / partial / all, and
    blocks of 64 and of 50 rows (not a multiple of a warp) over a buffer
    whose last block is ragged; some rows retire mid-block."""
    rng, dplan, slabs, xr = _lattice_case(40 + S, S, quant, 200, dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = _t(rng.normal(scale=0.5, size=200).astype(np.float32), dev)
    key = "mega_stage_lattice" + ("" if quant == "f32" else f"_{quant}")
    mid_block, calls = 0, 0
    before = _build.LAUNCHES[key]
    for bn in (64, 50):
        for n_valid in (0, 117, 200):
            nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
            for stage in range(dplan.S):
                args = (slabs, xr, g0, stage, int(dplan.stage_t0[stage]), nv, *eps)
                got = mega_stage_kernel(*args, block_n=bn)
                _bits_equal(got, mega_stage_plain(*args, block_n=bn))
                live = got[3][:n_valid]
                mid_block += int(bool((live > 0).any() and (live == 0).any()))
                calls += 1
    assert _build.LAUNCHES[key] == before + calls
    assert mid_block > 0


@pytest.mark.parametrize("spread", [True, False], ids=["all-stages", "one-stage"])
@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S", LATTICE_DIMS)
def test_mega_lane_lattice_equals_plain_every_geometry(dev, S, quant, spread):
    """B7 lattice equals its plain version bit for bit with lanes spread
    over every stage (block 0 holds them all) or all at the ragged last
    stage, stop lanes, trash rows past n_valid, n_valid 0 / partial / all,
    and blocks of 64 and of 50 rows; some rows retire mid-block."""
    cap = 256
    rng, dplan, slabs, xt = _lattice_case(60 + S, S, quant, 300, dev)
    if spread:
        stage = rng.integers(0, dplan.S, size=cap).astype(np.int32)
        stage[: dplan.S] = np.arange(dplan.S)
        stop = stage >= dplan.S - 1
    else:
        stage = np.full(cap, dplan.S - 1, dtype=np.int32)
        stop = rng.uniform(size=cap) < 0.5
    key = "mega_lane_lattice" + ("" if quant == "f32" else f"_{quant}")
    g0 = _t(rng.normal(scale=0.5, size=cap).astype(np.float32), dev)
    stage_t, stop_t = _t(stage, dev), _t(stop, dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    mid_block, calls = 0, 0
    before = _build.LAUNCHES[key]
    for bn in (64, 50):
        for n_valid in (0, 151, cap):
            rows = rng.permutation(300)[:cap]
            rows[n_valid:] = 299
            nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
            args = (slabs, xt, _t(rows, dev), g0, stage_t, stop_t, nv, *eps)
            got = mega_lane_kernel(*args, block_n=bn)
            _bits_equal(got, mega_lane_plain(*args, block_n=bn))
            live = got[3][:n_valid]
            mid_block += int(bool((live > 0).any() and (live == 0).any()))
            calls += 1
    assert _build.LAUNCHES[key] == before + calls
    assert mid_block > 0


# -- B4 and B7 tree at every depth, storage and block geometry --------------

# depths 1 and 10 (B3's old limit), exp1's and exp2's depths (5, 9), either
# side of the scorer's unrolled group of 10 levels (8, 12), and the deepest
# tree whose staged leaf table fits a CTA (15, B4's limit)
TREE_DEPTHS = [1, 2, 3, 5, 8, 9, 10, 12, 15]


def _tree_case(seed, depth, quant, n_rows, dev):
    """37 oblivious trees of ``depth`` over 14 features at ``quant`` (raw
    normal leaves, off every grid), stages of 8 with a ragged last one,
    thresholds that retire rows mid-block, and ``n_rows`` feature rows (the
    first 10 on a threshold of a tree: the compare is strict), on ``dev``."""
    rng = np.random.default_rng(seed)
    T, d = 37, 14
    dplan = DevicePlan.from_plan(
        CascadePlan(order=np.arange(T), eps_pos=rng.uniform(0.3, 1.5, size=T),
                    eps_neg=-rng.uniform(0.3, 1.5, size=T), beta=0.0, costs=np.ones(T),
                    chunk_t=8, lead_t=1),
        quant=quant,
    )
    feats = rng.integers(0, d, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(scale=0.6, size=(T, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(n_rows, d)).astype(np.float32)
    for r in range(10):
        x[r, feats[r, 0]] = thrs[r, 0]
    slabs = build_tree_slabs(dplan, feats, thrs, leaves, quant=quant, device=dev)
    return rng, dplan, slabs, _t(x, dev)


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("depth", TREE_DEPTHS)
def test_mega_stage_tree_equals_plain_every_geometry(dev, depth, quant):
    """B4 tree equals its plain version bit for bit at every stage (the
    lead, full ones, the ragged last), n_valid 0 / partial / all, and
    blocks of 64 and of 50 rows over a buffer whose last block is ragged;
    some rows retire mid-block."""
    rng, dplan, slabs, xr = _tree_case(80 + depth, depth, quant, 200, dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = _t(rng.normal(scale=0.5, size=200).astype(np.float32), dev)
    key = "mega_stage_tree" + ("" if quant == "f32" else f"_{quant}")
    mid_block, calls = 0, 0
    before = _build.LAUNCHES[key]
    for bn in (64, 50):
        for n_valid in (0, 117, 200):
            nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
            for stage in range(dplan.S):
                args = (slabs, xr, g0, stage, int(dplan.stage_t0[stage]), nv, *eps)
                got = mega_stage_kernel(*args, block_n=bn)
                _bits_equal(got, mega_stage_plain(*args, block_n=bn))
                live = got[3][:n_valid]
                mid_block += int(bool((live > 0).any() and (live == 0).any()))
                calls += 1
    assert _build.LAUNCHES[key] == before + calls
    assert mid_block > 0


@pytest.mark.parametrize("spread", [True, False], ids=["all-stages", "one-stage"])
@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("depth", TREE_DEPTHS + [16])
def test_mega_lane_tree_equals_plain_every_geometry(dev, depth, quant, spread):
    """B7 tree equals its plain version bit for bit with lanes spread over
    every stage (block 0 holds them all) or all at the ragged last stage,
    stop lanes, trash rows past n_valid, n_valid 0 / partial / all, blocks
    of 64 and of 50 rows, and depth 16 (past B4's limit: streaming reads
    leaves in place); some rows retire mid-block and some stop lane runs
    out active."""
    cap = 256
    rng, dplan, slabs, xt = _tree_case(100 + depth, depth, quant, 300, dev)
    if spread:
        stage = rng.integers(0, dplan.S, size=cap).astype(np.int32)
        stage[: dplan.S] = np.arange(dplan.S)
        stop = stage >= dplan.S - 1
    else:
        stage = np.full(cap, dplan.S - 1, dtype=np.int32)
        stop = rng.uniform(size=cap) < 0.5
    key = "mega_lane_tree" + ("" if quant == "f32" else f"_{quant}")
    g0 = _t(rng.normal(scale=0.5, size=cap).astype(np.float32), dev)
    stage_t, stop_t = _t(stage, dev), _t(stop, dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    mid_block, ran_out, calls = 0, 0, 0
    before = _build.LAUNCHES[key]
    for bn in (64, 50):
        for n_valid in (0, 151, cap):
            rows = rng.permutation(300)[:cap]
            rows[n_valid:] = 299
            nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
            args = (slabs, xt, _t(rows, dev), g0, stage_t, stop_t, nv, *eps)
            got = mega_lane_kernel(*args, block_n=bn)
            _bits_equal(got, mega_lane_plain(*args, block_n=bn))
            live = got[3][:n_valid]
            mid_block += int(bool((live > 0).any() and (live == 0).any()))
            ran_out += int(bool(((got[1] == 1) & stop_t).any()))
            calls += 1
    assert _build.LAUNCHES[key] == before + calls
    assert mid_block > 0 and ran_out > 0


def test_tree_depth_past_the_limit_raises(dev):
    """B4 refuses a tree deeper than its staged leaf table allows, naming
    the limit; B7 takes it."""
    rng, dplan, slabs, xt = _tree_case(7, 16, "f32", 64, dev)
    eps = _t(dplan.eps_pos, dev), _t(dplan.eps_neg, dev)
    g0 = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match=r"mega_stage: tree depth 16 not in \[0, 15\]"):
        mega_stage_kernel(slabs, xt, g0, 1, 1, 64, *eps, block_n=64)
    stage = torch.ones(64, dtype=torch.int32, device=dev)
    rows = torch.arange(64, device=dev)
    stop = torch.zeros(64, dtype=torch.bool, device=dev)
    mega_lane_kernel(slabs, xt, rows, g0, stage, stop, 64, *eps, block_n=64)


def test_step_kernels_hold_no_stack(dev):
    """Every tree and lattice instantiation of ``step_kernel``, and every
    instantiation of ``matrix_step_kernel``, keeps its arrays in registers: the build log shows 0 bytes of stack frame and no
    spills for each."""
    steps = {}
    for name, res in _build.kernel_resources("mega_stage").items():
        label = _build.step_kernel_label(name)
        if label:
            steps[label] = res
    # B4/B7 x f32/bf16/int8 x (tree, S 1-8), and B4/B7 matrix x f32/bf16
    assert len(steps) == 2 * 3 * (1 + 8) + 2 * 2
    assert {k: v for k, v in steps.items() if v["stack"] or v["spill"]} == {}


# -- the captured loops: one CUDA graph per program key ----------------------

# (variant, slab storage, fused): the matrix scorer's quantised storage runs
# fused only
CAPTURE_CASES = [
    (v, q, fused) for v in ("tree", "lattice", "matrix") for q in ("f32", "bf16", "int8")
    for fused in (True, False) if v != "matrix" or (q, fused) in (("f32", True), ("f32", False),
                                                                  ("bf16", True))
]


def _capture_case(variant, quant, dev, n_rows):
    """A scorer at ``quant`` on ``dev`` and ``n_rows`` rows of its input
    (numpy, what ``prepare`` takes), over a 37-model plan."""
    rng = np.random.default_rng(41)
    dplan = DevicePlan.from_plan(_plan(rng, T=37, chunk_t=8, lead_t=1), quant=quant)
    T, depth, d = 37, 5, 14
    if variant == "tree":
        sc = tree_stage_scorer(
            dplan, rng.integers(0, d, size=(T, depth)), rng.uniform(size=(T, depth)),
            rng.normal(size=(T, 1 << depth)), quant=quant, device=dev,
        )
        return dplan, sc, rng.uniform(size=(n_rows, d)).astype(np.float32)
    if variant == "lattice":
        d, S = 30, 8
        sc = lattice_stage_scorer(
            dplan, rng.normal(size=(T, 1 << S)),
            np.stack([rng.choice(d, S, replace=False) for _ in range(T)]), quant=quant,
            device=dev,
        )
        return dplan, sc, rng.uniform(size=(n_rows, d)).astype(np.float32)
    sc = matrix_stage_scorer(dplan, quant=quant, device=dev)
    return dplan, sc, rng.normal(size=(n_rows, T)).astype(np.float32)


def _counted(fn):
    """``fn()`` and the kernel launches it made (counts set to 0 before)."""
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.LAUNCHES.items() if v}


def _assert_graphs(ex, keys: int):
    """``keys`` program keys: a trace each, and a graph each when captured."""
    assert ex.traces == keys
    assert len(ex._graphs) == (keys if ex.capture else 0)


@pytest.mark.parametrize("variant,quant,fused", CAPTURE_CASES)
def test_captured_batch_equals_eager(dev, variant, quant, fused):
    """The batch stage loop replayed as a CUDA graph equals the eager loop
    on the card (``capture=False``) bit for bit over flushes of 256, 256
    and 100 rows at a pinned capacity of 256: decisions, exits, g_final's
    bits, the live counts, billing and each flush's launches.  One graph:
    the first flush runs eagerly, the second captures and replays it, the
    third replays it."""
    dplan, sc, X = _capture_case(variant, quant, dev, 612)
    flushes = [(0, 256), (256, 256), (512, 100)]
    out = {}
    for capture in (True, False):
        rng = np.random.default_rng(5)  # the same row orders for both
        ex = DeviceExecutor(dplan, sc, megakernel=fused, device=dev, capture=capture)
        runs = []
        for i, (a, n) in enumerate(flushes):
            runs.append(_counted(lambda a=a, n=n: ex.run(
                X[a : a + n], n, capacity=256, row_order=rng.permutation(n))))
            if i == 0:
                assert ex.traces == 1 and not ex._graphs  # a key's first run is eager
            if i == 1:
                graphs = dict(ex._graphs)
        _assert_graphs(ex, 1)
        assert ex._graphs == graphs  # nothing recaptured by the third flush
        out[capture] = runs
    for (a, la), (b, lb) in zip(out[True], out[False]):
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.exit_step, b.exit_step)
        np.testing.assert_array_equal(a.g_final.view(np.int32), b.g_final.view(np.int32))
        assert a.chunk_stats == b.chunk_stats and a.scores_computed == b.scores_computed
        assert la == lb and sum(la.values()) > 0
    # the flushes differ, so no replay returned a stale result
    assert not np.array_equal(out[True][0][0].g_final, out[True][1][0].g_final)


@pytest.mark.parametrize("rate", [256.0, 4.0])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("variant", ["tree", "lattice", "matrix"])
def test_captured_stream_equals_eager(dev, variant, fused, rate):
    """The streaming burst replayed as a CUDA graph equals the eager loop
    on the card in every field of every wave (two waves of one ring
    geometry: 300 and 212 rows, 64 lanes), steps enqueued, syncs and each
    wave's launches; one graph."""
    dplan, sc, X = _capture_case(variant, "f32", dev, 512)
    arr = np.floor(np.cumsum(np.random.default_rng(2028).exponential(1 / rate, size=512)))
    waves = [(0, 300), (300, 212)]
    out = {}
    for capture in (True, False):
        ex = DeviceExecutor(dplan, sc, megakernel=fused, device=dev, capture=capture)
        out[capture] = [
            _counted(lambda a=a, n=n: ex.run_stream(
                X[a : a + n], n, arrivals=(arr[a : a + n] - arr[a]).astype(np.int64),
                capacity=64, ring_capacity=300))
            for a, n in waves
        ]
        _assert_graphs(ex, 1)
    for (a, la), (b, lb) in zip(out[True], out[False]):
        for k in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_array_equal(a.g_final.view(np.int32), b.g_final.view(np.int32))
        assert (a.steps_run, a.steps_enqueued, a.syncs, a.scores_computed) == (
            b.steps_run, b.steps_enqueued, b.syncs, b.scores_computed)
        assert la == lb and sum(la.values()) > 0


def test_captured_grouped_equals_eager(dev):
    """The grouped loop replayed as CUDA graphs (one per bucket shape)
    equals the eager loop on the card over ragged buckets, at the fitted
    thresholds, at +inf (the same programs: captured here) and at the
    fitted thresholds again (replayed): verdicts, exit stages, margins'
    bits, live counts and each run's launches."""
    from repro_torch.ranking import bucketing, fit_grouped

    rng = np.random.default_rng(8)
    sizes = rng.integers(1, 40, size=37).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), 48)) * 0.15 + quality[:, None]
    gp = fit_grouped(F, sizes, 5, alpha=0.05, chunk_t=8)
    ordered = F.astype(np.float32)[:, gp.plan.order]
    off = bucketing.group_offsets(sizes)
    dplan = DevicePlan.from_plan(gp.plan)
    packs = sorted(bucketing.pack_by_bucket(sizes, gp.buckets).items())
    out = {}
    for capture in (True, False):
        ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=dev), device=dev,
                            capture=capture)
        out[capture] = [
            _counted(lambda rows=rows, valid=valid, g=len(gidx), eps=eps: ex.run_grouped(
                ordered, rows, valid, g, eps, gp.k, capacity_groups=40))
            for eps in (gp.eps_g, np.full(gp.S, np.inf, np.float32), gp.eps_g)
            for b, gidx in packs
            for rows, valid in [bucketing.bucket_layout(sizes[gidx], b, offsets=off[gidx])]
        ]
        _assert_graphs(ex, len(packs))
    for (a, la), (b, lb) in zip(out[True], out[False]):
        np.testing.assert_array_equal(a.verdicts, b.verdicts)
        np.testing.assert_array_equal(a.exit_stage, b.exit_stage)
        np.testing.assert_array_equal(a.margin.view(np.int32), b.margin.view(np.int32))
        assert a.chunk_stats == b.chunk_stats and la == lb and sum(la.values()) > 0


def test_capture_at_second_run_and_graph_bound(dev, monkeypatch):
    """A key's first run is eager and captures nothing; its second captures
    and replays.  Past ``MAX_GRAPHS`` graphs the one used last longest ago
    is dropped, and its key is captured again when it returns; ``traces``
    still counts keys.  Every run equals ``capture=False``."""
    monkeypatch.setattr(device_executor, "MAX_GRAPHS", 2)
    dplan, sc, X = _capture_case("matrix", "f32", dev, 300)
    caps = [64, 64, 128, 128, 192, 192, 64, 64]
    ex = DeviceExecutor(dplan, sc, device=dev)
    tw = DeviceExecutor(dplan, sc, device=dev, capture=False)
    graphs_seen = []
    for i, cap in enumerate(caps):
        n = cap - 7 * i
        a = ex.run(X[:n], n, capacity=cap)
        b = tw.run(X[:n], n, capacity=cap)
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.exit_step, b.exit_step)
        np.testing.assert_array_equal(a.g_final.view(np.int32), b.g_final.view(np.int32))
        assert a.chunk_stats == b.chunk_stats
        graphs_seen.append(sorted(k[1] for k in ex._graphs))
    assert graphs_seen == [[], [64], [64], [64, 128], [64, 128], [128, 192], [64, 192],
                           [64, 192]]
    assert ex.traces == tw.traces == 3 and not tw._graphs


@pytest.mark.parametrize("megakernel", [None, False])
def test_captured_server_equals_eager(dev, small_gbt, megakernel):
    """The sorted-kernel server (the operand padded once and written into
    the graph's static buffer) captured against ``capture=False``: results,
    every flush's g_final bits, billing and launches; one graph over the
    full flushes and the partial last one."""
    ds, g, m = small_gbt
    out = []
    for capture in (True, False):
        srv = QWYCServer(m, scorer=TreeScorer(g.feats, g.thrs, g.leaves), exec_backend="device",
                         device=dev, batch_size=64,
                         backend_opts={"megakernel": megakernel, "capture": capture})

        def serve_all(srv=srv):
            for row in ds.x_test:
                srv.submit(row)
            return srv.drain()

        res, launches = _counted(serve_all)
        _assert_graphs(srv._dev[0], 1)
        out.append((res, launches, srv))
    (a, la, sa), (b, lb, sb) = out
    assert a == b and la == lb
    assert sa.stats.scores_computed == sb.stats.scores_computed
    assert len(sa.flush_results) == len(sb.flush_results) > 2
    for ra, rb in zip(sa.flush_results, sb.flush_results):
        np.testing.assert_array_equal(ra.g_final.view(np.int32), rb.g_final.view(np.int32))


# -- grouped streaming: the admission ring captured, B8 at per-slot thresholds


def _stream_fixture():
    from repro_torch.ranking import bucketing, fit_grouped

    rng = np.random.default_rng(8)
    sizes = rng.integers(1, 40, size=70).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), 48)) * 0.15 + quality[:, None]
    gp = fit_grouped(F, sizes, 5, alpha=0.05, chunk_t=8)
    ordered = F.astype(np.float32)[:, gp.plan.order]
    off = bucketing.group_offsets(sizes)
    packs = sorted(bucketing.pack_by_bucket(sizes, gp.buckets).items())
    layouts = [(b, len(gidx), *bucketing.bucket_layout(sizes[gidx], b, offsets=off[gidx]))
               for b, gidx in packs]
    return gp, ordered, layouts


@pytest.mark.parametrize("cap", [8, None], ids=["refill", "all"])
@pytest.mark.parametrize("arrivals", ["none", "staggered"])
def test_captured_grouped_stream_equals_eager(dev, arrivals, cap):
    """The grouped admission ring replayed as CUDA graphs (one per bucket
    shape: a run eager, a run captured, a run replayed) equals the eager
    loop on the card and the loop on the CPU bit for bit: verdicts, exit
    stages, margins' bits, the admit / done timeline, steps, the bill and
    each run's launches (B8 once a step enqueued)."""
    gp, ordered, layouts = _stream_fixture()
    dplan = DevicePlan.from_plan(gp.plan)
    out = {}
    for name, d, capture in (("captured", dev, True), ("eager", dev, False),
                             ("cpu", "cpu", True)):
        ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=d), device=d,
                            capture=capture)
        runs = []
        for _ in range(3):
            for b, n, rows, valid in layouts:
                arr = None if arrivals == "none" else (np.arange(n) // 3).astype(np.int32)
                runs.append(_counted(lambda: ex.run_stream_grouped(
                    ordered, rows, valid, n, gp.eps_g, gp.k, arrivals=arr,
                    capacity_groups=cap)))
        if d != "cpu":
            _assert_graphs(ex, len(layouts))
        out[name] = runs
    refilled = more = 0
    for (a, la), (b, lb), (c, _) in zip(out["captured"], out["eager"], out["cpu"]):
        for other in (b, c):
            for k in ("verdicts", "exit_stage", "admit_step", "done_step", "occupancy"):
                np.testing.assert_array_equal(getattr(a, k), getattr(other, k))
            np.testing.assert_array_equal(a.margin.view(np.int32), other.margin.view(np.int32))
            for k in ("steps_run", "scores_computed", "steps_enqueued", "syncs"):
                assert getattr(a, k) == getattr(other, k)
        assert la == lb == {"cascade_group": a.steps_enqueued}
        waited = a.capacity_groups < a.verdicts.shape[0]
        refilled += int(waited and a.occupancy.max() == a.capacity_groups)
        more += int(waited)
    if cap is not None and arrivals == "none":
        # every bucket of more groups than slots fills them at step 0
        assert refilled == more > 0


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("B", [4, 32, 64])
def test_group_kernel_per_slot_thresholds_equal_plain(dev, B, k):
    """B8 as the grouped streaming step launches it: each slot's threshold
    is its own stage's (``eps_g[stage]``, gathered on the card, +inf among
    the stage values), ``n_live`` a device scalar, with ``rows``: picks,
    exits and margins' bits equal the plain version."""
    from repro_torch.kernels.cascade_kernel import cascade_group_kernel, group_topk_rows

    rng = np.random.default_rng(B * 10 + k)
    G, S = 256, 8
    g = rng.integers(-3, 4, size=(G, B)).astype(np.float32)
    g[1::2] += rng.normal(scale=0.3, size=(G, B))[1::2].astype(np.float32)
    sizes = rng.integers(1, B + 1, size=G)
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    rows = _t(rng.integers(0, 1 << 30, size=(G, B)).astype(np.int64), dev)
    eps_g = np.sort(rng.uniform(0.0, 2.0, size=S)).astype(np.float32)
    eps_g[0], eps_g[-1] = 0.0, np.inf
    stage = _t(rng.integers(0, S, size=G).astype(np.int32), dev)
    eps = _t(eps_g, dev)[stage]
    gt, vt = _t(g, dev), _t(valid, dev)
    exits = 0
    for nl in (0, 100, G):
        n_live = torch.tensor(nl, dtype=torch.int32, device=dev)
        m, e, p = cascade_group_kernel(gt, vt, eps, k, n_live=n_live, rows=rows)
        torch.cuda.synchronize()
        wm, we = cascade_group_plain(gt, vt, eps, k, n_live=n_live)
        assert torch.equal(p, group_topk_rows(gt, vt, rows, k))
        assert torch.equal(e, we) and torch.equal(m.view(torch.int32), wm.view(torch.int32))
        exits += int(e.sum())
    assert exits > 0


@pytest.mark.parametrize("policy", ["skip-ahead", "wait"])
def test_grouped_streaming_server_on_card_equals_cpu(dev, small_gbt, policy):
    """``serve(streaming=True, policy=)`` with B3 as score_fn on the card
    against the same on the CPU (every wave's timeline and the results)
    and the host rung's batch results."""
    from repro_torch import api
    from repro_torch.launch.serve import _ragged_sizes
    from repro_torch.ranking import group_offsets

    ds, g, _ = small_gbt
    F = apply_gbt_scores(g.stacked(), torch.from_numpy(ds.x_train)).numpy()
    rng = np.random.default_rng(2031)
    sizes_tr = _ragged_sizes(len(ds.y_train), 8, rng)
    sizes_te = _ragged_sizes(len(ds.y_test), 8, rng)
    fitted = api.fit(F, groups=sizes_tr, topk=5, alpha=0.05, beta=-g.base_score)
    off = group_offsets(sizes_te)
    arr = np.cumsum(np.random.default_rng(2028).exponential(0.25, size=sizes_te.size))
    out, srvs = [], []
    for backend, d, streaming in (("device", dev, True), ("device", "cpu", True),
                                  ("host", "cpu", False)):
        params = {k: v.to(d) for k, v in g.stacked().items()}
        srv = fitted.compile(backend, device=d).serve(
            score_fn=lambda x, p=params: apply_gbt_scores(p, x), batch_size=16,
            streaming=streaming, policy=policy if streaming else "sorted-kernel",
        )
        for i in range(sizes_te.size):
            srv.submit(ds.x_test[off[i] : off[i + 1]], arrival=float(arr[i]))
        out.append(srv.drain())
        srvs.append(srv)
    assert out[0] == out[1]
    assert [r["ranking"] for r in out[0]] == [r["ranking"] for r in out[2]]
    assert [r["exit_stage"] for r in out[0]] == [r["exit_stage"] for r in out[2]]
    assert vars(srvs[0].stats) == vars(srvs[1].stats)
    for a, b in zip(srvs[0].stream_results, srvs[1].stream_results):
        np.testing.assert_array_equal(a.admit_step, b.admit_step)
        np.testing.assert_array_equal(a.done_step, b.done_step)
        assert a.steps_enqueued == b.steps_enqueued and a.syncs == b.syncs
