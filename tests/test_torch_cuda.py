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
from repro_torch.kernels import _build
from repro_torch.ensembles.lattice import init_lattice_ensemble
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_chunk_plain,
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
