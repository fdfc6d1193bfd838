"""Ranking (query-level early exit) of the PyTorch port against the JAX
package on the CPU.

Inputs are made with numpy from a seed and go through both packages.  Every
comparison is exact (tolerance 0): the grouped fit (order, thresholds,
buckets, train exits), the host oracle, the group decide B8's plain version
against JAX's ``cascade_group_pallas`` (interpret mode, as the JAX package's
own tests run it) and numpy's ``topk_margin``, ``group_topk_rows``, the
grouped stage loop ``run_grouped`` (``device="cpu"``, matrix scorer) against
JAX's ``DeviceExecutor(..., megakernel=False).run_grouped``, the billing of
the perf gate's grouped fixture against ``baseline_billing.json``, the
``GroupedRankServer``, ``api.fit(groups=).compile(...).rank()`` and the
``--groups`` CLI.  Margins are compared by their bits.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.bench_ranking import BLOCK_N, BUCKETS, CHUNK_T, K, ranking_fixture
from repro import api as japi
from repro.core import evaluate_cascade as j_evaluate_cascade
from repro.kernels import device_executor as jde
from repro.kernels.cascade_kernel import cascade_group_pallas
from repro.ranking import GroupedRankServer as JServer
from repro.ranking import bucketing as jb
from repro.ranking import fit_grouped as j_fit_grouped
from repro.ranking import full_cascade_topk as j_full_cascade_topk
from repro.ranking import ndcg_at_k as j_ndcg_at_k
from repro.ranking import run_grouped_host as j_run_grouped_host
from repro.ranking.plan import topk_margin as j_topk_margin
from repro_torch import api
from repro_torch.convert import grouped_plan_from_numpy, qwyc_model_from_numpy
from repro_torch.data.synthetic import make_dataset
from repro_torch.ensembles.gbt import apply_gbt_scores, train_gbt
from repro_torch.kernels.cascade_kernel import cascade_group_kernel, cascade_group_plain
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    group_topk_rows,
    matrix_stage_scorer,
)
from repro_torch.launch import serve
from repro_torch.ranking import (
    MARGIN_INF,
    GroupedRankServer,
    bucketing,
    fit_grouped,
    full_cascade_topk,
    ndcg_at_k,
    run_grouped_host,
    topk_margin,
)

ROOT = Path(__file__).resolve().parents[1]


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ragged(seed, G=23, T=24, lo=1, hi=20):
    """Ragged groups with heavy-tailed latent quality (singletons and
    sub-k groups included), so the margin criterion fires."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=G).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), T)) * 0.15 + quality[:, None]
    return F, sizes


def _port_plan(jgp):
    """The JAX ``GroupedPlan`` carried across with ``convert``."""
    m = jgp.model
    model = qwyc_model_from_numpy(
        m.order, m.eps_pos, m.eps_neg, m.beta, m.costs, m.alpha, m.mode
    )
    return grouped_plan_from_numpy(
        model, jgp.eps_g, jgp.k, jgp.buckets, jgp.plan.chunk_t,
        train_exit_stage=jgp.train_exit_stage,
        train_disagreement=jgp.train_disagreement,
    )


def _executors(gp, jgp, block_n):
    dplan = DevicePlan.from_plan(gp.plan)
    ex = DeviceExecutor(
        dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=block_n, device="cpu"
    )
    jdplan = jde.DevicePlan.from_plan(jgp.plan)
    jex = jde.DeviceExecutor(
        jdplan, scorer=jde.matrix_stage_scorer(jdplan), block_n=block_n,
        megakernel=False,
    )
    return ex, jex


@pytest.fixture(scope="module")
def bench():
    """``bench_ranking.py``'s fixture at its --quick sizes, fitted at the
    middle of its alphas by both packages."""
    F, sizes, rel = ranking_fixture(quick=True)
    jgp = j_fit_grouped(F, sizes, K, alpha=0.05, chunk_t=CHUNK_T, buckets=BUCKETS)
    gp = fit_grouped(F, sizes, K, alpha=0.05, chunk_t=CHUNK_T, buckets=BUCKETS)
    return F, sizes, rel, jgp, gp


# -- host numpy ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("B", [4, 8, 32, 128])
def test_topk_margin_matches_jax(B, k):
    rng = np.random.default_rng(B * 100 + k)
    G = 40
    g = rng.integers(-3, 4, size=(G, B)).astype(np.float32)  # forced ties
    sizes = rng.integers(1, B + 1, size=G)
    sizes[:4] = np.minimum([1, k, k + 1, B], B)  # size <= k and just past it
    valid = np.arange(B)[None, :] < sizes[:, None]
    idx, margin = topk_margin(g, valid, k)
    jidx, jmargin = j_topk_margin(g, valid, k)
    assert np.array_equal(idx, jidx)
    assert np.array_equal(_bits(margin), _bits(jmargin))
    assert np.isinf(margin[sizes <= k]).all()


@pytest.mark.parametrize("alpha", [0.02, 0.05, 0.1])
def test_fit_grouped_matches_jax(alpha):
    F, sizes, _ = ranking_fixture(quick=True)
    jgp = j_fit_grouped(F, sizes, K, alpha=alpha, chunk_t=CHUNK_T)
    gp = fit_grouped(F, sizes, K, alpha=alpha, chunk_t=CHUNK_T)
    assert np.array_equal(gp.plan.order, jgp.plan.order)
    assert gp.plan.stages == jgp.plan.stages
    assert np.array_equal(gp.model.eps_pos, jgp.model.eps_pos)
    assert np.array_equal(gp.model.eps_neg, jgp.model.eps_neg)
    assert np.array_equal(_bits(gp.eps_g), _bits(jgp.eps_g))
    assert gp.buckets == jgp.buckets and gp.k == jgp.k == K
    assert np.array_equal(gp.train_exit_stage, jgp.train_exit_stage)
    assert gp.train_disagreement == jgp.train_disagreement <= alpha
    # carried across, the JAX plan is the port's own
    carried = _port_plan(jgp)
    assert carried.plan.stages == gp.plan.stages
    assert np.array_equal(_bits(carried.eps_g), _bits(gp.eps_g))


def test_fit_grouped_rejects_what_jax_rejects():
    F, sizes = _ragged(0)
    for bad in (F[:, 0], F[:-1]):
        with pytest.raises(ValueError):
            fit_grouped(bad, sizes, 3)
    with pytest.raises(ValueError, match="at least one document"):
        fit_grouped(F, np.concatenate([sizes[:-1], [0], sizes[-1:]]), 3)


def test_bucketing_matches_jax():
    sizes = np.array([1, 3, 4, 5, 9, 17, 130, 2, 64, 65, 300], dtype=np.int64)
    assert np.array_equal(bucketing.group_offsets(sizes), jb.group_offsets(sizes))
    for ladder in (bucketing.DEFAULT_BUCKETS, BUCKETS, (5,)):
        assert bucketing.bucket_widths_for(sizes, ladder) == jb.bucket_widths_for(sizes, ladder)
        got, want = bucketing.pack_by_bucket(sizes, ladder), jb.pack_by_bucket(sizes, ladder)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[b], want[b]) for b in got)
    off = bucketing.group_offsets(sizes)
    for b, gidx in bucketing.pack_by_bucket(sizes).items():
        rows, valid = bucketing.bucket_layout(sizes[gidx], b, offsets=off[gidx])
        jrows, jvalid = jb.bucket_layout(sizes[gidx], b, offsets=off[gidx])
        assert np.array_equal(rows, jrows) and np.array_equal(valid, jvalid)
    with pytest.raises(ValueError, match="does not fit"):
        bucketing.bucket_layout(np.array([9]), 8)


@pytest.mark.parametrize("margin_inf", [False, True])
def test_run_grouped_host_matches_jax(bench, margin_inf):
    F, sizes, _, jgp, gp = bench
    eps = np.full(gp.S, MARGIN_INF, np.float32) if margin_inf else None
    res = run_grouped_host(gp, F, sizes, eps_g=eps)
    jres = j_run_grouped_host(jgp, F, sizes, eps_g=eps)
    assert np.array_equal(res.verdicts, jres.verdicts)
    assert np.array_equal(res.exit_stage, jres.exit_stage)
    assert np.array_equal(_bits(res.margin), _bits(jres.margin))
    assert [vars(c) for c in res.chunk_stats] == [vars(c) for c in jres.chunk_stats]
    assert (res.scores_computed, res.scores_possible) == (
        jres.scores_computed, jres.scores_possible,
    )
    full = full_cascade_topk(F, sizes, gp.k, order=gp.plan.order)
    assert np.array_equal(full, j_full_cascade_topk(F, sizes, gp.k, order=jgp.plan.order))
    if margin_inf:
        assert np.array_equal(res.verdicts, full)
        assert (res.exit_stage == gp.S).all()
    else:
        assert res.scores_computed < res.scores_possible


def test_ndcg_matches_jax(bench):
    F, sizes, rel, _, gp = bench
    verdicts = run_grouped_host(gp, F, sizes).verdicts
    for k in (1, K, 10):
        v = verdicts[:, :k] if k <= gp.k else verdicts
        assert ndcg_at_k(rel, v, sizes, k) == j_ndcg_at_k(rel, v, sizes, k)
    assert ndcg_at_k(rel, verdicts, np.zeros(0, np.int64), K) == 1.0


# -- B8 and the grouped stage loop ---------------------------------------


@pytest.mark.parametrize(
    "case", ["ties", "n_live<G", "n_live=0", "eps=+inf", "eps=0", "size<=k"]
)
@pytest.mark.parametrize("k", [1, 3, 10])
def test_cascade_group_plain_bit_identical_to_pallas(case, k):
    rng = np.random.default_rng(7 + k)
    G, B = 21, 32
    g = rng.integers(-2, 3, size=(G, B)).astype(np.float32)
    if case not in ("ties", "eps=0"):
        g = g + rng.normal(scale=0.25, size=(G, B)).astype(np.float32)
    hi = k + 1 if case == "size<=k" else B + 1
    sizes = rng.integers(1, hi, size=G)
    valid = (np.arange(B)[None, :] < sizes[:, None]).astype(np.int32)
    eps = rng.uniform(0.0, 1.5, size=G).astype(np.float32)
    eps = {"eps=+inf": np.full(G, np.inf, np.float32), "eps=0": np.zeros(G, np.float32)}.get(
        case, eps
    )
    n_live = {"n_live<G": 13, "n_live=0": 0}.get(case)
    jm, je = cascade_group_pallas(
        jnp.asarray(g), jnp.asarray(valid), jnp.asarray(eps), k, interpret=True,
        n_live=None if n_live is None else jnp.int32(n_live),
    )
    nl = None if n_live is None else torch.tensor(n_live, dtype=torch.int32)
    m, e = cascade_group_plain(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(eps), k, nl)
    assert np.array_equal(_bits(m.numpy()), _bits(jm))
    assert np.array_equal(e.numpy(), np.asarray(je))
    _, want = topk_margin(g, valid.astype(bool), k)
    assert np.array_equal(_bits(m.numpy()), _bits(want))
    # the wrapper sends a CPU tensor to the plain version
    m2, e2 = cascade_group_kernel(
        torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(eps), k, n_live=nl
    )
    assert torch.equal(m2, m) and torch.equal(e2, e)
    if case == "eps=+inf" or case == "n_live=0":
        assert int(e.sum()) == 0
    if case == "n_live<G":
        assert int(e[13:].sum()) == 0


@pytest.mark.parametrize("k", [1, 3, 10, 40])
@pytest.mark.parametrize("B", [4, 33])
def test_group_topk_rows_matches_jax(B, k):
    rng = np.random.default_rng(B + k)
    G = 11
    g = rng.integers(-2, 3, size=(G, B)).astype(np.float32)
    g[0, 0], g[1, 0], g[2, -1] = -np.inf, -0.0, np.inf  # -inf, signed zero
    valid = (rng.uniform(size=(G, B)) < 0.6).astype(np.int32)
    valid[3] = 0
    rows = rng.integers(0, 1000, size=(G, B)).astype(np.int32)
    want = np.asarray(
        jde.group_topk_rows(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(rows), k)
    )
    got = group_topk_rows(
        torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(rows).long(), k
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k_of", ["1", "3", "B+3"])
@pytest.mark.parametrize("B", [1, 2, 4, 31, 32, 33, 64])
def test_group_topk_rows_nan_groups_match_jax(B, k_of):
    """A valid NaN (or -NaN) in a group makes every one of the reference's
    segment-max passes NaN, so it consumes no lane and picks nothing: the
    port gives such a group all -1 too.  Beside those groups: -inf on
    valid lanes, -0.0 / +0.0 ties, integer ties, a NaN on an invalid lane
    only (masked) and an empty group."""
    k = {"1": 1, "3": 3, "B+3": B + 3}[k_of]
    rng = np.random.default_rng(100 * B + k)
    G = 12
    g = rng.integers(-2, 3, size=(G, B)).astype(np.float32)
    g[G // 2 :] += rng.normal(scale=0.3, size=(G - G // 2, B)).astype(np.float32)
    valid = (rng.uniform(size=(G, B)) < 0.75).astype(np.int32)
    valid[:6, 0] = 1
    g[1] = np.where(rng.uniform(size=B) < 0.5, -0.0, 0.0).astype(np.float32)
    g[2, ::2] = -np.inf
    g[3, rng.integers(B)] = np.nan
    valid[3] = 1
    g[4, 0] = -np.float32(np.nan)
    g[5, 0], valid[5, 0] = np.nan, 0
    valid[6] = 0
    rows = rng.integers(0, 10_000, size=(G, B)).astype(np.int64)
    want = np.asarray(
        jde.group_topk_rows(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(rows), k)
    )
    got = group_topk_rows(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(rows), k)
    assert got.dtype == torch.int32 and got.shape == (G, k)
    assert (want[3] == -1).all() and (want[4] == -1).all()
    assert np.array_equal(got.numpy(), want)


def _run_all_buckets(ex, F, sizes, gp, eps_g=None, cap=None):
    ordered = np.ascontiguousarray(F.astype(np.float32)[:, gp.plan.order])
    off = bucketing.group_offsets(sizes)
    packs = bucketing.pack_by_bucket(sizes, gp.buckets)
    cap = cap or max(len(g) for g in packs.values())
    eps = gp.eps_g if eps_g is None else eps_g
    return {
        b: (gidx, ex.run_grouped(
            ordered, *bucketing.bucket_layout(sizes[gidx], b, offsets=off[gidx]),
            len(gidx), eps, gp.k, capacity_groups=cap,
        ))
        for b, gidx in sorted(packs.items())
    }


@pytest.mark.parametrize("fixture", ["bench", "singletons,k>=size", "block straddle"])
def test_run_grouped_matches_jax(bench, fixture):
    if fixture == "bench":
        F, sizes, _, jgp, gp = bench
        block_n = BLOCK_N
    else:
        if fixture == "singletons,k>=size":
            F, sizes = _ragged(3, G=19, lo=1, hi=6)
            k, block_n = 5, 64
        else:  # groups straddling the billing block's boundary
            F, sizes = _ragged(4, G=17, lo=20, hi=40)
            k, block_n = 3, 16
        jgp = j_fit_grouped(F, sizes, k, alpha=0.1, chunk_t=6)
        gp = _port_plan(jgp)
    ex, jex = _executors(gp, jgp, block_n)
    host = run_grouped_host(gp, F, sizes)
    full = full_cascade_topk(F, sizes, gp.k, order=gp.plan.order)
    inf = np.full(gp.S, MARGIN_INF, np.float32)
    for eps in (None, inf):
        runs = _run_all_buckets(ex, F, sizes, gp, eps)
        jruns = _run_all_buckets(jex, F, sizes, jgp, eps)
        for b, (gidx, r) in runs.items():
            jr = jruns[b][1]
            assert np.array_equal(r.verdicts, jr.verdicts)
            assert np.array_equal(r.exit_stage, jr.exit_stage)
            assert np.array_equal(_bits(r.margin), _bits(jr.margin))
            assert [vars(c) for c in r.chunk_stats] == [vars(c) for c in jr.chunk_stats]
            assert (r.scores_computed, r.scores_possible) == (
                jr.scores_computed, jr.scores_possible,
            )
            if eps is None:
                assert np.array_equal(r.verdicts, host.verdicts[gidx])
                assert np.array_equal(r.exit_stage, host.exit_stage[gidx])
                assert np.array_equal(_bits(r.margin), _bits(host.margin[gidx]))
            else:
                assert np.array_equal(r.verdicts, full[gidx])


def test_run_grouped_edges(bench):
    F, sizes, _, _, gp = bench
    dplan = DevicePlan.from_plan(gp.plan)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=8, device="cpu")
    empty = ex.run_grouped(np.zeros((0, gp.T), np.float32), np.zeros((0, 4)), np.zeros((0, 4)), 0, gp.eps_g, 3)
    assert empty.verdicts.shape == (0, 3) and empty.scores_computed == 0
    with pytest.raises(ValueError, match="matching"):
        ex.run_grouped(F, np.zeros((2, 4)), np.zeros((2, 5)), 2, gp.eps_g, 3)
    with pytest.raises(ValueError, match="eps_g"):
        ex.run_grouped(F, np.zeros((2, 4)), np.ones((2, 4)), 2, gp.eps_g[:-1], 3)
    # a pinned capacity changes no result
    a = _run_all_buckets(ex, F, sizes, gp)
    b = _run_all_buckets(ex, F, sizes, gp, cap=100)
    for w in a:
        assert np.array_equal(a[w][1].verdicts, b[w][1].verdicts)
        assert a[w][1].scores_computed == b[w][1].scores_computed


def test_billing_matches_baseline_billing_json():
    """The perf gate's grouped fixture (seed 2032, ``benchmarks/perf_gate.py``)
    bills what ``baseline_billing.json`` holds, key by key."""
    path = ROOT / "benchmarks" / "results" / "baseline_billing.json"
    base = json.loads(path.read_text())["counters"]
    rng = np.random.default_rng(2032)
    Gq, Tq = 24, 24
    sizes = rng.integers(1, 17, size=Gq).astype(np.int64)
    Nq = int(sizes.sum())
    qual = rng.exponential(1.0, size=Nq)
    F = rng.normal(size=(Nq, Tq)) * 0.1 + qual[:, None]
    gp = fit_grouped(F, sizes, 3, alpha=0.05, chunk_t=6)
    host = run_grouped_host(gp, F, sizes)
    got = {
        "ranking.host.scores": int(host.scores_computed),
        "ranking.host.stages": len(host.chunk_stats),
    }
    dplan = DevicePlan.from_plan(gp.plan)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=32, device="cpu")
    paid = stages = 0
    for _, (gidx, r) in _run_all_buckets(ex, F, sizes, gp).items():
        assert np.array_equal(r.verdicts, host.verdicts[gidx])
        assert np.array_equal(r.exit_stage, host.exit_stage[gidx])
        paid += r.scores_computed
        stages += len(r.chunk_stats)
    got["ranking.device.scores"], got["ranking.device.stages"] = paid, stages
    assert got == {key: base[key] for key in got}


# -- server, api, CLI ----------------------------------------------------


def _submit_all(server, F, sizes):
    off = bucketing.group_offsets(sizes)
    for i in range(sizes.size):
        server.submit(F[off[i] : off[i + 1]])
    return server.drain()


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("margin_inf", [False, True])
def test_grouped_rank_server_matches_jax(bench, backend, margin_inf):
    F, sizes, _, jgp, gp = bench
    ex, jex = _executors(gp, jgp, BLOCK_N) if backend == "device" else (None, None)
    kw = dict(batch_groups=40, capacity_groups=48, margin_inf=margin_inf)
    srv = GroupedRankServer(gp, executor=ex, device="cpu", **kw)
    jsrv = JServer(jgp, executor=jex, **kw)
    got, want = _submit_all(srv, F, sizes), _submit_all(jsrv, F, sizes)
    assert [r["ranking"] for r in got] == [r["ranking"] for r in want]
    assert [r["exit_stage"] for r in got] == [r["exit_stage"] for r in want]
    assert _bits([r["margin"] for r in got]).tolist() == _bits([r["margin"] for r in want]).tolist()
    assert vars(srv.stats) == vars(jsrv.stats)
    assert srv.stats.n_waves > 2  # two flushes, several buckets each
    srv.flush()  # empty queue: nothing runs
    assert vars(srv.stats) == vars(jsrv.stats)


def test_grouped_rank_server_scores_with_score_fn(bench):
    """``score_fn`` gets the flush's documents as one tensor on the
    executor's device; the verdicts equal a run on the score matrices."""
    F, sizes, _, jgp, gp = bench
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.normal(size=(6, gp.T)).astype(np.float32))
    X = rng.normal(size=(F.shape[0], 6)).astype(np.float32)
    Fx = (torch.from_numpy(X) @ W).numpy()
    ex, _ = _executors(gp, jgp, BLOCK_N)
    seen = []

    def score_fn(x):
        seen.append((x.device.type, x.dtype, tuple(x.shape)))
        return x @ W

    a = _submit_all(GroupedRankServer(gp, score_fn, executor=ex, batch_groups=64), X, sizes)
    assert seen == [("cpu", torch.float32, (F.shape[0], 6))]
    b = _submit_all(GroupedRankServer(gp, executor=ex, batch_groups=64), Fx, sizes)
    assert a == b
    host = _submit_all(GroupedRankServer(gp, score_fn, device="cpu", batch_groups=64), X, sizes)
    assert [r["ranking"] for r in host] == [r["ranking"] for r in a]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_api_rank_matches_jax(bench, backend):
    F, sizes, rel, _, _ = bench
    kw = dict(groups=sizes, topk=K, alpha=0.05, chunk_t=CHUNK_T)
    jc = japi.fit(F, **kw).compile(backend)
    c = api.fit(F, **kw).compile(backend, device="cpu")
    assert c.backend_name == backend
    for margin_inf in (False, True):
        got = c.rank(scores=F, groups=sizes, margin_inf=margin_inf)
        want = jc.rank(scores=F, groups=sizes, margin_inf=margin_inf)
        assert [r["ranking"] for r in got] == [r["ranking"] for r in want]
        assert [r["exit_stage"] for r in got] == [r["exit_stage"] for r in want]
        assert [_bits(r["margin"]).item() for r in got] == [_bits(r["margin"]).item() for r in want]
        assert vars(c.last_rank_stats) == vars(jc.last_rank_stats)
    # the grouped serve() is a GroupedRankServer on the same backend
    srv = c.serve(batch_size=64)
    assert isinstance(srv, GroupedRankServer) and (srv.executor is None) == (backend == "host")
    assert [r["ranking"] for r in _submit_all(srv, F, sizes)] == [
        r["ranking"] for r in c.rank(scores=F, groups=sizes)
    ]


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_api_row_level_evaluate_matches_evaluate_cascade(mode):
    rng = np.random.default_rng(11)
    F = rng.normal(size=(300, 30)) * 0.7 + rng.normal(size=(300, 1)) * 0.4
    Ft = rng.normal(size=(120, 30)) * 0.7 + rng.normal(size=(120, 1)) * 0.4
    jf = japi.fit(F, alpha=0.02, mode=mode)
    f = api.fit(F, alpha=0.02, mode=mode)
    assert np.array_equal(f.model.order, jf.model.order)
    ev = j_evaluate_cascade(jf.model, Ft)
    jhost = jf.compile("host").evaluate(scores=Ft)
    for backend, kw in (("device", {}), ("auto", {}), ("host", {}), ("host", {"decide": "kernel"})):
        res = f.compile(backend, device="cpu", **kw).evaluate(scores=Ft)
        assert np.array_equal(res.decisions, ev["decisions"])
        assert np.array_equal(res.exit_step, ev["exit_step"])
        tres = f.compile(backend, device="cpu", **kw).evaluate(scores=torch.from_numpy(Ft))
        assert np.array_equal(tres.decisions, res.decisions)
        assert np.array_equal(tres.exit_step, res.exit_step)
        if backend == "host" and not kw:
            assert [vars(c) for c in res.chunk_stats] == [vars(c) for c in jhost.chunk_stats]
            assert res.scores_computed == jhost.scores_computed


def test_api_row_level_serve_builds_the_servers():
    """``compile().serve()`` of a row-level fit is the ``QWYCServer`` (or,
    with ``streaming=True``, the ``StreamingServer``) on the compiled
    backend and device: the same results as those servers built directly."""
    from repro_torch.serving.engine import QWYCServer, StreamingServer

    rng = np.random.default_rng(12)
    F = rng.normal(size=(200, 20)) * 0.7 + rng.normal(size=(200, 1)) * 0.4
    X = F.astype(np.float32)

    def score_fn(x):
        return x

    c = api.fit(F, alpha=0.02).compile("device", device="cpu")
    model = c.fitted.model
    for streaming, cls, kw in (
        (False, QWYCServer, {}),
        (True, StreamingServer, {"window": 128}),
    ):
        srv = c.serve(score_fn=score_fn, batch_size=64, streaming=streaming, **kw)
        ref = cls(model, score_fn=score_fn, batch_size=64, exec_backend="device",
                  device="cpu", **kw)
        assert type(srv) is cls and srv.exec.name == "device"
        for a, b in ((srv, X), (ref, X)):
            for row in b:
                a.submit(row)
        assert srv.drain() == ref.drain()
        assert srv.stats.scores_computed == ref.stats.scores_computed
    with pytest.raises(ValueError, match="streaming admission"):
        api.fit(F).compile("host", device="cpu").serve(score_fn=score_fn, streaming=True)
    with pytest.raises(ValueError, match="window/max_wait"):
        c.serve(score_fn=score_fn, window=8)


def test_api_fit_with_a_score_function_and_rank_x(bench):
    F, sizes, _, _, gp = bench
    rng = np.random.default_rng(9)
    W = torch.from_numpy(rng.normal(size=(5, gp.T)).astype(np.float32))
    X = rng.normal(size=(F.shape[0], 5)).astype(np.float32)

    def score_fn(x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        return x @ W

    Fx = score_fn(torch.from_numpy(X))
    fitted = api.fit(score_fn, X, groups=sizes, topk=3, alpha=0.05, chunk_t=6, device="cpu")
    same = api.fit(Fx, groups=sizes, topk=3, alpha=0.05, chunk_t=6)
    assert np.array_equal(fitted.grouped.plan.order, same.grouped.plan.order)
    assert np.array_equal(_bits(fitted.grouped.eps_g), _bits(same.grouped.eps_g))
    c = fitted.compile("device", device="cpu")
    assert c.rank(x=X, groups=sizes) == c.rank(scores=Fx, groups=sizes)
    # a score tensor goes to the device loop as it is, a matrix is the same
    assert c.rank(scores=Fx, groups=sizes) == c.rank(scores=Fx.numpy(), groups=sizes)
    host = fitted.compile("host", device="cpu").rank(scores=Fx, groups=sizes)
    assert [r["ranking"] for r in host] == [r["ranking"] for r in c.rank(x=X, groups=sizes)]


def test_api_unported_and_invalid_options_raise(bench):
    F, sizes, *_ = bench
    fitted = api.fit(F, groups=sizes, topk=K, alpha=0.05, chunk_t=CHUNK_T)
    for kw in ({"mesh": object()}, {"shards": 2}, {"model_shards": 2}, {"rebalance": True}):
        with pytest.raises(ValueError, match="ROADMAP A15"):
            fitted.compile("device", device="cpu", **kw)
    # the degradation ladder is ported: backoff / sleep tune it
    from repro_torch.api.backends import BackoffPolicy

    laddered = fitted.compile("device", device="cpu", backoff=BackoffPolicy(retries=1),
                              sleep=lambda s: None)
    assert laddered.backend_name == "device" and laddered.degradation_events == []
    from repro_torch.api.scorers import MatrixScorer

    # a model-backed fit, as the reference's: the matrix scorer cannot score
    # its calibration inputs, and a scorer with no inputs has nothing to score
    with pytest.raises(NotImplementedError, match="cannot score calibration inputs itself"):
        api.fit(MatrixScorer(), F)
    with pytest.raises(ValueError, match="needs calibration inputs X"):
        api.fit(MatrixScorer())
    with pytest.raises(ValueError, match="topk= requires groups="):
        api.fit(F, topk=3)
    with pytest.raises(ValueError, match="host-backend option"):
        fitted.compile("device", device="cpu", decide="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        fitted.compile("sharded", device="cpu")
    with pytest.raises(ValueError, match="stage layout"):
        fitted.compile("device", device="cpu", chunk_t=CHUNK_T + 1).rank(scores=F, groups=sizes)
    with pytest.raises(ValueError, match="no grouped plan"):
        api.fit(F, alpha=0.05).compile("host", device="cpu").rank(scores=F, groups=sizes)
    with pytest.raises(ValueError, match="group sizes sum"):
        fitted.compile("host", device="cpu").rank(scores=F, groups=sizes[:-1])
    # grouped streaming needs the device backend's admission ring
    with pytest.raises(ValueError, match="on-device backend"):
        fitted.compile("host", device="cpu").serve(streaming=True)
    with pytest.raises(ValueError, match="unknown admission policy"):
        fitted.compile("device", device="cpu").serve(streaming=True, policy="kernel")


@pytest.mark.parametrize("backend", ["auto", "host"])
def test_cli_ranking_matches_jax(capsys, backend):
    T, args = 60, ["--device", "cpu", "--groups", "8", "--topk", "5", "--T", "60",
                   "--scale", "0.1", "--alpha", "0.05"]
    serve.main(args + ["--backend", backend])
    out = capsys.readouterr().out
    # the CLI's setup, its GBT score matrices, through the JAX package
    ds = make_dataset("adult", scale=0.1)
    g = train_gbt(ds.x_train, ds.y_train, n_trees=T, depth=5, device="cpu")
    params = g.stacked()
    F_tr, F_te = (
        apply_gbt_scores(params, torch.from_numpy(x)).numpy().astype(np.float64)
        for x in (ds.x_train, ds.x_test)
    )
    rng = np.random.default_rng(serve.GROUPS_SEED)
    sizes_tr = serve._ragged_sizes(len(ds.y_train), 8, rng)
    sizes_te = serve._ragged_sizes(len(ds.y_test), 8, rng)
    jc = japi.fit(
        F_tr, groups=sizes_tr, topk=5, alpha=0.05, beta=-g.base_score, chunk_t=8
    ).compile("host" if backend == "host" else "device")
    res = jc.rank(scores=F_te, groups=sizes_te)
    st = jc.last_rank_stats
    off = bucketing.group_offsets(sizes_te)
    verd = np.full((sizes_te.size, 5), -1, dtype=np.int64)
    for i, r in enumerate(res):
        verd[i, : len(r["ranking"])] = np.asarray(r["ranking"]) + off[i]
    ndcg = j_ndcg_at_k(ds.y_test, verd, sizes_te, 5)
    assert f"mean exit stage {st.mean_exit_stage:.2f}/8" in out
    assert f"scores computed {st.scores_computed}/{st.scores_possible}" in out
    assert f"NDCG@5 {ndcg:.4f}" in out
    want = "device" if backend == "auto" else "host"
    assert f"{sizes_te.size} queries / 200 docs" in out and f"({want} backend, batch)" in out


# -- the compiled-program contract: one grouped program per bucket shape -----


def test_grouped_traces_one_per_bucket_like_jax(bench):
    """The reference's ``test_ranking.py:268``: a pass over the buckets at
    the fitted thresholds and a second at +inf (eps is an input, not part of
    the key) give one trace per bucket shape, in both packages; a new
    group capacity is a new program for every bucket."""
    F, sizes, _, jgp, gp = bench
    ex, jex = _executors(gp, jgp, BLOCK_N)
    inf = np.full(gp.S, np.inf, dtype=np.float32)
    for eps in (None, inf):
        got = _run_all_buckets(ex, F, sizes, gp, eps_g=eps)
        want = _run_all_buckets(jex, F, sizes, jgp, eps_g=eps)
        for b in got:
            np.testing.assert_array_equal(got[b][1].verdicts, np.asarray(want[b][1].verdicts))
            np.testing.assert_array_equal(got[b][1].exit_stage, want[b][1].exit_stage)
    n_buckets = len(got)
    assert n_buckets > 1
    assert ex.traces == jex.traces == n_buckets
    _run_all_buckets(ex, F, sizes, gp, cap=100)
    _run_all_buckets(jex, F, sizes, jgp, cap=100)
    assert ex.traces == jex.traces == 2 * n_buckets


@pytest.mark.parametrize("capacity_docs", [None, 4096])
def test_grouped_server_flushes_share_programs(bench, capacity_docs):
    """The flushes of a ranking server hold different document counts, yet
    share one program per bucket shape: the port pads the operand to the
    server's ``capacity_docs`` rows (unpinned: the flush's rows rounded up
    to a power of two), where the reference keys on each flush's own
    operand shape.  Verdicts, exit stages, margins' bits and billing equal
    the JAX server's."""
    F, sizes, _, jgp, gp = bench
    ex, jex = _executors(gp, jgp, BLOCK_N)
    kw = dict(batch_groups=16, capacity_groups=16)
    srv = GroupedRankServer(gp, executor=ex, device="cpu", capacity_docs=capacity_docs, **kw)
    jsrv = JServer(jgp, executor=jex, **kw)
    got, want = _submit_all(srv, F, sizes), _submit_all(jsrv, F, sizes)
    assert [r["ranking"] for r in got] == [r["ranking"] for r in want]
    assert [r["exit_stage"] for r in got] == [r["exit_stage"] for r in want]
    assert _bits([r["margin"] for r in got]).tolist() == _bits([r["margin"] for r in want]).tolist()
    assert vars(srv.stats) == vars(jsrv.stats)
    keys, flush_docs = set(), set()
    for f0 in range(0, sizes.size, kw["batch_groups"]):
        fs = sizes[f0 : f0 + kw["batch_groups"]]
        flush_docs.add(int(fs.sum()))
        cap_x = 1 << (max(int(fs.sum()), capacity_docs or 0) - 1).bit_length()
        keys |= {(b, cap_x) for b in bucketing.pack_by_bucket(fs, gp.buckets)}
    assert len(flush_docs) > 1  # the flushes' operands differ in rows
    assert ex.traces == len(keys) < srv.stats.n_waves
    assert ex.traces < jex.traces
