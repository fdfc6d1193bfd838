"""Grouped streaming (the grouped admission ring) of the PyTorch port
against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Every comparison is exact (tolerance 0): ``DeviceExecutor.run_stream_grouped``
(``device="cpu"``, the matrix scorer, B8's plain version) against JAX's
``DeviceExecutor(..., megakernel=False).run_stream_grouped`` (its B8 in
interpret mode) on ragged groups: verdicts, exit stages, margins by their
bits, the admit / done timeline, ``steps_run``, occupancy, the bill and
``traces``, under no arrivals, staggered and bursty ones, a slot capacity
below the group count (slots refill mid-cascade), a ring above it, k of 1,
3 and above the bucket width, fitted thresholds, ``MARGIN_INF`` (equal to
``full_cascade_topk``), a group holding a NaN document and no group at
all.  Then the port's stream against its own batch ``run_grouped``;
``AdmissionQueue`` against JAX's on seeded push / pop sequences; the
streaming ``GroupedRankServer`` (its waves, rankings, exit stages, margins
and ``RankStats``) and ``compile().serve(streaming=True, policy=)``
against JAX's; and ``serve --groups --streaming`` against the same API
call.
"""

import re

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import device_executor as jde
from repro.ranking import GroupedRankServer as JServer
from repro.ranking import bucketing as jb
from repro.ranking import fit_grouped as j_fit_grouped
from repro.ranking import full_cascade_topk as j_full_cascade_topk
from repro_torch import api
from repro_torch.convert import grouped_plan_from_numpy, qwyc_model_from_numpy
from repro_torch.data.synthetic import make_dataset
from repro_torch.ensembles.gbt import train_gbt
from repro_torch.kernels import ops
from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, matrix_stage_scorer
from repro_torch.launch import serve
from repro_torch.ranking import (
    MARGIN_INF,
    AdmissionQueue,
    GroupedRankServer,
    bucket_layout,
    group_offsets,
    pack_by_bucket,
)

K, CHUNK_T, BLOCK_N = 3, 6, 16
TIMELINE = ("admit_step", "done_step", "occupancy")


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _ragged(seed, G=64, T=24, lo=1, hi=20):
    """Ragged groups with heavy-tailed latent quality (singletons and
    sub-k groups included), so the margin criterion fires; the reference
    test suite's ``_ragged_fixture`` at more groups, so every bucket holds
    more groups than one block of slots."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=G).astype(np.int64)
    quality = rng.exponential(1.0, size=int(sizes.sum()))
    F = rng.normal(size=(int(sizes.sum()), T)) * 0.15 + quality[:, None]
    return F, sizes


def _port_plan(jgp):
    m = jgp.model
    model = qwyc_model_from_numpy(
        m.order, m.eps_pos, m.eps_neg, m.beta, m.costs, m.alpha, m.mode
    )
    return grouped_plan_from_numpy(
        model, jgp.eps_g, jgp.k, jgp.buckets, jgp.plan.chunk_t,
        train_exit_stage=jgp.train_exit_stage, train_disagreement=jgp.train_disagreement,
    )


def _executors(gp, jgp, block_n=BLOCK_N):
    dplan = DevicePlan.from_plan(gp.plan)
    ex = DeviceExecutor(
        dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=block_n, device="cpu"
    )
    jdplan = jde.DevicePlan.from_plan(jgp.plan)
    jex = jde.DeviceExecutor(
        jdplan, scorer=jde.matrix_stage_scorer(jdplan), block_n=block_n, megakernel=False
    )
    return ex, jex


@pytest.fixture(scope="module")
def fx():
    """The ragged fixture fitted by both packages, one executor pair kept
    for the whole module (JAX compiles a program per key once)."""
    F, sizes = _ragged(seed=11)
    jgp = j_fit_grouped(F, sizes, K, alpha=0.05, chunk_t=CHUNK_T)
    gp = _port_plan(jgp)
    ex, jex = _executors(gp, jgp)
    Fo = np.ascontiguousarray(F.astype(np.float32)[:, gp.plan.order])
    return dict(F=F, Fo=Fo, sizes=sizes, gp=gp, jgp=jgp, ex=ex, jex=jex)


def _arrivals(kind: str, n: int):
    if kind == "none":
        return None
    if kind == "staggered":
        return (np.arange(n) // 3).astype(np.int32)
    # bursts with gaps longer than the cascade: the ring idles, empty,
    # between them
    rng = np.random.default_rng(n)
    return np.sort(rng.choice(np.array([0, 1, 9, 30]), size=n)).astype(np.int32)


def _assert_same(got, want, where=""):
    np.testing.assert_array_equal(got.verdicts, np.asarray(want.verdicts), err_msg=where)
    np.testing.assert_array_equal(got.exit_stage, np.asarray(want.exit_stage), err_msg=where)
    m_got, m_want = np.asarray(got.margin), np.asarray(want.margin)
    nan = np.isnan(m_want)
    np.testing.assert_array_equal(np.isnan(m_got), nan, err_msg=where)
    # a NaN margin's sign is the reference's to leave open (ROADMAP C8)
    np.testing.assert_array_equal(_bits(m_got)[~nan], _bits(m_want)[~nan], err_msg=where)
    for f in TIMELINE:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f"{where} {f}")
    for f in ("steps_run", "capacity_groups", "scores_computed", "scores_possible"):
        assert getattr(got, f) == getattr(want, f), f"{where} {f}"


def _buckets(fx):
    sizes, gp = fx["sizes"], fx["gp"]
    off = group_offsets(sizes)
    for b, gidx in sorted(pack_by_bucket(sizes, gp.buckets).items()):
        rows, valid = bucket_layout(sizes[gidx], b, offsets=off[gidx])
        yield b, gidx, rows, valid


@pytest.mark.parametrize("cap", ["all", "refill", "ring"])
@pytest.mark.parametrize("arrivals", ["none", "staggered", "bursty"])
def test_run_stream_grouped_matches_jax(fx, arrivals, cap):
    """Every bucket of the fixture through both admission rings: at every
    slot (``all``), at 8 slots for up to 20 groups (``refill``: slots free
    and refill mid-cascade), and with a ring wider than the bucket's group
    count (``ring``).  Equal timelines, bills and trace counts."""
    ex, jex, gp = fx["ex"], fx["jex"], fx["gp"]
    refilled = 0
    for b, gidx, rows, valid in _buckets(fx):
        n = len(gidx)
        kw = dict(arrivals=_arrivals(arrivals, n))
        if cap == "refill":
            kw["capacity_groups"] = 8
        elif cap == "ring":
            kw["ring_capacity"] = n + 5
        got = ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K, **kw)
        want = jex.run_stream_grouped(fx["Fo"], rows, valid, n, fx["jgp"].eps_g, K, **kw)
        _assert_same(got, want, f"bucket {b}")
        assert got.syncs >= 2 and got.steps_enqueued >= got.steps_run
        refilled += int(got.occupancy.max() == got.capacity_groups < n)
    assert ex.traces == jex.traces
    if cap == "refill" and arrivals == "none":
        # every bucket holds more than 8 groups: they all wait for slots
        assert refilled == len(pack_by_bucket(fx["sizes"], gp.buckets))


@pytest.mark.parametrize("k", [1, 3, 33])
@pytest.mark.parametrize("eps", ["fitted", "margin_inf"])
def test_run_stream_grouped_k_and_thresholds_match_jax(fx, k, eps):
    """k of 1, the fitted 3 and 33 (above every bucket width, so every pick
    past a group's size is -1); the fitted thresholds and ``MARGIN_INF``,
    at which no group exits and the verdicts are ``full_cascade_topk``'s.
    Fresh executors: one program per bucket in both packages."""
    gp, jgp = fx["gp"], fx["jgp"]
    ex, jex = _executors(gp, jgp)
    eps_g = gp.eps_g if eps == "fitted" else np.full(gp.S, MARGIN_INF, dtype=np.float32)
    verd = np.full((fx["sizes"].size, k), -2, dtype=np.int64)
    for b, gidx, rows, valid in _buckets(fx):
        n = len(gidx)
        kw = dict(arrivals=_arrivals("staggered", n), capacity_groups=8)
        got = ex.run_stream_grouped(fx["Fo"], rows, valid, n, eps_g, k, **kw)
        want = jex.run_stream_grouped(fx["Fo"], rows, valid, n, eps_g, k, **kw)
        _assert_same(got, want, f"bucket {b}")
        verd[gidx] = got.verdicts
        if eps == "margin_inf":
            assert (got.exit_stage == gp.S).all()
    assert ex.traces == jex.traces == len(pack_by_bucket(fx["sizes"], gp.buckets))
    if eps == "margin_inf":
        full = j_full_cascade_topk(fx["F"], fx["sizes"], k, order=gp.plan.order)
        np.testing.assert_array_equal(verd, full)


def test_run_stream_grouped_nan_document_matches_jax(fx):
    """A group of more than k documents holding a NaN one never exits (its
    margin is NaN) and picks nothing, in both packages; the other groups
    are untouched."""
    gp, jgp = fx["gp"], fx["jgp"]
    ex, jex = _executors(gp, jgp)
    Fo = fx["Fo"].copy()
    hit = 0
    for b, gidx, rows, valid in _buckets(fx):
        n = len(gidx)
        j = int(np.argmax(valid.sum(axis=1)))  # the bucket's largest group
        Fo[rows[j, 0], 3] = np.nan
        kw = dict(arrivals=_arrivals("staggered", n), capacity_groups=8)
        got = ex.run_stream_grouped(Fo, rows, valid, n, gp.eps_g, K, **kw)
        want = jex.run_stream_grouped(Fo, rows, valid, n, jgp.eps_g, K, **kw)
        _assert_same(got, want, f"bucket {b}")
        assert (got.verdicts[j] == -1).all()
        if valid[j].sum() > K:
            assert np.isnan(got.margin[j]) and got.exit_stage[j] == gp.S
            hit += 1
    assert hit >= 3


def test_run_stream_grouped_no_groups_matches_jax(fx):
    gp, jgp = fx["gp"], fx["jgp"]
    ex, jex = _executors(gp, jgp)
    rows = np.zeros((0, 8), dtype=np.int32)
    valid = np.zeros((0, 8), dtype=bool)
    got = ex.run_stream_grouped(fx["Fo"], rows, valid, 0, gp.eps_g, K, capacity_groups=20)
    want = jex.run_stream_grouped(fx["Fo"], rows, valid, 0, jgp.eps_g, K, capacity_groups=20)
    _assert_same(got, want)
    assert got.verdicts.shape == (0, K) and ex.traces == jex.traces == 0


def test_run_stream_grouped_equals_batch_run_grouped(fx):
    """The port's stream against its own batch path: verdicts, exit stages
    and margins' bits equal bucket by bucket (the same B8 decisions at the
    same stages, whatever the admission order), and each group's latency
    in steps is its exit stage."""
    ex, gp = fx["ex"], fx["gp"]
    for b, gidx, rows, valid in _buckets(fx):
        n = len(gidx)
        got = ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K,
                                    arrivals=_arrivals("bursty", n), capacity_groups=8)
        batch = ex.run_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K)
        np.testing.assert_array_equal(got.verdicts, batch.verdicts)
        np.testing.assert_array_equal(got.exit_stage, batch.exit_stage)
        np.testing.assert_array_equal(_bits(got.margin), _bits(batch.margin))
        lat = got.done_step - got.admit_step + 1
        np.testing.assert_array_equal(lat, batch.exit_stage)


def test_run_stream_grouped_rejects_bad_inputs(fx):
    ex, gp = fx["ex"], fx["gp"]
    b, gidx, rows, valid = next(_buckets(fx))
    n = len(gidx)
    with pytest.raises(ValueError, match="nondecreasing"):
        ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K,
                              arrivals=np.arange(n)[::-1])
    with pytest.raises(ValueError, match="arrivals has shape"):
        ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K, arrivals=[0])
    with pytest.raises(ValueError, match="k must be >= 1"):
        ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, 0)
    with pytest.raises(ValueError, match="eps_g has shape"):
        ex.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g[:-1], K)
    dplan = DevicePlan.from_plan(gp.plan)
    base = matrix_stage_scorer(dplan, device="cpu")
    import dataclasses

    no_lanes = DeviceExecutor(dplan, dataclasses.replace(base, lane_fn=None), device="cpu")
    with pytest.raises(ValueError, match="lane_fn"):
        no_lanes.run_stream_grouped(fx["Fo"], rows, valid, n, gp.eps_g, K)


# -- the admission queue ------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["skip-ahead", "wait"])
def test_admission_queue_matches_jax(policy, seed):
    """Seeded interleavings of pushes and pops at random widths: every
    pop, the pending list and the length equal JAX's ``AdmissionQueue``."""
    rng = np.random.default_rng(seed)
    q, jq = AdmissionQueue(policy), jb.AdmissionQueue(policy)
    gid = 0
    for _ in range(200):
        if rng.random() < 0.55:
            size = int(rng.integers(1, 40))
            q.push(gid, size)
            jq.push(gid, size)
            gid += 1
        else:
            width = int(rng.choice([4, 8, 16, 32]))
            assert q.pop_for(width) == jq.pop_for(width)
        assert q.pending == jq.pending and len(q) == len(jq)


def test_admission_queue_errors_match_jax():
    for cls in (AdmissionQueue, jb.AdmissionQueue):
        with pytest.raises(ValueError, match="unknown admission policy"):
            cls("fifo")
        with pytest.raises(ValueError, match="group size must be >= 1"):
            cls().push(0, 0)
        assert cls("wait").pop_for(8) is None


# -- the streaming server -------------------------------------------------------


@pytest.mark.parametrize("policy", ["skip-ahead", "wait"])
@pytest.mark.parametrize("sizes", [[3, 16, 2], [5, 1, 30, 2, 9, 17, 4, 4, 33, 1], "fixture"])
def test_server_waves_match_jax(fx, policy, sizes):
    sizes = fx["sizes"] if isinstance(sizes, str) else np.asarray(sizes)
    gp, jgp = fx["gp"], fx["jgp"]
    got = GroupedRankServer(gp, policy=policy, device="cpu")._waves(sizes)
    want = JServer(jgp, policy=policy)._waves(sizes)
    assert [(b, g.tolist()) for b, g in got] == [(b, g.tolist()) for b, g in want]


def _stream_serve(server, F, sizes, arrivals):
    off = group_offsets(sizes)
    for i in range(sizes.size):
        server.submit(F[off[i] : off[i + 1]], arrival=float(arrivals[i]))
    return server.drain()


def _same_results(got, want):
    assert len(got) == len(want)
    assert [r["ranking"] for r in got] == [r["ranking"] for r in want]
    assert [r["exit_stage"] for r in got] == [r["exit_stage"] for r in want]
    assert _bits([r["margin"] for r in got]).tolist() == \
        _bits([r["margin"] for r in want]).tolist()


@pytest.mark.parametrize("policy,batch", [("skip-ahead", 16), ("skip-ahead", 64),
                                          ("wait", 64)])
def test_streaming_server_matches_jax(fx, policy, batch):
    """Poisson arrivals (seed 2028, 4 queries a step) through the streaming
    servers of both packages, in flushes of ``batch`` queries: every
    query's ranking, exit stage and margin bits, and ``RankStats``, equal.
    Each wave's timeline is the executor's, held above."""
    gp, jgp, F, sizes = fx["gp"], fx["jgp"], fx["F"], fx["sizes"]
    ex, jex = _executors(gp, jgp)
    arr = np.cumsum(np.random.default_rng(2028).exponential(1 / 4.0, size=sizes.size))
    kw = dict(batch_groups=batch, capacity_groups=8, streaming=True, policy=policy)
    srv = GroupedRankServer(gp, executor=ex, **kw)
    jsrv = JServer(jgp, executor=jex, **kw)
    got, want = _stream_serve(srv, F, sizes, arr), _stream_serve(jsrv, F, sizes, arr)
    _same_results(got, want)
    assert vars(srv.stats) == vars(jsrv.stats)
    assert len(srv.stream_results) == srv.stats.n_waves
    # a wave's ring is pinned to the slot capacity: waves of one bucket
    # width share a program, where the reference keys on each wave's count
    assert ex.traces <= jex.traces


@pytest.mark.parametrize("policy", ["skip-ahead", "wait"])
def test_streaming_server_traces_two_waves_one_width(fx, policy):
    """ROADMAP C10: waves of one bucket width with different group counts.
    Within one flush the waves' widths strictly increase (a wave takes
    every queued group its width holds), so the server's flush threshold
    cuts the queries into two flushes of one wave each: 3 and 2 groups,
    all of width 4.  Verdicts, margins and the bill equal the reference's;
    the port's ring is pinned to the slot capacity, so both waves share one
    program, where the reference keys its ring on each wave's count."""
    gp, jgp, F, sizes = fx["gp"], fx["jgp"], fx["F"], fx["sizes"]
    small = np.flatnonzero(sizes <= 4)[:5]
    assert small.size == 5
    off = group_offsets(sizes)
    Fs = np.concatenate([F[off[g] : off[g + 1]] for g in small])
    ss = sizes[small]
    ex, jex = _executors(gp, jgp)
    kw = dict(batch_groups=3, capacity_groups=8, streaming=True, policy=policy)
    srv = GroupedRankServer(gp, executor=ex, **kw)
    jsrv = JServer(jgp, executor=jex, **kw)
    arr = np.arange(ss.size, dtype=np.float64)
    _same_results(_stream_serve(srv, Fs, ss, arr), _stream_serve(jsrv, Fs, ss, arr))
    assert vars(srv.stats) == vars(jsrv.stats)
    assert [r.capacity_groups for r in srv.stream_results] == [8, 8]
    assert [len(r.exit_stage) for r in srv.stream_results] == [3, 2]
    assert (ex.traces, jex.traces) == (1, 2)


def test_streaming_server_submit_rules():
    F, sizes = _ragged(seed=2, G=6)
    gp = _port_plan(j_fit_grouped(F, sizes, K, alpha=0.05, chunk_t=CHUNK_T))
    srv = GroupedRankServer(gp, streaming=True, device="cpu")
    srv.submit(F[:2], arrival=3.0)
    with pytest.raises(ValueError, match="nondecreasing"):
        srv.submit(F[:2], arrival=2.5)
    with pytest.raises(ValueError, match="unknown admission policy"):
        GroupedRankServer(gp, streaming=True, policy="fifo", device="cpu")


@pytest.mark.parametrize("policy", ["sorted-kernel", "wait"])
def test_api_grouped_streaming_serve_matches_jax(fx, policy):
    """``fit(groups=).compile("device").serve(streaming=True, policy=)``:
    the row-level default policy maps to ``skip-ahead``; results and
    ``RankStats`` equal JAX's."""
    F, sizes = fx["F"], fx["sizes"]
    kw = dict(groups=sizes, topk=K, alpha=0.05, chunk_t=CHUNK_T)
    srv = api.fit(F, **kw).compile("device", device="cpu").serve(
        streaming=True, policy=policy, batch_size=32
    )
    jsrv = japi.fit(F, **kw).compile("device").serve(streaming=True, policy=policy,
                                                    batch_size=32)
    assert srv.policy == jsrv.policy == ("wait" if policy == "wait" else "skip-ahead")
    arr = np.cumsum(np.random.default_rng(2028).exponential(1 / 4.0, size=sizes.size))
    _same_results(_stream_serve(srv, F, sizes, arr), _stream_serve(jsrv, F, sizes, arr))
    assert vars(srv.stats) == vars(jsrv.stats)


def test_cli_grouped_streaming_matches_api(capsys):
    """``serve --groups 8 --topk 5 --streaming --device cpu``: its report
    equals the same API call's (the CLI's setup, its seed-2031 queries and
    its seed-2028 arrivals at the default 4 a step).  JAX's ``--groups``
    CLI scores with its dead tree kernel (ROADMAP C1), so the API is the
    oracle here, held to JAX's above."""
    args = ["--device", "cpu", "--groups", "8", "--topk", "5", "--T", "60",
            "--scale", "0.1", "--alpha", "0.05", "--streaming"]
    serve.main(args)
    out = capsys.readouterr().out
    ds = make_dataset("adult", scale=0.1)
    g = train_gbt(ds.x_train, ds.y_train, n_trees=60, depth=5, device="cpu")

    def score_fn(x):
        return ops.gbt_scores(g.feats, g.thrs, g.leaves, x)

    F_tr = score_fn(torch.from_numpy(ds.x_train)).numpy().astype(np.float64)
    rng = np.random.default_rng(serve.GROUPS_SEED)
    sizes_tr = serve._ragged_sizes(len(ds.y_train), 8, rng)
    sizes_te = serve._ragged_sizes(len(ds.y_test), 8, rng)
    srv = api.fit(
        F_tr, groups=sizes_tr, topk=5, alpha=0.05, beta=-g.base_score, chunk_t=8
    ).compile("device", device="cpu").serve(score_fn=score_fn, streaming=True, batch_size=256)
    arr = np.cumsum(np.random.default_rng(serve.ARRIVAL_SEED).exponential(0.25, sizes_te.size))
    _stream_serve(srv, ds.x_test, sizes_te, arr)
    st = srv.stats
    assert (f"{st.n_queries} queries / {st.n_docs} docs in {st.n_waves} wave(s) "
            f"(device backend, streaming)") in out
    assert f"mean exit stage {st.mean_exit_stage:.2f}/" in out
    assert f"scores computed {st.scores_computed}/{st.scores_possible}" in out
    assert re.search(r"NDCG@5 \d\.\d{4}", out)
