"""The rest of the port's front door against the JAX package on the CPU:
``FunctionScorer``, the scorer registry, ``host_producer``,
``ops.score_and_decide`` (host and device modes), ``register_backend`` and
``negotiate``.

Inputs are made with numpy from a seed and go through both packages.
Decisions, exit steps, billing and every counter are compared for
equality; ``g_final`` by its bits where both sides add the same f32 scores
in the same order (the matrix producers).  A user's matmul closure (the
billing gate's ``FunctionScorer``) is scored by each package's own matmul,
so its scores are held within 1e-6 relative, its verdicts and counters
exactly.  ``negotiate`` and ``"auto"`` never land on ``host`` in the port
(the reference's negotiation ends on it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import registry as jregistry
from repro.api import scorers as jscorers
from repro.core import CascadePlan as JCascadePlan
from repro.core import evaluate_cascade as j_evaluate_cascade
from repro.core import fit_qwyc as j_fit_qwyc
from repro.core.executor import matrix_producer as j_matrix_producer
from repro.kernels import device_executor as jde
from repro.kernels import ops as jops
from repro.serving.engine import StreamingServer as JStreamingServer
from repro_torch import api
from repro_torch.api import backends, registry, scorers
from repro_torch.convert import qwyc_model_from_numpy
from repro_torch.core import CascadePlan
from repro_torch.core.executor import matrix_producer
from repro_torch.kernels import ops
from repro_torch.kernels.device_executor import BoundScorer, DevicePlan, matrix_stage_scorer
from repro_torch.serving.engine import StreamingServer


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _port_model(jm):
    return qwyc_model_from_numpy(
        jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha, jm.mode
    )


@pytest.fixture(scope="module")
def gate_fixture():
    """The billing gate's serving fixture (seed 2027: X (384, 8), a linear
    ensemble of 24 models, ``fit_qwyc`` at alpha 0.01) fitted by JAX and
    carried across."""
    rng = np.random.default_rng(2027)
    ns, ts, d = 384, 24, 8
    W = rng.normal(size=(ts, d))
    X = rng.normal(size=(ns, d)).astype(np.float32)
    Fs = (X @ W.T).astype(np.float64)
    jm = j_fit_qwyc(Fs, beta=0.0, alpha=0.01)
    return dict(X=X, W=W, Fs=Fs, jm=jm, m=_port_model(jm), ts=ts, d=d)


def _port_factory(Wo):
    """The gate's ``lane_factory`` in the port: ``factory(dplan, device)``."""
    Wo_t = torch.from_numpy(np.asarray(Wo, dtype=np.float32))

    def factory(dplan, device):
        Wp = torch.nn.functional.pad(Wo_t, (0, 0, 0, dplan.T_pad - Wo_t.shape[0])).to(device)
        width = dplan.W

        def fn(x, rows, t0, n_valid):
            return x[rows] @ Wp[t0 : t0 + width].T

        def lane_fn(x, rows, t0_lane, n_valid):
            pos = t0_lane.long()[:, None] + torch.arange(width, device=x.device)
            return torch.einsum("cd,cwd->cw", x[rows], Wp[pos])

        def prepare(xb):
            return torch.as_tensor(np.asarray(xb, dtype=np.float32)).to(device)

        return BoundScorer(fn=fn, prepare=prepare, width=width, lane_fn=lane_fn)

    return factory


def _jax_factory(Wo):
    """The reference gate's ``factory`` / ``lane_factory``."""
    import jax

    Wo_j = jnp.asarray(Wo, dtype=jnp.float32)

    def factory(dplan):
        Wp = jnp.pad(Wo_j, ((0, dplan.T_pad - Wo_j.shape[0]), (0, 0)))

        def fn(x, rows, t0, n_valid):
            slab = jax.lax.dynamic_slice(Wp, (t0, 0), (dplan.W, Wo_j.shape[1]))
            return jnp.take(x, rows, axis=0) @ slab.T

        def lane_fn(x, rows, t0_lane, n_valid):
            pos = t0_lane[:, None] + jnp.arange(dplan.W, dtype=jnp.int32)
            return jnp.einsum("cd,cwd->cw", jnp.take(x, rows, axis=0), jnp.take(Wp, pos, axis=0))

        return jde.BoundScorer(
            fn=fn, prepare=lambda xb: jnp.asarray(xb, jnp.float32), width=dplan.W,
            lane_fn=lane_fn,
        )

    return factory


# -- FunctionScorer -------------------------------------------------------------


def test_function_scorer_streaming_server_matches_jax(gate_fixture):
    """The billing gate's ``stream.device.*`` fixture: the user's matmul
    closure as a ``FunctionScorer`` behind ``StreamingServer`` on the
    device backend (capacity 32, window 128, chunk_t 6, the seed-2028
    arrivals at 32 a step).  Decisions equal ``evaluate_cascade`` and the
    JAX server's; every counter of the gate equals JAX's."""
    X, Fs, jm, m = (gate_fixture[k] for k in ("X", "Fs", "jm", "m"))
    Wo = gate_fixture["W"][jm.order]
    arrivals = np.cumsum(np.random.default_rng(2028).exponential(1.0 / 32.0, size=len(X)))
    kw = dict(batch_size=32, window=128, chunk_t=6, exec_backend="device",
              audit_full_scores=False)
    srv = StreamingServer(m, scorer=api.FunctionScorer(_port_factory(Wo)), device="cpu", **kw)
    jsrv = JStreamingServer(jm, scorer=jscorers.FunctionScorer(_jax_factory(Wo)), **kw)
    for row, a in zip(X, arrivals):
        srv.submit(row, arrival=a)
        jsrv.submit(row, arrival=a)
    got, want = srv.drain(), jsrv.drain()
    ev = j_evaluate_cascade(jm, Fs)
    assert [r["decision"] for r in got] == [r["decision"] for r in want] == \
        ev["decisions"].tolist()
    st, jst = srv.stats, jsrv.stats
    for k in ("admitted_rows", "scores_computed", "stream_steps", "stream_slot_steps",
              "models_evaluated"):
        assert getattr(st, k) == getattr(jst, k), k
    assert list(st.latency_steps) == list(jst.latency_steps)
    assert srv._dev[0].traces == jsrv._dev[0].traces == 1


def test_function_scorer_bind_takes_the_device(gate_fixture):
    """``bind(dplan, device)`` calls ``factory(dplan, device)``; batch
    evaluation through ``compile(scorer=FunctionScorer)`` equals JAX's
    (its device loop at ``megakernel=False``)."""
    X, Fs, jm, m = (gate_fixture[k] for k in ("X", "Fs", "jm", "m"))
    Wo = gate_fixture["W"][jm.order]
    seen = []

    def factory(dplan, device):
        seen.append((dplan.W, str(device)))
        return _port_factory(Wo)(dplan, device)

    fs = api.FunctionScorer(factory)
    assert fs.name == "function"
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=6))
    bound = fs.bind(dplan, device="cpu")
    assert isinstance(bound, BoundScorer) and seen == [(dplan.W, "cpu")]
    fitted = api.fit(Fs, alpha=0.01, chunk_t=6)
    jfitted = japi.fit(Fs, alpha=0.01, chunk_t=6)
    got = fitted.compile("device", device="cpu", scorer=api.FunctionScorer(
        lambda dp, dev: _port_factory(gate_fixture["W"][fitted.model.order])(dp, dev)
    )).evaluate(x=X)
    want = jfitted.compile("device", scorer=jscorers.FunctionScorer(
        _jax_factory(gate_fixture["W"][jfitted.model.order])
    )).evaluate(x=X)
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    np.testing.assert_allclose(got.g_final, np.asarray(want.g_final), rtol=1e-6, atol=1e-6)
    assert got.scores_computed == want.scores_computed


# -- the scorer registry ---------------------------------------------------------


def test_scorer_registry_matches_jax(monkeypatch):
    """The port registers the reference's families; lookups, errors and
    registration behave as JAX's."""
    names = scorers.scorer_names()
    assert names == jscorers.scorer_names()
    assert names == api.scorer_names() == ("function", "lattice", "matrix", "neural", "tree")
    for name in names:
        assert scorers.get_scorer(name).__name__ == jscorers.get_scorer(name).__name__
        assert scorers.get_scorer(name).name == name
    for mod in (scorers, jscorers):
        with pytest.raises(KeyError, match="unknown scorer 'nope'; registered:"):
            mod.get_scorer("nope")
        with pytest.raises(TypeError, match="is not a StageScorer subclass"):
            mod.register_scorer("bad", int)
    monkeypatch.setattr(scorers, "_SCORERS", dict(scorers._SCORERS))

    @dataclasses.dataclass(frozen=True)
    class Custom(scorers.StageScorer):
        name: str = "custom"

        def bind(self, dplan, device="cuda"):
            return matrix_stage_scorer(dplan, device=device)

    api.register_scorer("custom", Custom)
    assert "custom" in api.scorer_names() and api.get_scorer("custom") is Custom


# -- host_producer ---------------------------------------------------------------


@pytest.fixture(scope="module")
def matrix_fixture():
    rng = np.random.default_rng(7)
    n, t = 300, 20
    z = rng.normal(size=(n, 1))
    F = (rng.normal(size=(n, t)) * 0.7 + 0.4 * z).astype(np.float64)
    jm = j_fit_qwyc(F, beta=0.0, alpha=0.02)
    return dict(F=F, jm=jm, m=_port_model(jm), n=n)


@pytest.mark.parametrize("block_n", [None, 32])
def test_host_producer_matrix_scorer_matches_jax(matrix_fixture, block_n):
    """``host_producer(MatrixScorer(), plan, F)``: every call of the
    producer (rows at random, stage slices, ragged last stage) equals
    JAX's bit for bit, with the rows padded to the scorer's block."""
    F, jm, m = matrix_fixture["F"], matrix_fixture["jm"], matrix_fixture["m"]
    plan, jplan = CascadePlan.from_qwyc(m, chunk_t=7), JCascadePlan.from_qwyc(jm, chunk_t=7)
    dplan = DevicePlan.from_plan(plan)
    bound = scorers.MatrixScorer().bind(dplan, device="cpu")
    if block_n is not None:  # the block a kernel-backed scorer pads its rows to
        bound = dataclasses.replace(bound, block_n=block_n)
    p, n = scorers.host_producer(bound, plan, F)
    jp, jn = jscorers.host_producer(jscorers.MatrixScorer(), jplan, F)
    assert n == jn == F.shape[0]
    rng = np.random.default_rng(3)
    for t0, t1 in plan.stages:
        rows = np.sort(rng.choice(n, size=int(rng.integers(1, n)), replace=False))
        got, want = p(rows, t0, t1), jp(rows, t0, t1)
        assert got.dtype == want.dtype == np.float64 and got.shape == (rows.size, t1 - t0)
        np.testing.assert_array_equal(got, want)
    assert p(np.zeros(0, dtype=np.int64), 0, 3).shape == (0, 3)


def test_compile_host_with_scorer_matches_jax(matrix_fixture):
    """``compile("host", scorer=MatrixScorer()).evaluate(x=F)``: the host
    loop driving ``host_producer`` equals JAX's (decisions, exit steps,
    g_final bits, billing, survivors), and both equal the eager matrix."""
    F = matrix_fixture["F"]
    kw = dict(alpha=0.02, chunk_t=7)
    fitted, jfitted = api.fit(F, **kw), japi.fit(F, **kw)
    got = fitted.compile("host", device="cpu", scorer=api.MatrixScorer()).evaluate(x=F)
    want = jfitted.compile("host", scorer=jscorers.MatrixScorer()).evaluate(x=F)
    eager = fitted.compile("host", device="cpu").evaluate(scores=F)
    for a in (want, eager):
        np.testing.assert_array_equal(got.decisions, np.asarray(a.decisions))
        np.testing.assert_array_equal(got.exit_step, np.asarray(a.exit_step))
    np.testing.assert_array_equal(_bits(got.g_final), _bits(want.g_final))
    assert got.scores_computed == want.scores_computed
    assert got.survivors_per_chunk == want.survivors_per_chunk
    with pytest.raises(ValueError, match="via x="):
        fitted.compile("host", device="cpu", scorer=api.MatrixScorer()).evaluate()


def test_host_producer_function_scorer_matches_jax(gate_fixture):
    """A ``FunctionScorer`` (the gate's matmul closure, bound on the CPU,
    its block 64) through ``host_producer`` and the host loop: verdicts,
    exits and billing equal JAX's, scores within 1e-6 relative."""
    X, jm, m = gate_fixture["X"], gate_fixture["jm"], gate_fixture["m"]
    Wo = gate_fixture["W"][jm.order]

    def blocked(factory):
        return lambda *a: dataclasses.replace(factory(*a), block_n=64)

    plan, jplan = CascadePlan.from_qwyc(m, chunk_t=6), JCascadePlan.from_qwyc(jm, chunk_t=6)
    p, n = scorers.host_producer(
        api.FunctionScorer(blocked(_port_factory(Wo))), plan, X, device="cpu"
    )
    jp, _ = jscorers.host_producer(jscorers.FunctionScorer(blocked(_jax_factory(Wo))), jplan, X)
    rows = np.arange(5, 200, 3)
    np.testing.assert_allclose(p(rows, 0, 6), jp(rows, 0, 6), rtol=1e-6, atol=1e-6)
    got = backends.HostBackend().make_executor(plan, producer=p).run(n)
    want = jregistry.get_backend("host").make_executor(jplan, producer=jp).run(n)
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    assert got.scores_computed == want.scores_computed


# -- ops.score_and_decide --------------------------------------------------------


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_score_and_decide_host_matches_jax(mode):
    """The billing gate's ``kernel64`` fixture (seed 2026): the host loop
    with the chunk decide (B2's plain version) at block 64 against JAX's
    (``cascade_chunk_pallas``, interpret): decisions, exits and the bill."""
    rng = np.random.default_rng(2026)
    n, t = 512, 32
    z = rng.normal(size=(n, 1))
    F = (rng.normal(size=(n, t)) * 0.7 + 0.4 * z).astype(np.float64)
    jm = j_fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
    plan, jplan = CascadePlan.from_qwyc(_port_model(jm), chunk_t=8), \
        JCascadePlan.from_qwyc(jm, chunk_t=8)
    Fo = F[:, jm.order].astype(np.float32)
    got = ops.score_and_decide(matrix_producer(Fo), plan, n, block_n=64, backend="host",
                               torch_device="cpu")
    want = jops.score_and_decide(j_matrix_producer(Fo), jplan, n, block_n=64, backend="host")
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    assert got.scores_computed == want.scores_computed
    assert [c.n_in for c in got.chunk_stats] == [c.n_in for c in want.chunk_stats]
    key = registry.get_backend("host").billing_key(decide="kernel", block_n=64)
    assert key == jregistry.get_backend("host").billing_key(decide="kernel", block_n=64)
    assert key == "kernel64"


def test_score_and_decide_device_matches_jax_and_reuses_executors(matrix_fixture, monkeypatch):
    """Device mode: a ``BoundScorer`` and its operand through the device
    loop (``backend_opts={"megakernel": False}``: B2's step form) against
    JAX's (``megakernel=False``): decisions, exits, g_final bits, bill.  A
    second call with the same objects reuses the executor (one program);
    the cache keeps at most 32, first in first out; ``device=`` raises as
    the reference's does; ``"auto"`` is the device backend."""
    monkeypatch.setattr(ops, "_DEVICE_EXECUTORS", {})
    F, jm, m, n = (matrix_fixture[k] for k in ("F", "jm", "m", "n"))
    plan, jplan = CascadePlan.from_qwyc(m, chunk_t=7), JCascadePlan.from_qwyc(jm, chunk_t=7)
    dplan, jdplan = DevicePlan.from_plan(plan), jde.DevicePlan.from_plan(jplan)
    sc, jsc = matrix_stage_scorer(dplan, device="cpu"), jde.matrix_stage_scorer(jdplan)
    Fo = F[:, m.order].astype(np.float32)
    opts = {"megakernel": False}
    got = ops.score_and_decide(sc, plan, n, block_n=64, x=Fo, backend="device",
                               backend_opts=opts, torch_device="cpu")
    want = jops.score_and_decide(jsc, jplan, n, block_n=64, x=Fo, backend="device",
                                 backend_opts=opts)
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    np.testing.assert_array_equal(_bits(got.g_final), _bits(want.g_final))
    assert got.scores_computed == want.scores_computed
    (entry,) = ops._DEVICE_EXECUTORS.values()
    again = ops.score_and_decide(sc, plan, n, block_n=64, x=Fo, backend="device",
                                 backend_opts=opts, torch_device="cpu")
    np.testing.assert_array_equal(again.decisions, got.decisions)
    assert list(ops._DEVICE_EXECUTORS.values()) == [entry] and entry[0].traces == 1
    # "auto" is the device backend (never the host loop), one more entry
    auto = ops.score_and_decide(sc, plan, n, block_n=64, x=Fo, backend="auto",
                                torch_device="cpu")
    np.testing.assert_array_equal(auto.decisions, got.decisions)
    assert all(k[0] == "device" for k in ops._DEVICE_EXECUTORS)
    # bounded, first in first out: 40 fresh plans leave the last 32
    plans = [CascadePlan.from_qwyc(m, chunk_t=7) for _ in range(40)]
    for p_ in plans:
        ops.score_and_decide(sc, p_, 8, x=Fo[:8], backend="device", torch_device="cpu")
    assert len(ops._DEVICE_EXECUTORS) == ops._DEVICE_EXECUTORS_MAX == 32
    assert {k[2] for k in ops._DEVICE_EXECUTORS} == {id(p_) for p_ in plans[-32:]}
    for mod in (ops, jops):
        with pytest.raises(TypeError, match="device=...\\) was removed"):
            mod.score_and_decide(sc, plan, n, device=True)
    with pytest.raises(TypeError, match="BoundScorer"):
        ops.score_and_decide(matrix_producer(Fo), plan, n, backend="device", x=Fo,
                             torch_device="cpu")
    with pytest.raises(ValueError, match="batch operand x"):
        ops.score_and_decide(sc, plan, n, backend="device", torch_device="cpu")


# -- register_backend and negotiate ------------------------------------------------


def test_register_backend_matches_jax(monkeypatch):
    """The reference's rules: ``"auto"`` is reserved, a name registers
    once unless ``overwrite=True``; a registered backend compiles."""
    monkeypatch.setattr(registry, "_BACKENDS", dict(registry._BACKENDS))
    monkeypatch.setattr(jregistry, "_BACKENDS", dict(jregistry._BACKENDS))

    class Auto(backends.HostBackend):
        name = "auto"

    for reg, host in ((registry, backends.HostBackend()), (jregistry, japi.HostBackend())):
        with pytest.raises(ValueError, match="'auto' is reserved for negotiation"):
            reg.register_backend(Auto())
        with pytest.raises(ValueError, match="backend 'host' already registered "
                                             "\\(pass overwrite=True\\)"):
            reg.register_backend(host)
        assert reg.register_backend(host, overwrite=True) is host

    class Loop(backends.DeviceBackend):
        name = "loop"

    api.register_backend(Loop())
    assert "loop" in api.backend_names()
    rng = np.random.default_rng(1)
    F = rng.normal(size=(64, 6))
    c = api.fit(F, alpha=0.05, chunk_t=3).compile("loop", device="cpu")
    assert c.backend_name == "loop"
    np.testing.assert_array_equal(
        c.evaluate(scores=F).decisions,
        api.fit(F, alpha=0.05, chunk_t=3).compile("host", device="cpu").evaluate(scores=F).decisions,
    )


def test_negotiate_never_lands_on_host(monkeypatch):
    """The port negotiates over the device rung only: a card gives
    ``device``; none raises with every rung's reason, where the reference
    falls to its host floor."""
    assert registry.NEGOTIATION_ORDER == ("device",)
    assert jregistry.negotiate(n_devices=0).name == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device: no CUDA device \\(torch.cuda") as e:
        api.negotiate()
    assert "name backend 'host'" in str(e.value)  # the host loop: only when named
    with pytest.raises(RuntimeError, match="'auto' needs a CUDA device"):
        registry.resolve_backend("auto")
    assert registry.resolve_backend("auto", device="cpu").name == "device"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert api.negotiate().name == "device"
    assert registry.resolve_backend("auto").name == "device"
