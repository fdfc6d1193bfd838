"""Guarded serving in the PyTorch port against the JAX package on the CPU:
NaN / ±inf confinement in the decide kernels' plain versions (B1, B2, B6)
and in the device loop, fault plans, the degradation ladder, the admission
quarantine, the drift watchdog, the launcher's chaos flags and SIGTERM
drain, and the one deliberate divergence: a non-injected error (a CUDA
error) propagates and records no event (ROADMAP C11).

Every input is made with numpy from a seed.  The reference side runs what
runs under the installed JAX (ROADMAP C1): the decide kernels in interpret
mode, ``DeviceExecutor(megakernel=False)``, and the servers' host rung or
their device rung with ``megakernel=False`` (ROADMAP C3).  Every comparison
is exact.
"""

from __future__ import annotations

import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro import api as japi
from repro.api import backends as jbackends
from repro.kernels import cascade_kernel as jck
from repro.kernels import device_executor as jde
from repro.serving import QWYCServer as JServer
from repro.serving import StreamingServer as JStreamingServer
from repro.serving import watchdog as jwatchdog
from repro.testing import FaultPlan as JFaultPlan
from repro_torch import api
from repro_torch.api.backends import (
    BackoffPolicy,
    DegradationEvent,
    DegradationLadder,
    fallback_rung,
)
from repro_torch.kernels import cascade_kernel as ck
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    WaveFailure,
    check_batch_finite,
    launch_wave,
    matrix_stage_scorer,
)
from repro_torch.launch import serve
from repro_torch.serving import (
    DriftWatchdog,
    QWYCServer,
    StreamingServer,
    WatchdogConfig,
)
from repro_torch.serving.watchdog import widen_plan
from repro_torch.testing import FaultInjected, FaultPlan, faults

NO_SLEEP = {"backoff": BackoffPolicy(retries=2), "sleep": lambda s: None}
CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.uint32)


def _events(evs) -> list[tuple]:
    return [(e.kind, e.from_backend, e.to_backend, e.error, e.retries) for e in evs]


def _linear_world(seed=11, n_cal=400, d=6, t=12, alpha=0.02):
    """A servable world: raw features and a batched score function in each
    package (float64 products of the same weights), and the one fitted
    model both packages serve."""
    rng = np.random.default_rng(seed)
    Xc = rng.normal(size=(n_cal, d)).astype(np.float32)
    W = rng.normal(size=(d, t))
    z = rng.normal(size=(1, t)) * 0.1

    def j_score_fn(X):
        return np.asarray(X, dtype=np.float64) @ W / np.sqrt(d) + z

    def score_fn(x):
        return x.double() @ torch.from_numpy(W) / np.sqrt(d) + torch.from_numpy(z)

    m = api.fit(j_score_fn(Xc), alpha=alpha, chunk_t=4).model
    return rng, Xc, score_fn, j_score_fn, m


def _serve(server, X, arrivals=False):
    for i, x in enumerate(X):
        if arrivals:
            server.submit(x, arrival=float(i))
        else:
            server.submit(x)
    return server.drain()


def _verdicts(out) -> list[tuple]:
    return [(r.get("quarantined", False), r["decision"], r["models_evaluated"]) for r in out]


# ------------------------------------------------------------ fault plans


def test_fault_plan_poison_matches_reference():
    X = np.random.default_rng(0).normal(size=(200, 5))
    for seed, frac, mode in ((9, 0.05, "nan"), (4, 0.1, "mix"), (2, 1e-6, "inf")):
        p, m = FaultPlan(seed=seed, poison_fraction=frac, poison_mode=mode).poison(X)
        jp, jm = JFaultPlan(seed=seed, poison_fraction=frac, poison_mode=mode).poison(X)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(p.view(np.uint64), jp.view(np.uint64))
        assert not np.isfinite(p[m]).all(axis=1).any()
        np.testing.assert_array_equal(p[~m], X[~m])
    _, m1 = FaultPlan(seed=9, poison_fraction=1e-6).poison(X)
    assert m1.sum() == 1
    with pytest.raises(ValueError, match="poison_mode"):
        FaultPlan(poison_mode="zero")


def test_fault_plan_arming_window_and_a15():
    assert faults.active() is None
    with FaultPlan(seed=1) as fp:
        assert faults.active() is fp
        with pytest.raises(RuntimeError, match="already armed"):
            FaultPlan(seed=2).__enter__()
    assert faults.active() is None
    plan = FaultPlan(seed=3, fail_backend="device", fail_on_call=2, fail_calls=1)
    with plan:
        faults.on_make_executor("device")
        with pytest.raises(FaultInjected, match="call #2"):
            faults.on_make_executor("device")
        faults.on_make_executor("device")
        faults.on_make_executor("host")
    assert plan.injected["make_executor"] == 1
    with FaultPlan(seed=5, fail_backend="host", fail_available=True):
        ok, why = api.get_backend("host").available()
        assert not ok and "injected outage" in why
    with pytest.raises(ValueError, match="ROADMAP A15"):
        FaultPlan(drop_device=True)


# ------------------------------------------------- NaN decide confinement


def _chunk_inputs(seed=0, m=64, ct=4):
    rng = np.random.default_rng(seed)
    g0 = rng.normal(size=m).astype(np.float32)
    scores = rng.normal(size=(m, ct)).astype(np.float32)
    return g0, scores, np.full(ct, 1.2, np.float32), np.full(ct, -1.2, np.float32)


def _assert_equal_outputs(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_array_equal(_bits(a)[~np.isnan(a)], _bits(b)[~np.isnan(b)])
        else:
            np.testing.assert_array_equal(a, b)


POISONS = [np.nan, np.inf, -np.inf]


@pytest.mark.parametrize("poison", POISONS)
def test_b2_poison_confined_and_equal_to_reference(poison):
    g0, scores, ep, en = _chunk_inputs()
    rows = np.array([3, 17, 40, 63])
    bad = scores.copy()
    bad[rows, 0] = poison
    t = torch.from_numpy
    clean = ck.cascade_chunk_kernel(t(g0), t(scores), t(ep), t(en), t0=0, block_n=16)
    dirty = ck.cascade_chunk_kernel(t(g0), t(bad), t(ep), t(en), t0=0, block_n=16)
    want = jck.cascade_chunk_pallas(
        jnp.asarray(g0), jnp.asarray(bad), jnp.asarray(ep), jnp.asarray(en),
        t0=0, block_n=16, interpret=True,
    )
    _assert_equal_outputs(dirty, want)
    keep = np.setdiff1d(np.arange(len(g0)), rows)
    for c, d in zip(clean, dirty):
        np.testing.assert_array_equal(c.numpy()[keep], d.numpy()[keep])
    if np.isnan(poison):
        g, active, dec, ex = (a.numpy()[rows] for a in dirty)
        assert (dec == 0).all() and (ex == 0).all() and (active == 1).all()
        assert np.isnan(g).all()


@pytest.mark.parametrize("poison", POISONS)
def test_b6_poison_confined_and_equal_to_reference(poison):
    g0, scores, ep, en = _chunk_inputs(seed=1)
    m, ct = scores.shape
    ep2, en2 = np.tile(ep, (m, 1)), np.tile(en, (m, 1))
    rows = np.array([0, 21, 42])
    bad = scores.copy()
    bad[rows, 0] = poison
    t = torch.from_numpy
    clean = ck.cascade_lane_kernel(t(g0), t(scores), t(ep2), t(en2), block_n=16)
    dirty = ck.cascade_lane_kernel(t(g0), t(bad), t(ep2), t(en2), block_n=16)
    want = jck.cascade_lane_pallas(
        jnp.asarray(g0), jnp.asarray(bad), jnp.asarray(ep2), jnp.asarray(en2),
        block_n=16, interpret=True,
    )
    _assert_equal_outputs(dirty, want)
    keep = np.setdiff1d(np.arange(m), rows)
    for c, d in zip(clean, dirty):
        np.testing.assert_array_equal(c.numpy()[keep], d.numpy()[keep])
    if np.isnan(poison):
        _, _, dec, ex = (a.numpy()[rows] for a in dirty)
        assert (dec == 0).all() and (ex == 0).all()


@pytest.mark.parametrize("poison", POISONS)
def test_b1_poison_confined_and_equal_to_reference(poison):
    rng = np.random.default_rng(2)
    S = (make_scores(rng, n=96, t=12) * 0.6).astype(np.float32)
    ep, en = np.full(12, 1.5, np.float32), np.full(12, -1.5, np.float32)
    rows = np.array([1, 30, 64, 95])
    bad = S.copy()
    bad[rows, 2] = poison
    t = torch.from_numpy
    clean = ck.cascade_kernel(t(S), t(ep), t(en), 0.0, block_n=32, chunk_t=4)
    dirty = ck.cascade_kernel(t(bad), t(ep), t(en), 0.0, block_n=32, chunk_t=4)
    want = jck.cascade_pallas(
        jnp.asarray(bad), jnp.asarray(ep), jnp.asarray(en), 0.0,
        block_n=32, chunk_t=4, interpret=True,
    )
    _assert_equal_outputs(dirty, want)
    keep = np.setdiff1d(np.arange(96), rows)
    for c, d in zip(clean, dirty):
        np.testing.assert_array_equal(c.numpy()[keep], d.numpy()[keep])
    if np.isnan(poison):
        # a row exited before the poisoned column keeps its verdict; the
        # rest walk to the end and decide False
        dec, ex = (a.numpy()[rows] for a in dirty)
        late = ex > 2
        assert (ex[late] == 12).all() and (dec[late] == 0).all()


@pytest.mark.parametrize("megakernel", [False, True])
def test_executor_nan_confined_to_poisoned_rows(megakernel):
    """The device loop on the CPU (multi-kernel: B2's step form; fused: B4
    matrix) against the reference's ``DeviceExecutor(megakernel=False)``:
    poisoned rows never exit and decide False, clean rows keep their clean
    verdicts, exit steps and ``g_final`` bits."""
    rng = np.random.default_rng(44)
    F = make_scores(rng, n=192, t=16)
    fitted = api.fit(F, alpha=0.01, chunk_t=4)
    dplan = DevicePlan.from_plan(fitted.plan())
    ex = DeviceExecutor(
        dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=16,
        megakernel=megakernel, device="cpu",
    )
    jdplan = jde.DevicePlan.from_plan(japi.fit(F, alpha=0.01, chunk_t=4).plan())
    jex = jde.DeviceExecutor(
        jdplan, jde.matrix_stage_scorer(jdplan), block_n=16, megakernel=False
    )
    ordered = F[:, fitted.model.order].astype(np.float32)
    bad = ordered.copy()
    rows = np.random.default_rng(5).choice(len(bad), size=6, replace=False)
    bad[rows, 0] = np.nan
    res, res2 = ex.run(ordered, len(bad)), ex.run(bad, len(bad))
    want = jex.run(bad, len(bad))
    np.testing.assert_array_equal(res2.decisions, want.decisions)
    np.testing.assert_array_equal(res2.exit_step, want.exit_step)
    nan = np.isnan(res2.g_final)
    np.testing.assert_array_equal(nan, np.isnan(want.g_final))
    np.testing.assert_array_equal(_bits(res2.g_final)[~nan], _bits(want.g_final)[~nan])
    assert res2.scores_computed == want.scores_computed
    keep = np.setdiff1d(np.arange(len(bad)), rows)
    for f in ("decisions", "exit_step"):
        np.testing.assert_array_equal(getattr(res, f)[keep], getattr(res2, f)[keep])
    np.testing.assert_array_equal(_bits(res.g_final[keep]), _bits(res2.g_final[keep]))
    assert (~res2.decisions[rows]).all() and (res2.exit_step[rows] == 16).all()
    assert nan[rows].all()


def test_executor_check_finite_guard_names_rows():
    rng = np.random.default_rng(45)
    F = make_scores(rng, n=96, t=12)
    fitted = api.fit(F, alpha=0.01, chunk_t=4)
    dplan = DevicePlan.from_plan(fitted.plan())
    ex = api.get_backend("device").make_executor(
        dplan, scorer=matrix_stage_scorer(dplan, device="cpu"), device="cpu",
        check_finite=True,
    )
    ordered = F[:, fitted.model.order].astype(np.float32)
    bad = ordered.copy()
    bad[7, 3] = np.inf
    with pytest.raises(ValueError, match=r"rows \[7\]"):
        ex.run(bad, bad.shape[0])
    with pytest.raises(ValueError, match=r"rows \[7\]"):
        ex.run_stream(torch.from_numpy(bad), bad.shape[0])
    ex.run(ordered, ordered.shape[0])
    many = np.full((12, 3), np.nan)
    with pytest.raises(ValueError, match=r"\.\.\. \(12 total\)"):
        check_batch_finite(many, 12)
    check_batch_finite(np.zeros((3, 2), np.int32), 3)


# ------------------------------------------------------ degradation ladder


def test_backoff_policy_delays_match_reference():
    for kw in ({}, {"retries": 4, "base_delay": 0.1, "factor": 3.0, "max_delay": 0.5},
               {"retries": 0}, {"retries": 6, "max_delay": 0.3}):
        assert BackoffPolicy(**kw).delays() == jbackends.BackoffPolicy(**kw).delays()


def _scripted(n_fail: int, exc):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise exc(f"transient #{calls['n']}")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("n_fail", [0, 1, 2, 3])
def test_ladder_attempt_matches_reference(n_fail):
    """The same failing callable through both ladders: the same result or
    error, sleeps and events."""
    sleeps, jsleeps = [], []
    lad = DegradationLadder(backoff=BackoffPolicy(retries=2), sleep=sleeps.append)
    jlad = jbackends.DegradationLadder(
        backoff=jbackends.BackoffPolicy(retries=2), sleep=jsleeps.append
    )
    fn, _ = _scripted(n_fail, WaveFailure)
    jfn, _ = _scripted(n_fail, jde.WaveFailure)
    if n_fail <= 2:
        assert lad.attempt("wave", "device", fn) == jlad.attempt("wave", "device", jfn) == "ok"
    else:
        with pytest.raises(WaveFailure, match="#3"):
            lad.attempt("wave", "device", fn)
        with pytest.raises(jde.WaveFailure, match="#3"):
            jlad.attempt("wave", "device", jfn)
    assert sleeps == jsleeps
    assert _events(lad.events) == _events(jlad.events)


def test_ladder_falls_to_host_then_floor_reraises():
    lad = DegradationLadder(backoff=BackoffPolicy(retries=1), sleep=lambda s: None)
    jlad = jbackends.DegradationLadder(
        backoff=jbackends.BackoffPolicy(retries=1), sleep=lambda s: None
    )
    assert lad.fall("wave", "device", WaveFailure("x")).name == "host"
    assert jlad.fall("wave", "device", jde.WaveFailure("x")).name == "host"
    assert _events(lad.events) == _events(jlad.events)
    with pytest.raises(WaveFailure, match="floor"):
        lad.fall("wave", "host", WaveFailure("floor"))
    # the host floor can be refused: nothing left
    assert fallback_rung("device", accept=lambda b: b.capabilities.on_device) is None
    assert fallback_rung("device").name == "host"
    with FaultPlan(seed=0, fail_backend="host", fail_available=True):
        assert fallback_rung("device") is None


@pytest.mark.parametrize("exc", [TypeError, ValueError, RuntimeError])
def test_ladder_retries_only_injected_faults(exc):
    """Caller bugs propagate in both packages; a plain ``RuntimeError`` (a
    CUDA error's type) also propagates in the port, where the reference
    retries it (ROADMAP C11)."""
    lad = DegradationLadder(sleep=lambda s: None)
    fn, calls = _scripted(1, exc)
    with pytest.raises(exc):
        lad.attempt("wave", "device", fn)
    assert calls["n"] == 1 and lad.events == []
    fn, calls = _scripted(1, FaultInjected)
    assert lad.attempt("wave", "device", fn) == "ok" and len(lad.events) == 1


def test_launch_wave_turns_only_injected_faults_into_wave_failure():
    with FaultPlan(seed=6, wave_failures=1, wave_fail_backend="device") as fp:
        with pytest.raises(WaveFailure, match="device wave #1"):
            launch_wave("device", lambda: pytest.fail("the wave ran"))
        assert launch_wave("device", lambda: 7) == 7
        assert launch_wave("other", lambda: 8) == 8
    assert fp.injected["waves"] == 1
    with pytest.raises(RuntimeError, match="CUDA error") as e:
        launch_wave("device", lambda: (_ for _ in ()).throw(RuntimeError(CUDA_ERROR)))
    assert not isinstance(e.value, WaveFailure)


def _setup(seed=40, n=300, t=20, alpha=0.01):
    F = make_scores(np.random.default_rng(seed), n=n, t=t)
    return F, api.fit(F, alpha=alpha, chunk_t=4), japi.fit(F, alpha=alpha, chunk_t=4)


def test_compile_construction_fault_falls_to_host_as_reference():
    F, fitted, jfitted = _setup()
    sleeps, jsleeps = [], []
    with FaultPlan(seed=3, fail_backend="device") as fp:
        c = fitted.compile("device", device="cpu", sleep=sleeps.append)
    with JFaultPlan(seed=3, fail_backend="device") as jfp:
        jc = jfitted.compile("device", interpret=True, sleep=jsleeps.append)
    assert c.backend_name == jc.backend_name == "host"
    assert fp.injected == jfp.injected and fp.injected["make_executor"] == 3
    assert sleeps == jsleeps == [0.05, 0.1]
    assert _events(c.degradation_events) == _events(jc.degradation_events)
    got, want = c.evaluate(scores=F), jfitted.compile("host").evaluate(scores=F)
    np.testing.assert_array_equal(got.decisions, want.decisions)
    np.testing.assert_array_equal(got.exit_step, want.exit_step)


def test_evaluate_wave_fault_recovers_same_rung():
    F, fitted, jfitted = _setup()
    c = fitted.compile("device", device="cpu", sleep=lambda s: None)
    want = jfitted.compile("host").evaluate(scores=F)
    with FaultPlan(seed=4, wave_failures=1) as fp:
        res = c.evaluate(scores=F)
    assert c.backend_name == "device" and fp.injected["waves"] == 1
    np.testing.assert_array_equal(res.decisions, want.decisions)
    np.testing.assert_array_equal(res.exit_step, want.exit_step)
    assert _events(c.degradation_events) == [
        ("wave", "device", "device", "injected wave fault: device wave #1 (FaultPlan seed=4)", 1)
    ]


def test_evaluate_wave_fault_falls_to_host_with_identical_verdicts():
    F, fitted, jfitted = _setup()
    c = fitted.compile("device", device="cpu", sleep=lambda s: None)
    want = jfitted.compile("host").evaluate(scores=F)
    with FaultPlan(seed=5, wave_failures=10_000):
        res = c.evaluate(scores=F)
    assert c.backend_name == "host"
    assert [(e.kind, e.from_backend, e.to_backend, e.retries)
            for e in c.degradation_events] == [("wave", "device", "host", 2)]
    for r in (res, c.evaluate(scores=F)):
        np.testing.assert_array_equal(r.decisions, want.decisions)
        np.testing.assert_array_equal(r.exit_step, want.exit_step)


# ------------------------------------------------------ server: the ladder


@pytest.mark.parametrize("failures", [1, 10_000])
def test_server_wave_faults_match_reference(failures):
    """A device server under injected wave faults: one same-rung recovery,
    or a fall to the host; the event lists and every verdict equal the
    reference's device server (``megakernel=False``, ROADMAP C3)."""
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=22)
    Xt = rng.normal(size=(64, Xc.shape[1])).astype(np.float32)
    srv = QWYCServer(m, score_fn=score_fn, batch_size=16, backend="kernel",
                     exec_backend="device", device="cpu", **NO_SLEEP)
    jsrv = JServer(m, score_fn=j_score_fn, batch_size=16, backend="kernel",
                   exec_backend="device", backend_opts={"megakernel": False},
                   backoff=jbackends.BackoffPolicy(retries=2), sleep=lambda s: None)
    with FaultPlan(seed=8, wave_failures=failures, wave_fail_backend="device"):
        got = _serve(srv, Xt)
    with JFaultPlan(seed=8, wave_failures=failures, wave_fail_backend="device"):
        want = _serve(jsrv, Xt)
    assert srv.exec.name == jsrv.exec.name == ("device" if failures == 1 else "host")
    assert srv.on_device == (failures == 1)
    assert _events(srv.stats.degradation_events) == _events(jsrv.stats.degradation_events)
    assert _verdicts(got) == _verdicts(want)


def test_streaming_server_wave_fault_recovers_or_raises():
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=28)
    Xt = rng.normal(size=(48, Xc.shape[1])).astype(np.float32)
    want = _serve(JServer(m, score_fn=j_score_fn, batch_size=16, backend="kernel"), Xt)
    srv = StreamingServer(m, score_fn=score_fn, batch_size=8, window=16,
                          device="cpu", **NO_SLEEP)
    with FaultPlan(seed=9, wave_failures=2):
        got = _serve(srv, Xt, arrivals=True)
    assert [(e.to_backend, e.retries) for e in srv.stats.degradation_events] == [("device", 2)]
    assert _verdicts(got) == _verdicts(want)
    # the host loop has no admission ring: with the rung lost, the fault
    # surfaces
    srv = StreamingServer(m, score_fn=score_fn, batch_size=8, window=16,
                          device="cpu", **NO_SLEEP)
    with FaultPlan(seed=9, wave_failures=10_000), pytest.raises(WaveFailure):
        _serve(srv, Xt, arrivals=True)


# ------------------------------------------------------ C11: no hidden fault


def _raise_cuda_error(*args, **kwargs):
    raise RuntimeError(CUDA_ERROR)


def test_cuda_error_propagates_with_no_event(monkeypatch):
    """ROADMAP C11: the reference's ``launch_wave`` makes every runtime
    error a retryable ``WaveFailure`` and its ladder falls to the host; the
    port lets a non-injected error out of ``flush``, ``evaluate`` and a
    streaming wave untouched, on the device rung, with no event."""
    rng, Xc, score_fn, _, m = _linear_world(seed=30)
    Xt = rng.normal(size=(16, Xc.shape[1])).astype(np.float32)
    monkeypatch.setattr(DeviceExecutor, "_program", _raise_cuda_error)
    monkeypatch.setattr(DeviceExecutor, "_stream_burst", _raise_cuda_error)
    srv = QWYCServer(m, score_fn=score_fn, batch_size=64, backend="kernel",
                     device="cpu", **NO_SLEEP)
    for x in Xt:
        srv.submit(x)
    with pytest.raises(RuntimeError, match="CUDA error") as e:
        srv.flush()
    assert not isinstance(e.value, WaveFailure)
    assert srv.exec.name == "device" and srv.stats.degradation_events == []
    stream = StreamingServer(m, score_fn=score_fn, batch_size=8, device="cpu", **NO_SLEEP)
    for x in Xt:
        stream.submit(x)
    with pytest.raises(RuntimeError, match="CUDA error"):
        stream.drain()
    assert stream.stats.degradation_events == []
    F, fitted, _ = _setup(seed=31, n=64, t=12)
    c = fitted.compile("device", device="cpu", sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        c.evaluate(scores=F)
    assert c.backend_name == "device" and c.degradation_events == []


# ------------------------------------------------------ server: quarantine


def test_server_quarantines_exactly_the_reference_rows():
    """1 %-poisoned traffic: the port's device server and the reference's
    host rung quarantine the same rows with the same verdict and reason,
    and every clean row's decision and bill equal the unpoisoned run's."""
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=23)
    Xt = rng.normal(size=(200, Xc.shape[1])).astype(np.float32)
    clean = _serve(QWYCServer(m, score_fn=score_fn, batch_size=32, backend="kernel",
                              device="cpu"), Xt)
    Xp, mask = FaultPlan(seed=31, poison_fraction=0.01, poison_mode="mix").poison(Xt)
    srv = QWYCServer(m, score_fn=score_fn, batch_size=32, backend="kernel", device="cpu")
    got = _serve(srv, Xp)
    jsrv = JServer(m, score_fn=j_score_fn, batch_size=32, backend="kernel")
    want = _serve(jsrv, Xp)
    assert got == want
    assert srv.stats.quarantined == jsrv.stats.quarantined == int(mask.sum()) == 2
    for i in range(len(Xt)):
        if mask[i]:
            assert got[i]["quarantined"] and got[i]["decision"] is None
        else:
            assert got[i] == clean[i]
    assert srv.stats.n_requests == len(Xt) - 2


def test_streaming_quarantine_preserves_submission_order():
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=29)
    Xt = rng.normal(size=(48, Xc.shape[1])).astype(np.float32)
    Xp, mask = FaultPlan(seed=41, poison_fraction=0.1).poison(Xt)
    srv = StreamingServer(m, score_fn=score_fn, batch_size=8, window=16, device="cpu")
    got = _serve(srv, Xp, arrivals=True)
    want = _serve(JServer(m, score_fn=j_score_fn, batch_size=16, backend="kernel"), Xp)
    assert _verdicts(got) == _verdicts(want)
    assert [r.get("reason") for r in got] == [r.get("reason") for r in want]
    assert srv.stats.quarantined == int(mask.sum()) == 5
    # the reference's device streaming server (its lane megakernel runs
    # under C1) quarantines the same rows
    jst = JStreamingServer(m, score_fn=j_score_fn, batch_size=8, window=16,
                           exec_backend="device")
    assert _verdicts(_serve(jst, Xp, arrivals=True)) == _verdicts(got)


def test_server_quarantine_shape_dtype_and_off():
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=24)
    d = Xc.shape[1]
    rows = [np.zeros(d, np.float32), np.zeros(d + 1, np.float32), "not a vector",
            np.full(d, np.inf, np.float32), np.ones(d, np.float32)]
    srv = QWYCServer(m, score_fn=score_fn, batch_size=8, backend="kernel", device="cpu")
    jsrv = JServer(m, score_fn=j_score_fn, batch_size=8, backend="kernel")
    got, want = _serve(srv, rows), _serve(jsrv, rows)
    assert [r.get("quarantined", False) for r in got] == [False, True, True, True, False]
    assert got == want
    off = QWYCServer(m, score_fn=score_fn, batch_size=8, backend="kernel", device="cpu",
                     quarantine=False)
    with pytest.raises(ValueError):
        off.submit("not a vector")


# --------------------------------------------------------------- watchdog


def test_watchdog_matches_reference():
    for cfg in ({"p0": 0.01}, {"p0": 0.0, "alarm": 2.0},
                {"p0": 0.01, "alarm": 1.0, "margin_schedule": (0.5, 1.0, np.inf)}):
        wd, jwd = DriftWatchdog(WatchdogConfig(**cfg)), jwatchdog.DriftWatchdog(
            jwatchdog.WatchdogConfig(**cfg))
        assert WatchdogConfig(**cfg).rates() == jwatchdog.WatchdogConfig(**cfg).rates()
        rng = np.random.default_rng(6)
        draws = [int(rng.binomial(64, p)) for p in [0.01] * 20 + [0.2] * 10 + [0.0] * 30]
        for k in draws:
            assert wd.observe(64, k) == jwd.observe(64, k)
            assert (wd.state, wd.llr, wd.alarms, wd.recovery_step) == (
                jwd.state, jwd.llr, jwd.alarms, jwd.recovery_step)
        assert wd.alarms >= 1 and wd.state == "ok"
    for bad in ({"margin_schedule": ()}, {"margin_schedule": (-1.0,)}, {"reset": 5.0}):
        with pytest.raises(ValueError):
            WatchdogConfig(**bad)


def test_widen_plan_matches_reference():
    _, fitted, jfitted = _setup()
    plan, jplan = fitted.plan(), jfitted.plan()
    for margin in (0.0, 0.7, np.inf):
        w, jw = widen_plan(plan, margin), jwatchdog.widen_plan(jplan, margin)
        np.testing.assert_array_equal(w.eps_pos, jw.eps_pos)
        np.testing.assert_array_equal(w.eps_neg, jw.eps_neg)
    assert widen_plan(plan, 0.0) is plan


def test_server_watchdog_alarm_degrades_then_recovers_as_reference():
    """Drifted traffic trips the alarm, the widened plan runs the full
    cascade, clean traffic re-arms the calibrated thresholds: the port's
    device server and the reference's host rung step through the same
    states with the same verdicts."""
    rng, Xc, score_fn, j_score_fn, m = _linear_world(seed=26, alpha=0.05)
    pool = rng.normal(size=(600, Xc.shape[1])).astype(np.float32)
    probe = _serve(JServer(m, score_fn=j_score_fn, batch_size=64, backend="kernel"), pool)
    full = j_score_fn(pool).sum(axis=1) >= m.beta
    dec = np.array([r["decision"] for r in probe])
    drift, clean = pool[dec != full], pool[dec == full]
    assert len(drift) >= 8
    drift_batch = np.tile(drift, (16 // len(drift) + 1, 1))[:16]
    srv = QWYCServer(m, score_fn=score_fn, batch_size=16, backend="kernel", device="cpu",
                     watchdog=True)
    jsrv = JServer(m, score_fn=j_score_fn, batch_size=16, backend="kernel", watchdog=True)
    T = m.T
    fields = ("watchdog_alarms", "watchdog_state", "watchdog_stat", "watchdog_margin",
              "watchdog_recovery_step")
    flushes = [drift_batch] + [clean[:16]] * 12 + [clean[16:32]]
    for i, batch in enumerate(flushes):
        got, want = _serve(srv, batch), _serve(jsrv, batch)
        assert got == want
        assert [getattr(srv.stats, f) for f in fields] == [getattr(jsrv.stats, f) for f in fields]
        if i == 0:
            assert srv.stats.watchdog_state == "alarmed" and srv.stats.watchdog_margin == np.inf
        if i == 1:
            assert all(r["models_evaluated"] == T for r in got)
    assert srv.stats.watchdog_state == "ok" and srv.stats.watchdog_recovery_step is not None
    assert any(r["models_evaluated"] < T for r in got)
    # the widened plan ran as its own program, the calibrated one again after
    assert set(srv._dev_cache) == {("device", 0.0), ("device", np.inf)}
    with pytest.raises(ValueError, match="audit"):
        QWYCServer(m, chunk_score_fn=lambda *a: None, audit_full_scores=False,
                   batch_size=8, backend="kernel", exec_backend="host", device="cpu",
                   watchdog=True)


# ------------------------------------------------------------- launcher


CLI = ["--device", "cpu", "--T", "16", "--scale", "0.05", "--alpha", "0.01",
       "--batch-size", "32"]


def test_serve_cli_chaos_flags(capsys):
    serve.main(CLI + ["--chaos-seed", "3", "--chaos-poison", "0.05",
                      "--chaos-wave-failures", "1", "--watchdog"])
    out = capsys.readouterr().out
    assert "poisoned 5/100 rows" in out
    assert "quarantined 5" in out and "1 same-rung recovery(ies)" in out
    assert "watchdog ok" in out and "95 requests" in out
    # streaming: two failed waves, recovered on the device rung (the host
    # loop has no admission ring to fall to)
    serve.main(CLI + ["--chaos-seed", "3", "--chaos-wave-failures", "2", "--streaming"])
    out = capsys.readouterr().out
    assert "ladder 1 same-rung recovery(ies)" in out and "100 admitted" in out
    with pytest.raises(WaveFailure):
        serve.main(CLI + ["--chaos-seed", "3", "--chaos-wave-failures", "3", "--streaming"])
    with pytest.raises(ValueError, match="ROADMAP A15"):
        serve.main(CLI + ["--chaos-drop-device"])
    with pytest.raises(ValueError, match="ROADMAP A15"):
        serve.main(CLI + ["--chaos-seed", "1", "--chaos-drop-device"])


def test_serve_cli_falls_to_host_and_no_quarantine(capsys):
    serve.main(CLI + ["--chaos-seed", "4", "--chaos-wave-failures", "100"])
    out = capsys.readouterr().out
    assert "ladder device->host" in out and "100 requests" in out
    assert faults.active() is None
    # without the guard the poisoned rows are served (a tree compare with a
    # NaN feature goes right), as the reference's launcher does
    serve.main(CLI + ["--chaos-seed", "4", "--chaos-poison", "0.05", "--no-quarantine"])
    out = capsys.readouterr().out
    assert "poisoned 5/100 rows" in out and "100 requests" in out
    assert "quarantined" not in out
    assert faults.active() is None


def test_serve_cli_sigterm_drains_and_prints_stats(monkeypatch, capsys):
    """A SIGTERM during the submit loop stops admission, drains the queue
    and still prints the final stats; the previous handler is restored."""
    calls = {"n": 0}
    orig_submit = QWYCServer.submit

    def submit_then_sigterm(self, x):
        calls["n"] += 1
        if calls["n"] == 5:
            signal.raise_signal(signal.SIGTERM)
        return orig_submit(self, x)

    monkeypatch.setattr(QWYCServer, "submit", submit_then_sigterm)
    prev = signal.getsignal(signal.SIGTERM)
    serve.main(CLI[:6] + ["--backend", "host", "--eager", "--batch-size", "16"])
    assert signal.getsignal(signal.SIGTERM) is prev
    out = capsys.readouterr().out
    assert "caught SIGTERM after 5 submit(s)" in out
    assert "5 requests in 1 batches" in out


def test_degradation_event_fields_match_reference():
    import dataclasses

    assert [f.name for f in dataclasses.fields(DegradationEvent)] == [
        f.name for f in dataclasses.fields(jbackends.DegradationEvent)]
