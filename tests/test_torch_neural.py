"""The neural depth cascade of the PyTorch port against the JAX package on
the CPU: the model pieces, ``forward``, ``exit_scores``, the early-exit
calibration, the ``BoundScorer`` state carry through every loop,
``NeuralScorer``, the model-backed ``api.fit`` and the servers.

Two fixtures at the reference's own sizes: ``tests/test_stage_scorer.py``'s
``_neural_fixture`` (6 layers, d_model 32) and ``benchmarks/bench_neural.py``'s
``neural_fixture(quick=True)`` (8 layers, d_model 32, exit_interval 2).
The reference draws the weights; ``convert.transformer_params_from_numpy``
carries them across, and the tokens and every other random input come from
a numpy seed.

Tolerances: the layer pieces within rtol 1e-5 / atol 1e-6 (f32), the
hidden states, logits and exit scores within rtol 1e-4 / atol 1e-5.  Torch
and XLA sum f32 matmuls in different orders, so across the packages a
verdict may move only on a row whose running sum comes within ``BAND`` of
a threshold it meets: decisions and exit steps are equal on every other
row, and the count of rows in the band is asserted.  Within the port the
host oracle, the batch loop (captured and eager) and the streaming loop
score through one stage protocol and agree row for row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.bench_neural import neural_fixture
from repro import api as japi
from repro.api.scorers import host_producer as j_host_producer
from repro.core import CascadePlan as JCascadePlan
from repro.core.early_exit import calibrate_early_exit as j_calibrate
from repro.core.early_exit import evaluate_early_exit as j_evaluate
from repro.core.early_exit import exit_scores as j_exit_scores
from repro.core.executor import ChunkedExecutor as JChunkedExecutor
from repro.kernels import device_executor as jde
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import param_count as j_param_count
from repro.serving.engine import QWYCServer as JQWYCServer
from repro.serving.engine import StreamingServer as JStreamingServer
from repro_torch import api
from repro_torch.api.scorers import host_producer
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import qwyc_model_from_numpy, transformer_params_from_numpy
from repro_torch.core import CascadePlan, ChunkedExecutor, evaluate_cascade
from repro_torch.core.early_exit import (
    calibrate_early_exit,
    evaluate_early_exit,
    exit_scores,
)
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
    repack_state,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.serving.engine import QWYCServer, StreamingServer

ALPHA = 0.05
CHUNK_T = 2
BLOCK_N = 32
# a verdict may move across the packages only where the running sum comes
# this close to a threshold it meets
BAND = 1e-4
# rows inside the band per fixture at ALPHA (measured; asserted so that a
# change shows)
NEAR_ROWS = {"conformance": 0, "bench": 0}
DEV = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are small, and under
    a parallel test run every worker's threads would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _port_model(jm):
    return qwyc_model_from_numpy(
        jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha, jm.mode
    )


def _conformance():
    """``tests/test_stage_scorer.py``'s ``_neural_fixture``: its config and
    weights (PRNGKey 7); 160 sequences of 8 tokens from numpy seed 8."""
    cfg = JModelConfig(
        name="conformance", arch_type="dense", n_layers=6, d_model=32,
        n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
        exit_interval=2,
    )
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(160, 8))
    return params, cfg, toks


def _bench():
    """``benchmarks/bench_neural.py``'s ``neural_fixture(quick=True)``: its
    config and weights; 256 sequences of 16 tokens from numpy seed 2031."""
    params, cfg, _ = neural_fixture(quick=True)
    toks = np.random.default_rng(2031).integers(0, cfg.vocab_size, size=(256, 16))
    return params, cfg, toks


@pytest.fixture(scope="module", params=["conformance", "bench"])
def fx(request):
    """One fixture through both packages: the reference's scorer, scores
    and fit, the port's on the carried weights, and the JAX fit carried
    across."""
    jparams, jcfg, toks = {"conformance": _conformance, "bench": _bench}[request.param]()
    cfg = _port_cfg(jcfg)
    params = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=DEV)
    jsc = japi.NeuralScorer(jparams, jcfg, seq_len=toks.shape[1])
    sc = api.NeuralScorer(params, cfg, seq_len=toks.shape[1])
    jfit = japi.fit(jsc, toks, alpha=ALPHA, chunk_t=CHUNK_T)
    fit = api.fit(sc, toks, alpha=ALPHA, chunk_t=CHUNK_T, device=DEV)
    return dict(
        name=request.param, jparams=jparams, jcfg=jcfg, params=params, cfg=cfg, toks=toks,
        jsc=jsc, sc=sc, jfit=jfit, fit=fit, jmodel=_port_model(jfit.model),
        jscores=np.asarray(j_exit_scores(jparams, jcfg, jnp.asarray(toks))),
        scores=_np(exit_scores(params, cfg, toks)),
    )


def _plans(model):
    plan = CascadePlan.from_qwyc(model, chunk_t=CHUNK_T)
    return plan, DevicePlan.from_plan(plan)


def _arrivals(n: int) -> np.ndarray:
    return np.sort(np.random.default_rng(9).integers(0, n // 8, size=n))


def _near_threshold(model, deltas_list) -> np.ndarray:
    """Rows whose running sum, under any of the given (N, T) delta
    matrices, comes within ``BAND`` of a finite threshold at a position up
    to the last one reached (or of ``beta`` at the end)."""
    near = np.zeros(deltas_list[0].shape[0], dtype=bool)
    for F in deltas_list:
        G = np.cumsum(np.asarray(F, dtype=np.float64)[:, model.order], axis=1)
        for eps in (model.eps_pos, model.eps_neg):
            fin = np.isfinite(eps)
            near |= (np.abs(G[:, fin] - eps[fin]) <= BAND).any(axis=1)
        near |= np.abs(G[:, -1] - model.beta) <= BAND
    return near


def _deltas(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float64)
    return np.diff(np.concatenate([np.zeros((s.shape[0], 1)), s], axis=1), axis=1)


# -- the model pieces --------------------------------------------------------------

PIECES = ["rms_norm", "rope", "attend_full", "attend_window4", "attend_softcap50",
          "attn_qk_norm", "mlp_swiglu", "mlp_gelu", "block"]


def _piece(name, rng):
    """(jax output, port output) of one piece on seeded inputs."""
    b, s, d, h, kv, hd = 3, 11, 32, 4, 2, 8
    cfg = JModelConfig(name="piece", arch_type="dense", n_layers=2, d_model=d, n_heads=h,
                       n_kv_heads=kv, head_dim=hd, d_ff=48, vocab_size=64,
                       qk_norm=name in ("attn_qk_norm", "block"),
                       mlp_kind="gelu" if name == "mlp_gelu" else "swiglu")
    pcfg = _port_cfg(cfg)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    conv = transformer_params_from_numpy
    if name == "rms_norm":
        w = rng.normal(size=(d,)).astype(np.float32)
        return JL.rms_norm(jnp.asarray(x), jnp.asarray(w)), L.rms_norm(_t(x), _t(w))
    if name == "rope":
        q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
        return (JL.rope(jnp.asarray(q), jnp.asarray(pos)[None], 1e6),
                L.rope(_t(q), _t(pos)[None], 1e6))
    if name.startswith("attend"):
        q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))
        window = 4 if name == "attend_window4" else 0
        cap = 50.0 if name == "attend_softcap50" else 0.0
        # a query chunk of 4 over 11 queries: padded last chunk
        j = JL._attend(*map(jnp.asarray, (q, k, v, pos, pos)), window, cap, q_chunk=4)
        return j, L._attend(*map(_t, (q, k, v, pos, pos)), window, cap, q_chunk=4)
    if name.startswith("attn"):
        jp = JL.init_attn(jax.random.PRNGKey(3), cfg)
        p = conv(jax.tree_util.tree_map(np.asarray, jp), device=DEV)
        j, _ = JL.apply_attn(jp, jnp.asarray(x), cfg, jnp.asarray(pos), 0)
        return j, L.apply_attn(p, _t(x), pcfg, _t(pos), 0)[0]
    if name.startswith("mlp"):
        jp = JL.init_mlp(jax.random.PRNGKey(4), cfg)
        p = conv(jax.tree_util.tree_map(np.asarray, jp), device=DEV)
        return JL.apply_mlp(jp, jnp.asarray(x), cfg), L.apply_mlp(p, _t(x), pcfg)
    jp = JT._init_block(jax.random.PRNGKey(5), cfg, "G", dense_ffn=True, dtype=jnp.float32)
    p = conv(jax.tree_util.tree_map(np.asarray, jp), device=DEV)
    j, _, _ = JT._apply_block(jp, jnp.asarray(x), cfg, "G", jnp.asarray(pos), 0, None)
    return j, T._apply_block(p, _t(x), pcfg, "G", _t(pos), 0)[0]


@pytest.mark.parametrize("name", PIECES)
def test_layer_pieces_match_jax(name):
    want, got = _piece(name, np.random.default_rng(PIECES.index(name)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_forward_and_exit_scores_match_jax(fx):
    """``forward(collect_hidden=True)``'s logits and every layer's hidden
    state, and the chunked ``exit_scores`` (which builds neither), against
    the reference's."""
    jparams, jcfg, toks = fx["jparams"], fx["jcfg"], fx["toks"][:24]
    pos = np.arange(toks.shape[1])
    jlog, _, _, jhid = JT.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                  collect_hidden=True)
    log, _, hid = T.forward(fx["params"], fx["cfg"], _t(toks), _t(pos), collect_hidden=True)
    np.testing.assert_allclose(_np(hid), np.asarray(jhid), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(log), np.asarray(jlog), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fx["scores"], fx["jscores"], rtol=1e-4, atol=1e-5)
    # the head on the raw last-token state of every exit layer, chunk by chunk
    k = fx["cfg"].exit_interval
    raw = _np(hid[k - 1 :: k, :, -1, :])
    heads = _np(fx["params"]["exit_heads"])
    np.testing.assert_allclose(fx["scores"][:24], np.einsum("ebd,ed->be", raw, heads),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_calibrate_and_evaluate_early_exit_match_jax(fx, alpha, mode):
    """On the same score matrix the calibration is the same numpy fit."""
    S = fx["jscores"]
    jm = j_calibrate(S, fx["jcfg"], alpha=alpha, mode=mode)
    m = calibrate_early_exit(S, fx["cfg"], alpha=alpha, mode=mode)
    for field in ("order", "costs", "eps_pos", "eps_neg"):
        np.testing.assert_array_equal(getattr(m, field), np.asarray(getattr(jm, field)))
    jr, r = j_evaluate(jm, S, fx["jcfg"]), evaluate_early_exit(m, torch.from_numpy(S.copy()), fx["cfg"])
    assert (r.mean_layers, r.diff_rate, r.full_layers, r.speedup) == (
        jr.mean_layers, jr.diff_rate, jr.full_layers, jr.speedup)


# -- the port's tiers against each other --------------------------------------------


def test_port_tiers_agree_row_for_row(fx):
    """On the port's own fit and scores: the host oracle (``ChunkedExecutor``
    through ``host_producer``), the batch loop with ``capture`` on and off
    and the streaming loop decide every row alike, each in one program, and
    as ``evaluate_cascade`` on the calibration matrix."""
    sc, toks, m = fx["sc"], fx["toks"], fx["fit"].model
    n = toks.shape[0]
    plan, dplan = _plans(m)
    ev = evaluate_cascade(m, fx["fit"].calibration_scores)
    producer, n_p = host_producer(sc, plan, toks, device=DEV)
    host = ChunkedExecutor(plan, producer).run(n_p)
    runs = [host]
    for capture in (True, False):
        dex = DeviceExecutor(dplan, sc.bind(dplan, device=DEV), block_n=BLOCK_N, device=DEV,
                             capture=capture)
        runs.append(dex.run(toks, n))
        runs.append(dex.run(toks, n))
        assert dex.traces == 1
    sex = DeviceExecutor(dplan, sc.bind(dplan, device=DEV), block_n=BLOCK_N, device=DEV)
    runs.append(sex.run_stream(toks, n, arrivals=_arrivals(n), capacity=BLOCK_N))
    assert sex.traces == 1
    for r in runs:
        np.testing.assert_array_equal(r.decisions, ev["decisions"])
        np.testing.assert_array_equal(r.exit_step, ev["exit_step"])
    assert (ev["exit_step"] < m.T).any() and (ev["exit_step"] == m.T).any()


def test_margin_inf_is_full_depth_forward(fx):
    """At ±inf thresholds nothing exits early and the running sum is the
    last exit head's score: every tier gives the full-depth verdict."""
    sc, toks, m = fx["sc"], fx["toks"], fx["fit"].model
    inf = np.full(m.T, np.inf)
    plan, dplan = _plans(dataclasses.replace(m, eps_pos=inf, eps_neg=-inf))
    full = fx["scores"][:, -1] >= m.beta
    producer, n = host_producer(sc, plan, toks, device=DEV)
    host = ChunkedExecutor(plan, producer).run(n)
    dex = DeviceExecutor(dplan, sc.bind(dplan, device=DEV), block_n=BLOCK_N, device=DEV)
    for r in (host, dex.run(toks, n), dex.run_stream(toks, n, arrivals=_arrivals(n),
                                                      capacity=BLOCK_N)):
        np.testing.assert_array_equal(r.decisions, full)
        assert np.all(r.exit_step == m.T)
    # the full-depth verdict of the reference, outside the band
    jfull = fx["jscores"][:, -1] >= m.beta
    far = np.abs(fx["jscores"][:, -1] - m.beta) > BAND
    np.testing.assert_array_equal(full[far], jfull[far])


# -- across the packages ------------------------------------------------------------


def test_executors_match_jax_outside_the_band(fx):
    """The JAX fit carried across: the reference's batch loop
    (``megakernel=False``), streaming loop and host oracle against the
    port's, on one cascade.  Decisions and exit steps are equal on every row outside the
    band; the band's rows are counted and the count asserted."""
    jsc, sc, toks, jm = fx["jsc"], fx["sc"], fx["toks"], fx["jfit"].model
    n = toks.shape[0]
    m = fx["jmodel"]
    jplan = JCascadePlan.from_qwyc(jm, chunk_t=CHUNK_T)
    jdplan = jde.DevicePlan.from_plan(jplan)
    plan, dplan = _plans(m)
    arr = _arrivals(n)
    jex = jde.DeviceExecutor(jdplan, jsc.bind(jdplan), block_n=BLOCK_N, megakernel=False)
    want = [jex.run(toks, n),
            jex.run_stream(toks, n, arrivals=arr.astype(np.int32), capacity=BLOCK_N)]
    dex = DeviceExecutor(dplan, sc.bind(dplan, device=DEV), block_n=BLOCK_N, device=DEV)
    got = [dex.run(toks, n), dex.run_stream(toks, n, arrivals=arr, capacity=BLOCK_N)]
    if fx["name"] == "conformance":
        # the reference's host oracle compiles a program per row count, so
        # it runs on the smaller fixture only
        jp, jn = j_host_producer(jsc, jplan, toks)
        p, pn = host_producer(sc, plan, toks, device=DEV)
        want.append(JChunkedExecutor(jplan, jp).run(jn))
        got.append(ChunkedExecutor(plan, p).run(pn))
    near = _near_threshold(m, [_deltas(fx["jscores"]), _deltas(fx["scores"])])
    print(f"{fx['name']}: {int(near.sum())} of {n} rows within {BAND} of a threshold")
    assert int(near.sum()) == NEAR_ROWS[fx["name"]]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.decisions[~near], np.asarray(w.decisions)[~near])
        np.testing.assert_array_equal(g.exit_step[~near], np.asarray(w.exit_step)[~near])
        np.testing.assert_allclose(g.g_final, np.asarray(w.g_final), rtol=1e-4, atol=1e-5)
        assert g.scores_computed == w.scores_computed


@pytest.mark.parametrize("loop", ["run_grouped", "run_stream_grouped"])
def test_grouped_loops_carry_state_as_jax(fx, loop):
    """The state carry at lane granularity: ragged query groups of the
    sequences through the grouped batch and streaming loops, against the
    reference's ``megakernel=False`` executor."""
    jsc, sc, toks, jm = fx["jsc"], fx["sc"], fx["toks"], fx["jfit"].model
    rng = np.random.default_rng(11)
    G, B, k = 20, 8, 3
    rows = rng.permutation(toks.shape[0])[: G * B].reshape(G, B)
    valid = (np.arange(B)[None, :] < rng.integers(1, B + 1, size=G)[:, None]).astype(np.int32)
    jdplan = jde.DevicePlan.from_plan(JCascadePlan.from_qwyc(jm, chunk_t=CHUNK_T))
    _, dplan = _plans(fx["jmodel"])
    eps_g = np.full(dplan.S, 0.05, dtype=np.float32)
    kw = dict(arrivals=np.sort(rng.integers(0, 6, size=G)), capacity_groups=8) if loop != "run_grouped" else {}
    jex = jde.DeviceExecutor(jdplan, jsc.bind(jdplan), block_n=BLOCK_N, megakernel=False)
    dex = DeviceExecutor(dplan, sc.bind(dplan, device=DEV), block_n=BLOCK_N, device=DEV)
    want = getattr(jex, loop)(toks, rows, valid, G, eps_g, k, **kw)
    got = getattr(dex, loop)(toks, rows, valid, G, eps_g, k, **kw)
    np.testing.assert_array_equal(got.verdicts, np.asarray(want.verdicts))
    np.testing.assert_array_equal(got.exit_stage, np.asarray(want.exit_stage))
    np.testing.assert_allclose(got.margin, np.asarray(want.margin), rtol=1e-4, atol=1e-5)
    assert got.scores_computed == want.scores_computed
    assert 1 in got.exit_stage and dplan.S in got.exit_stage
    assert dex.traces == 1


def test_model_backed_fit_matches_jax(fx):
    """``api.fit(NeuralScorer, tokens)`` pins order ``arange(E)`` and costs
    ``exit_interval``, keeps the scorer for ``compile``, and its host and
    device compiled paths agree; the thresholds are the reference's within
    the band."""
    fit, jfit, sc = fx["fit"], fx["jfit"], fx["sc"]
    E = sc.n_exits
    assert fit.scorer is sc and E == fx["jsc"].n_exits
    np.testing.assert_array_equal(fit.model.order, np.arange(E))
    np.testing.assert_array_equal(fit.model.order, np.asarray(jfit.model.order))
    np.testing.assert_array_equal(fit.model.costs, np.full(E, fx["cfg"].exit_interval))
    np.testing.assert_array_equal(fit.model.costs, np.asarray(jfit.model.costs))
    np.testing.assert_allclose(fit.calibration_scores, jfit.calibration_scores,
                               rtol=1e-4, atol=1e-5)
    for side in ("eps_pos", "eps_neg"):
        a, b = getattr(fit.model, side), np.asarray(getattr(jfit.model, side))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], atol=BAND)
    toks = fx["toks"]
    host = fit.compile("host", device=DEV).evaluate(x=toks)
    compiled = fit.compile("device", device=DEV)
    dev = compiled.evaluate(x=toks)
    np.testing.assert_array_equal(dev.decisions, host.decisions)
    np.testing.assert_array_equal(dev.exit_step, host.exit_step)
    assert compiled.traces == 1
    # explicit user costs win over the pinned ones
    costs = np.arange(1.0, E + 1)
    assert np.array_equal(api.fit(sc, toks[:40], alpha=ALPHA, costs=costs, device=DEV).model.costs,
                          costs)


@pytest.mark.parametrize("kind", ["batch", "streaming"])
def test_servers_match_jax(fx, kind):
    """``QWYCServer`` / ``StreamingServer`` with ``scorer=NeuralScorer`` on
    the JAX fit, against the reference's servers (its device rung with
    ``megakernel=False``): decisions and models evaluated equal outside
    the band, billing equal."""
    jm, m, toks = fx["jfit"].model, fx["jmodel"], fx["toks"]
    kw = dict(batch_size=BLOCK_N, chunk_t=CHUNK_T, block_n=BLOCK_N)
    if kind == "batch":
        jsrv = JQWYCServer(jm, scorer=fx["jsc"], backend="kernel", exec_backend="device",
                           backend_opts={"megakernel": False}, **kw)
        srv = QWYCServer(m, scorer=fx["sc"], backend="kernel", device=DEV, **kw)
        for row in toks:
            jsrv.submit(row)
            srv.submit(row)
    else:
        jsrv = JStreamingServer(jm, scorer=fx["jsc"], exec_backend="device", window=64, **kw)
        srv = StreamingServer(m, scorer=fx["sc"], device=DEV, window=64, **kw)
        for row, a in zip(toks, _arrivals(toks.shape[0])):
            jsrv.submit(row, arrival=float(a))
            srv.submit(row, arrival=float(a))
    want, got = jsrv.drain(), srv.drain()
    near = _near_threshold(m, [_deltas(fx["jscores"]), _deltas(fx["scores"])])
    assert len(got) == len(want) == toks.shape[0]
    for i in np.flatnonzero(~near):
        assert got[i] == want[i]
    assert srv.stats.scores_computed == jsrv.stats.scores_computed
    assert srv.stats.n_batches == jsrv.stats.n_batches


# -- the state carry and the scorer's rules -----------------------------------------


def test_repack_state_front_packs_like_row_compaction():
    """The state rides the rows' own compaction: survivors land
    front-packed in pack order, retired lanes drop, vacated lanes read
    zero; a stateless scorer's empty state stays empty."""
    cap = 6
    state = {"h": torch.arange(cap * 2, dtype=torch.float32).reshape(cap, 2),
             "s": torch.arange(cap, dtype=torch.float32)}
    updated = {k: v + 100.0 for k, v in state.items()}
    # lanes 1, 3, 4 survive -> packed slots 0, 1, 2; the others go to the trash slot
    pack = torch.tensor([cap, 0, cap, 1, 2, cap])
    out = repack_state(updated, pack)
    np.testing.assert_array_equal(_np(out["s"]), [101.0, 103.0, 104.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(_np(out["h"][:3]), _np(updated["h"])[[1, 3, 4]])
    np.testing.assert_array_equal(_np(out["h"][3:]), 0.0)
    # the same pack moves the row ids the same way
    rows = torch.full((cap + 1,), cap, dtype=torch.int64).index_copy_(
        0, pack, torch.arange(cap))[:cap]
    np.testing.assert_array_equal(_np(out["s"][:3]) - 100.0, _np(rows[:3]))
    assert repack_state({}, pack) == {}
    # against JAX's on the same lanes
    jout = jde.repack_state({k: jnp.asarray(_np(v)) for k, v in state.items()},
                            {k: jnp.asarray(_np(v)) for k, v in updated.items()},
                            jnp.asarray(_np(pack), dtype=jnp.int32))
    for k in state:
        np.testing.assert_array_equal(_np(out[k]), np.asarray(jout[k]))


def test_stateless_scorer_threads_no_state(fx):
    """A stateless scorer declares no state and the streaming state holds
    none; the neural scorer's streaming state holds its two buffers.  The
    batch program takes the same three inputs for both (a stateful
    scorer's state lives inside it), and each loop stays one program."""
    m = fx["fit"].model
    _, dplan = _plans(m)
    F = fx["fit"].calibration_scores
    calls = []
    for bound, stateful in ((matrix_stage_scorer(dplan, device=DEV), False),
                            (fx["sc"].bind(dplan, device=DEV), True)):
        assert bound.stateful == stateful
        assert (bound.init_state(4, DEV) == {}) == (not stateful)
        dex = DeviceExecutor(dplan, bound, block_n=BLOCK_N, device=DEV)
        program = dex._program
        dex._program = lambda *a, _p=program: calls.append(len(a)) or _p(*a)
        operand = fx["toks"] if stateful else F[:, m.order]
        dex.run(operand, 64)
        dex.run(operand, 64)
        st = dex._stream_state(BLOCK_N, 64, bound.prepare(operand))
        assert set(st.state) == set(bound.state_spec)
        assert dex.traces == 1
    assert calls == [3, 3, 3, 3]
    spec = fx["sc"].bind(dplan, device=DEV).state_spec
    assert spec == {"h": ((fx["toks"].shape[1], fx["cfg"].d_model), torch.float32),
                    "s_prev": ((), torch.float32)}


def test_megakernel_rejects_stateful_scorer(fx):
    _, dplan = _plans(fx["fit"].model)
    bound = fx["sc"].bind(dplan, device=DEV)
    assert bound.fn is None and bound.slabs is None
    with pytest.raises(ValueError, match="stateful"):
        DeviceExecutor(dplan, bound, block_n=BLOCK_N, megakernel=True, device=DEV)
    # the default never takes the fused step for it
    assert not DeviceExecutor(dplan, bound, block_n=BLOCK_N, device=DEV).megakernel


@pytest.mark.parametrize("case", ["order", "lead", "positions"])
def test_bind_refusals_match_jax(fx, case):
    m, jm = fx["jmodel"], fx["jfit"].model
    E = m.T
    if case == "order":
        edit = {"order": np.arange(E)[::-1].copy()}
    elif case == "positions":
        edit = {f: getattr(jm, f)[:-1] for f in ("order", "eps_pos", "eps_neg", "costs")}
    else:
        edit = {}
    jplan = JCascadePlan.from_qwyc(dataclasses.replace(jm, **edit), chunk_t=CHUNK_T)
    plan = CascadePlan.from_qwyc(dataclasses.replace(m, **{k: np.asarray(v) for k, v in edit.items()}),
                                 chunk_t=CHUNK_T)
    if case == "lead":
        jplan, plan = (dataclasses.replace(p, lead_t=1) for p in (jplan, plan))
    with pytest.raises(ValueError) as jerr:
        fx["jsc"].bind(jde.DevicePlan.from_plan(jplan))
    match = {"order": "depth-pinned", "lead": "lead stage", "positions": "cascade positions"}[case]
    with pytest.raises(ValueError, match=match) as err:
        fx["sc"].bind(DevicePlan.from_plan(plan), device=DEV)
    assert match in str(jerr.value)
    assert str(err.value).split(" (")[0] == str(jerr.value).split(" (")[0]
    if case == "lead":
        # the server's sorted-kernel policy reaches the same refusal
        srv = QWYCServer(m, scorer=fx["sc"], backend="sorted-kernel", device=DEV,
                         batch_size=BLOCK_N, chunk_t=CHUNK_T)
        srv.submit(fx["toks"][0])
        with pytest.raises(ValueError, match="lead stage"):
            srv.drain()


def test_neural_scorer_construction_and_fit_rules():
    """The scorer's and the fit's refusals, as the reference's."""
    params, jcfg, toks = _conformance()
    cfg = _port_cfg(jcfg)
    p = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device=DEV)
    for bad, match in ((dataclasses.replace(cfg, exit_interval=0), "exit_interval"),
                       (dataclasses.replace(cfg, layer_pattern="GR"), "uniform"),
                       (dataclasses.replace(cfg, first_dense_layers=1), "first_dense_layers")):
        with pytest.raises(ValueError, match=match):
            api.NeuralScorer(p, bad, seq_len=8)
    with pytest.raises(ValueError, match="exit_heads"):
        api.NeuralScorer({k: v for k, v in p.items() if k != "exit_heads"}, cfg, seq_len=8)
    sc = api.NeuralScorer(p, cfg, seq_len=8)
    for mod, scorer in ((api, sc), (japi, japi.NeuralScorer(params, jcfg, seq_len=8))):
        with pytest.raises(ValueError, match="needs calibration inputs X"):
            mod.fit(scorer)
        with pytest.raises(NotImplementedError, match="cannot score calibration inputs"):
            mod.MatrixScorer().calibration_scores(toks)
    _, dplan = _plans(api.fit(sc, toks, alpha=ALPHA, chunk_t=CHUNK_T, device=DEV).model)
    with pytest.raises(ValueError, match=r"seq_len=8\) got tokens of shape"):
        sc.bind(dplan, device=DEV).prepare(toks[:, :7])


def test_host_producer_scatters_only_real_rows(fx):
    """A scorer billed at a block pads its row gathers with a repeated real
    row; the host state must advance that row once: the padded producer
    decides as the unpadded one."""
    sc, toks, m = fx["sc"], fx["toks"], fx["fit"].model
    plan, dplan = _plans(m)
    bound = sc.bind(dplan, device=DEV)
    padded = dataclasses.replace(bound, block_n=7)
    results = []
    for b in (bound, padded):
        p, n = host_producer(b, plan, toks, device=DEV)
        results.append(ChunkedExecutor(plan, p).run(n))
    np.testing.assert_array_equal(results[0].decisions, results[1].decisions)
    np.testing.assert_array_equal(results[0].exit_step, results[1].exit_step)
    # a padded gather is another matmul shape: the same sums within f32 ulps
    np.testing.assert_allclose(results[0].g_final, results[1].g_final, rtol=1e-6, atol=1e-6)


# -- configs and the families' stacks ----------------------------------------------


def test_qwen3_config_and_registry_match_jax():
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import get_config as j_get_config

    cfg, jcfg = get_config("qwen3-1.7b"), j_get_config("qwen3-1.7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert param_count(cfg) == j_param_count(jcfg)
    scaled = cfg.scaled(exit_interval=2)
    assert scaled.n_layers // scaled.exit_interval == 14 and scaled.hd() == 128
    # the registry names the reference's ten configs, in its order
    assert list(ARCHS) == list(J_ARCHS)
    with pytest.raises(KeyError, match=r"unknown arch 'nope'; known: \["):
        get_config("nope")
    with pytest.raises(KeyError, match=r"unknown arch 'nope'; known: \["):
        j_get_config("nope")


@pytest.mark.parametrize("edit", [{"kv_lora_rank": 32}, {"n_experts": 4, "top_k": 2},
                                  {"layer_pattern": "RRG"}, {"layer_pattern": "W"},
                                  {"first_dense_layers": 1}])
def test_edited_stacks_match_jax(edit):
    """Qwen3-1.7B at smoke size, three layers, with one family's edit (MLA,
    MoE, the hybrid R, R, G loop, RWKV6, a dense first layer): the
    reference's weights carried across, ``forward``'s logits, aux loss and
    hidden stack and ``exit_scores`` equal to the reference's."""
    jcfg = JModelConfig(**dataclasses.asdict(
        get_config("qwen3-1.7b").smoke().scaled(n_layers=3, exit_interval=1, **edit)))
    cfg = _port_cfg(jcfg)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(12))
    p = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device=DEV)
    assert ("loop_layers" in p) == (edit == {"layer_pattern": "RRG"})
    assert ("pre_layers" in p) == ("first_dense_layers" in edit)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, size=(4, 7))
    pos = np.arange(7)
    jlog, _, jaux, jhid = JT.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                     collect_hidden=True)
    log, aux, hid = T.forward(p, cfg, _t(toks), _t(pos), collect_hidden=True)
    np.testing.assert_allclose(_np(hid), np.asarray(jhid), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(log), np.asarray(jlog), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(exit_scores(p, cfg, toks)),
                               np.asarray(j_exit_scores(jp, jcfg, jnp.asarray(toks))),
                               rtol=1e-4, atol=1e-5)


def test_attn_cache_raises_naming_a13_third_part():
    """The attention cache branch, which raised naming ROADMAP A13's third
    part until the decode caches were ported, now runs: a 5-token chunk
    then one token into a 4-slot ring (window 4) on the reference's
    weights, the output and the ring (K, V in place, positions) equal to
    the reference's ``apply_attn`` with its cache."""
    jcfg = JModelConfig(**dataclasses.asdict(get_config("qwen3-1.7b").smoke()))
    cfg = get_config("qwen3-1.7b").smoke()
    jp = JL.init_attn(jax.random.PRNGKey(3), jcfg)
    p = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device=DEV)
    x = np.random.default_rng(7).normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    jc = JL.init_attn_cache(jcfg, 2, 16, 4, jnp.float32)
    c = L.init_attn_cache(cfg, 2, 16, 4, torch.float32, device=DEV)
    for lo, hi in ((0, 5), (5, 6)):
        pos = np.arange(lo, hi)
        j, jc = JL.apply_attn(jp, jnp.asarray(x[:, lo:hi]), jcfg, jnp.asarray(pos), 4, jc)
        got, c2 = L.apply_attn(p, _t(x[:, lo:hi]), cfg, _t(pos), 4, cache=c)
        assert c2 is c
        np.testing.assert_allclose(_np(got), np.asarray(j), rtol=1e-5, atol=1e-6)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(_np(c["pos"]), np.asarray(jc["pos"]))


def test_init_params_layout_and_scales():
    """The port's own draw: the reference's layout (leading-L stacks, the
    exit heads) and scales, from an explicit generator."""
    cfg = get_config("qwen3-1.7b").smoke().scaled(n_layers=4, exit_interval=2)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JT.abstract_params(JModelConfig(**dataclasses.asdict(cfg))))
    p = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
    assert shapes == jshapes
    q = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    assert torch.equal(p["layers"]["attn"]["wq"], q["layers"]["attn"]["wq"])
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(p["exit_heads"].std()) - 0.02) < 0.005
    assert torch.equal(p["layers"]["ln1"], torch.ones_like(p["layers"]["ln1"]))
