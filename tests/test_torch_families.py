"""The model families of the PyTorch port against the JAX package on the
CPU: MLA, MoE, RWKV6, RG-LRU, ``first_dense_layers``, the hybrid loop, the
softcapped local/global stack and the frontend backbones, through each
block, ``forward`` (with ``collect_hidden``), ``exit_scores`` (with and
without frontend embeddings) and the neural depth cascade's tiers.

Every config is the reference's own at smoke size (``ModelConfig.smoke``).
The reference draws the weights; ``convert.transformer_params_from_numpy``
carries them across, and the tokens and every other random input come from
a numpy seed.

Tolerances: a block's output within rtol 1e-5 / atol 1e-5, logits,
hidden states and exit scores within rtol 1e-4 / atol 1e-5 (torch and XLA
sum f32 matmuls in different orders).  MoE routing (the expert ids, each
assignment's place in its expert's queue, what the capacity keeps) is
compared exactly.  Across the packages a verdict may move only on a row
whose running sum comes within ``BAND`` of a threshold it meets: every
tier's decisions and exit steps are equal to the same tier of the
reference on every other row, and the count of rows in the band is
asserted.  A MoE layer couples the rows of one call, so for MoE the tiers
differ in the reference itself; each is held only to its own counterpart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.scorers import host_producer as j_host_producer
from repro.configs import ARCHS as J_ARCHS
from repro.core import CascadePlan as JCascadePlan
from repro.core.early_exit import exit_scores as j_exit_scores
from repro.core.executor import ChunkedExecutor as JChunkedExecutor
from repro.kernels import device_executor as jde
from repro.models import mla as JMLA
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro.models import transformer as JT
from repro.models.config import param_count as j_param_count
from repro_torch import api
from repro_torch.api.scorers import host_producer
from repro_torch.configs import ARCHS
from repro_torch.convert import qwyc_model_from_numpy, transformer_params_from_numpy
from repro_torch.core import CascadePlan, ChunkedExecutor
from repro_torch.core.early_exit import exit_layers, exit_scores
from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, param_count

DEV = "cpu"
ALPHA = 0.05
CHUNK_T = 2
BLOCK_N = 32
# a verdict may move across the packages only where the running sum comes
# this close to a threshold it meets
BAND = 1e-4
NAMES = sorted(J_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads for this module: its shapes are small, and under
    a parallel test run every worker's threads would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _carry(jparams) -> dict:
    return transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=DEV)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _smoke(name: str, **over):
    """The reference's config ``name`` at smoke size, an exit head after
    every layer, with ``over`` applied -> (jax config, port config)."""
    jcfg = J_ARCHS[name].smoke().scaled(exit_interval=1, **over)
    return jcfg, _port_cfg(jcfg)


def _model(name: str, seed: int = 0, **over):
    jcfg, cfg = _smoke(name, **over)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, _carry(jp)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


# -- configs --------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name):
    """The registry holds the reference's ten configs, field for field."""
    assert sorted(ARCHS) == NAMES
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert param_count(cfg) == j_param_count(jcfg)
    assert cfg.uniform == jcfg.uniform and cfg.layer_kinds() == jcfg.layer_kinds()


# -- blocks ---------------------------------------------------------------------

# (arch, edits, layer kind) of each block: every mixer and FFN of the families
BLOCKS = {
    "mla": ("deepseek-v2-lite-16b", {}, "G"),
    "mla_q_lora": ("deepseek-v2-lite-16b", {"q_lora_rank": 16}, "G"),
    "moe": ("qwen3-moe-30b-a3b", {}, "G"),
    "moe_shared": ("deepseek-v2-lite-16b", {}, "G"),
    "rwkv6": ("rwkv6-1.6b", {}, "W"),
    "rglru": ("recurrentgemma-2b", {}, "R"),
    "local_softcap": ("gemma2-2b", {"sliding_window": 4}, "L"),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_jax(block):
    """``_apply_block`` on the reference's block weights: the residual out
    and the MoE aux loss (zero for a dense FFN)."""
    name, over, kind = BLOCKS[block]
    jcfg, cfg = _smoke(name, **over)
    jp = JT._init_block(jax.random.PRNGKey(5), jcfg, kind, dense_ffn=False, dtype=jnp.float32)
    p = _carry(jp)
    rng = np.random.default_rng(sorted(BLOCKS).index(block))
    x = rng.normal(size=(3, 11, jcfg.d_model)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    window = T.layer_windows(cfg)[0] if kind == "L" else 0
    jx, _, jaux = JT._apply_block(jp, jnp.asarray(x), jcfg, kind, jnp.asarray(pos), window, None)
    got, aux = T._apply_block(p, _t(x), cfg, kind, _t(pos), window)
    _close(got, jx, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(jaux) != 0.0) == ("moe" in p)


def _mixer(name, rng):
    """(jax output, port output) of one mixer alone on seeded inputs."""
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    key = jax.random.PRNGKey(6)
    if name in ("mla", "mla_softcap"):
        jcfg, cfg = _smoke("deepseek-v2-lite-16b", attn_softcap=30.0 if "cap" in name else 0.0)
        jp = JMLA.init_mla(key, jcfg)
        j, _ = JMLA.apply_mla(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
        return j, MLA.apply_mla(_carry(jp), _t(x), cfg, _t(pos))
    if name == "mla_attend_chunked":
        # four queries a chunk over nine: a padded last chunk
        q_n, k_n, v = (rng.normal(size=(2, 9, 4, 8)).astype(np.float32) for _ in range(3))
        q_r = rng.normal(size=(2, 9, 4, 6)).astype(np.float32)
        k_r = rng.normal(size=(2, 9, 6)).astype(np.float32)
        args = (q_n, q_r, k_n, k_r, v, pos, pos)
        j = JMLA._mla_attend(*map(jnp.asarray, args), 0.0, q_chunk=4)
        return j, MLA._mla_attend(*map(_t, args), 0.0, q_chunk=4)
    if name == "rwkv6_projections":
        jcfg, cfg = _smoke("rwkv6-1.6b")
        jp = JRW.init_rwkv(key, jcfg)
        xp = rng.normal(size=x.shape).astype(np.float32)
        j = JRW._projections(jp, jnp.asarray(x), jnp.asarray(xp), jcfg)
        return jnp.stack(j), torch.stack(RW._projections(_carry(jp), _t(x), _t(xp), cfg))
    if name == "rwkv6":
        jcfg, cfg = _smoke("rwkv6-1.6b")
        jp = JRW.init_rwkv(key, jcfg)
        j, _ = JRW.apply_rwkv(jp, jnp.asarray(x), jcfg)
        return j, RW.apply_rwkv(_carry(jp), _t(x), cfg)
    jcfg, cfg = _smoke("recurrentgemma-2b")
    jp = JRG.init_rglru(key, jcfg)
    j, _ = JRG.apply_rglru(jp, jnp.asarray(x), jcfg)
    return j, RG.apply_rglru(_carry(jp), _t(x), cfg)


MIXERS = ["mla", "mla_softcap", "mla_attend_chunked", "rwkv6_projections", "rwkv6", "rglru"]


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_matches_jax(name):
    want, got = _mixer(name, np.random.default_rng(MIXERS.index(name)))
    _close(got, want, rtol=1e-5)


def test_init_layouts_match_jax():
    """The port's own draw of every family: the reference's tree of leaf
    shapes (``pre_layers`` and ``loop_layers`` lists, ``mix`` / ``moe`` /
    MLA leaves), from an explicit generator."""
    for name in NAMES:
        jcfg, cfg = _smoke(name, n_layers=3)
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), JT.abstract_params(jcfg))
        p = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), p) == jshapes, name
    # the scales of the families' own leaves
    _, cfg = _smoke("qwen3-moe-30b-a3b", n_experts=16, d_model=128)
    m = T.init_params(cfg, torch.Generator().manual_seed(1), device=DEV)["layers"]["moe"]
    assert abs(float(m["wi"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(m["wo"].std()) * cfg.moe_d_ff ** 0.5 - 1.0) < 0.05
    assert m["router"].dtype == torch.float32


# -- forward and exit scores ----------------------------------------------------


def _inputs(cfg, rows: int, seq: int, frontend: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(rows, seq))
    n_front = cfg.n_frontend_tokens or 4
    front = rng.normal(size=(rows, n_front, cfg.d_model)).astype(np.float32) if frontend else None
    return toks, front


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    """``forward`` with ``collect_hidden``: logits, the aux loss and the
    hidden stack (the layers after ``first_dense_layers``, as the
    reference's scan collects them), at three layers, frontend embeddings
    prepended where the config has a frontend."""
    jcfg, cfg, jp, p = _model(name, n_layers=3)
    toks, front = _inputs(cfg, 3, 10, frontend=bool(cfg.frontend))
    pos = np.arange(10 + (0 if front is None else front.shape[1]))
    jf = None if front is None else jnp.asarray(front)
    jlog, _, jaux, jhid = JT.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                     frontend_embeds=jf, collect_hidden=True)
    tf = None if front is None else _t(front)
    log, aux, hid = T.forward(p, cfg, _t(toks), _t(pos), frontend_embeds=tf, collect_hidden=True)
    assert hid.shape == jhid.shape
    _close(hid, jhid)
    _close(log, jlog)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    log2, aux2 = T.forward(p, cfg, _t(toks), _t(pos), frontend_embeds=tf)
    assert torch.equal(log2, log) and torch.equal(aux2, aux)


@pytest.mark.parametrize("frontend", [False, True], ids=["tokens", "frontend"])
@pytest.mark.parametrize("name", NAMES)
def test_exit_scores_match_jax(name, frontend):
    """``exit_scores`` (no logits, no hidden stack, rows chunked where they
    are independent) against the reference's, with and without frontend
    embeddings, at four layers and an exit after every layer."""
    jcfg, cfg, jp, p = _model(name, seed=1, n_layers=4)
    toks, front = _inputs(cfg, 5, 9, frontend=frontend, seed=2)
    jf = None if front is None else jnp.asarray(front)
    want = np.asarray(j_exit_scores(jp, jcfg, jnp.asarray(toks), frontend=jf))
    got = exit_scores(p, cfg, toks, frontend=front)
    assert got.shape == want.shape == (5, 4) and got.dtype == torch.float32
    _close(got, want)


def test_exit_layers_follow_the_reference_hidden_stack():
    """The reference's exit r reads its hidden stack at (r + 1) * k - 1,
    a stack that holds only the layers after ``first_dense_layers``, the
    index clamped to its last: with one dense layer first, exit r reads
    layer r + 1 and the last exit reads the last layer again."""
    _, cfg = _smoke("deepseek-v2-lite-16b", n_layers=4)
    assert exit_layers(cfg) == [1, 2, 3, 3]
    assert exit_layers(cfg.scaled(exit_interval=2)) == [2, 3]
    for name in ("qwen3-1.7b", "recurrentgemma-2b"):
        _, cfg = _smoke(name, n_layers=6)
        assert exit_layers(cfg.scaled(exit_interval=2)) == [1, 3, 5]


# -- MoE routing ----------------------------------------------------------------


def _j_route(router, xt, jcfg):
    """The reference's routing steps of ``apply_moe``, verbatim."""
    n, e, k = xt.shape[0], jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(xt @ router, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    capacity = max(1, int(jcfg.capacity_factor * n * k / e))
    onehot = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    pos_in = jnp.cumsum(onehot.reshape(n * k, e), axis=0).reshape(n, k, e) - onehot
    return np.asarray(topi), np.asarray((pos_in * onehot).sum(-1)), capacity


@pytest.mark.parametrize("case", ["qwen3_moe", "e16_k8", "ties"])
def test_moe_routing_matches_jax(case):
    """Expert ids, queue places and capacity equal the reference's exactly:
    on the router's own weights, on 16 experts top-8 over 2048 tokens (the
    capacity drops assignments), and on rows of exact ties (a zeroed
    residual, and rows of repeated logits), where ``lax.top_k`` takes the
    lowest expert ids."""
    over = {"n_experts": 16, "top_k": 8} if case == "e16_k8" else {}
    jcfg, cfg = _smoke("qwen3-moe-30b-a3b", **over)
    rng = np.random.default_rng(3)
    router = (rng.normal(size=(cfg.d_model, cfg.n_experts)) / np.sqrt(cfg.d_model)).astype(
        np.float32)
    n = 2048 if case == "e16_k8" else 64
    # a shared offset skews the router toward some experts
    xt = (rng.normal(size=(n, cfg.d_model)) + rng.normal(size=cfg.d_model)).astype(np.float32)
    if case == "ties":
        xt[::3] = 0.0  # a zeroed residual: every router logit 0
        router[:, 2] = router[:, 0]  # experts 0 and 2 tie on every row
    topi, pos, cap = _j_route(jnp.asarray(router), jnp.asarray(xt), jcfg)
    probs, topw, got_i, got_pos, got_cap = MOE.route(_t(router), _t(xt), cfg)
    np.testing.assert_array_equal(_np(got_i), topi)
    np.testing.assert_array_equal(_np(got_pos), pos)
    assert got_cap == cap
    _close(topw.sum(-1), np.ones(n), rtol=1e-6)
    dropped = int((pos >= cap).sum())
    if case == "e16_k8":
        assert dropped > 0  # the fixture drops assignments
    if case == "ties":
        np.testing.assert_array_equal(_np(got_i[::3]), np.tile(np.arange(cfg.top_k), (n // 3 + 1, 1)))
    # the stable top-k against torch.topk's values on every row
    vals, _ = MOE.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(_np(vals), _np(torch.topk(probs, cfg.top_k).values))


def _moe_call_fixture():
    """The call-coupling case: 16 experts, top-8, two layers, an exit after
    each; 128 sequences of 16 tokens (capacity 1280 an expert over 2048
    tokens: loaded experts drop assignments)."""
    jcfg, cfg, jp, p = _model("qwen3-moe-30b-a3b", seed=4, n_experts=16, top_k=8)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(128, 16))
    return jcfg, cfg, jp, p, toks


def test_moe_exit_scores_run_the_call_whole():
    """A MoE call couples its rows: the reference's one ``forward`` over all
    128 rows and its 32-row chunks give different scores on some rows.
    The port's ``exit_scores`` equals the whole-batch scores, and 32-row
    calls of it equal the reference's 32-row chunks."""
    jcfg, cfg, jp, p, toks = _moe_call_fixture()
    whole = np.asarray(j_exit_scores(jp, jcfg, jnp.asarray(toks)))
    chunked = np.concatenate([np.asarray(j_exit_scores(jp, jcfg, jnp.asarray(toks[i : i + 32])))
                              for i in range(0, 128, 32)])
    moved = np.abs(whole - chunked).max(axis=1) > 1e-3
    assert moved.sum() >= 1  # the fixture couples rows through the capacity
    _close(exit_scores(p, cfg, toks), whole)
    got_chunked = torch.cat([exit_scores(p, cfg, toks[i : i + 32]) for i in range(0, 128, 32)])
    _close(got_chunked, chunked)


# -- the neural depth cascade's tiers -------------------------------------------

# rows within the band per family (measured; asserted so that a change shows)
NEAR_ROWS = {"moe": 0, "rwkv6": 0}
# each family's arch and edits: the MoE smoke config at 8 experts, top-2,
# so that the capacity drops assignments in most of its calls (up to 7 %
# a layer), and a call's shape moves its rows' scores
TIER_ARCHS = {"moe": ("qwen3-moe-30b-a3b", {"n_experts": 8, "top_k": 2}),
              "rwkv6": ("rwkv6-1.6b", {})}


def _port_model(jm):
    return qwyc_model_from_numpy(jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha,
                                 jm.mode)


@pytest.fixture(scope="module", params=sorted(TIER_ARCHS))
def tfx(request):
    """One family through both packages: four layers at smoke size, an exit
    after each (W 2: two stages), 96 sequences of 8 tokens (seed 7); the
    reference's scorer and fit, and the port's scorer on the carried
    weights."""
    name, over = TIER_ARCHS[request.param]
    jcfg, cfg, jp, p = _model(name, seed=6, n_layers=4, **over)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(96, 8))
    jsc = japi.NeuralScorer(jp, jcfg, seq_len=8)
    sc = api.NeuralScorer(p, cfg, seq_len=8)
    jfit = japi.fit(jsc, toks, alpha=ALPHA, chunk_t=CHUNK_T)
    jm = jfit.model
    jdplan = jde.DevicePlan.from_plan(JCascadePlan.from_qwyc(jm, chunk_t=CHUNK_T))
    plan = CascadePlan.from_qwyc(_port_model(jm), chunk_t=CHUNK_T)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, toks=toks, jsc=jsc, sc=sc, jfit=jfit,
                model=_port_model(jm), jdplan=jdplan, plan=plan, dplan=DevicePlan.from_plan(plan))


def _near_threshold(model, deltas_list) -> np.ndarray:
    """Rows whose running sum, under any of the given (N, T) delta
    matrices, comes within ``BAND`` of a finite threshold (or of beta)."""
    near = np.zeros(deltas_list[0].shape[0], dtype=bool)
    for F in deltas_list:
        G = np.cumsum(np.asarray(F, dtype=np.float64)[:, model.order], axis=1)
        for eps in (model.eps_pos, model.eps_neg):
            fin = np.isfinite(eps)
            near |= (np.abs(G[:, fin] - eps[fin]) <= BAND).any(axis=1)
        near |= np.abs(G[:, -1] - model.beta) <= BAND
    return near


def _same_outside_band(tfx, got, want):
    near = _near_threshold(tfx["model"], [tfx["jfit"].calibration_scores,
                                          tfx["sc"].calibration_scores(tfx["toks"])])
    assert int(near.sum()) == NEAR_ROWS[tfx["name"]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.decisions[~near], np.asarray(w.decisions)[~near])
        np.testing.assert_array_equal(g.exit_step[~near], np.asarray(w.exit_step)[~near])
        np.testing.assert_allclose(g.g_final, np.asarray(w.g_final), rtol=1e-4, atol=1e-5)
        assert g.scores_computed == w.scores_computed


def test_tier_calibration_matches_jax(tfx):
    """The model-backed fit's calibration deltas (one ``exit_scores`` call
    over every row) and thresholds against the reference's."""
    fit = api.fit(tfx["sc"], tfx["toks"], alpha=ALPHA, chunk_t=CHUNK_T, device=DEV)
    _close(fit.calibration_scores, tfx["jfit"].calibration_scores)
    np.testing.assert_array_equal(fit.model.order, np.asarray(tfx["jfit"].model.order))
    for side in ("eps_pos", "eps_neg"):
        a, b = getattr(fit.model, side), np.asarray(getattr(tfx["jfit"].model, side))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], atol=BAND)


def test_tier_host_matches_jax(tfx):
    """The host oracle (``ChunkedExecutor`` through ``host_producer``): the
    same survivor rows a call as the reference's."""
    jp, jn = j_host_producer(tfx["jsc"], JCascadePlan.from_qwyc(tfx["jfit"].model,
                                                                chunk_t=CHUNK_T), tfx["toks"])
    p, n = host_producer(tfx["sc"], tfx["plan"], tfx["toks"], device=DEV)
    jplan = JCascadePlan.from_qwyc(tfx["jfit"].model, chunk_t=CHUNK_T)
    _same_outside_band(tfx, [ChunkedExecutor(tfx["plan"], p).run(n)],
                       [JChunkedExecutor(jplan, jp).run(jn)])


@pytest.mark.parametrize("loop", ["run", "run_stream"])
def test_tier_device_loop_matches_jax(tfx, loop):
    """The batch loop (every stage over the buffer's ``cap`` rows) and the
    streaming loop (every stage start over every lane) against the
    reference's ``megakernel=False`` executor."""
    n = tfx["toks"].shape[0]
    kw = {}
    if loop == "run_stream":
        arr = np.sort(np.random.default_rng(9).integers(0, n // 8, size=n))
        kw = dict(arrivals=arr, capacity=BLOCK_N)
    jex = jde.DeviceExecutor(tfx["jdplan"], tfx["jsc"].bind(tfx["jdplan"]), block_n=BLOCK_N,
                             megakernel=False)
    dex = DeviceExecutor(tfx["dplan"], tfx["sc"].bind(tfx["dplan"], device=DEV),
                         block_n=BLOCK_N, device=DEV)
    jkw = {**kw, "arrivals": kw["arrivals"].astype(np.int32)} if kw else {}
    want = getattr(jex, loop)(tfx["toks"], n, **jkw)
    got = getattr(dex, loop)(tfx["toks"], n, **kw)
    _same_outside_band(tfx, [got], [want])
    assert (got.exit_step < tfx["model"].T).any() and (got.exit_step == tfx["model"].T).any()


@pytest.mark.parametrize("loop", ["run_grouped", "run_stream_grouped"])
def test_tier_grouped_loop_matches_jax(tfx, loop):
    """Ragged query groups through the grouped batch and streaming loops
    (padding lanes read in-range rows mid-call, as the reference's)."""
    toks = tfx["toks"]
    rng = np.random.default_rng(11)
    G, B, k = 12, 8, 3
    rows = rng.permutation(toks.shape[0])[: G * B].reshape(G, B)
    valid = (np.arange(B)[None, :] < rng.integers(1, B + 1, size=G)[:, None]).astype(np.int32)
    eps_g = np.full(tfx["dplan"].S, 0.05, dtype=np.float32)
    kw = {}
    if loop == "run_stream_grouped":
        kw = dict(arrivals=np.sort(rng.integers(0, 4, size=G)), capacity_groups=4)
    jex = jde.DeviceExecutor(tfx["jdplan"], tfx["jsc"].bind(tfx["jdplan"]), block_n=BLOCK_N,
                             megakernel=False)
    dex = DeviceExecutor(tfx["dplan"], tfx["sc"].bind(tfx["dplan"], device=DEV),
                         block_n=BLOCK_N, device=DEV)
    want = getattr(jex, loop)(toks, rows, valid, G, eps_g, k, **kw)
    got = getattr(dex, loop)(toks, rows, valid, G, eps_g, k, **kw)
    np.testing.assert_array_equal(got.verdicts, np.asarray(want.verdicts))
    np.testing.assert_array_equal(got.exit_stage, np.asarray(want.exit_stage))
    np.testing.assert_allclose(got.margin, np.asarray(want.margin), rtol=1e-4, atol=1e-5)
    assert got.scores_computed == want.scores_computed


# -- the scorer's refusals -------------------------------------------------------


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "deepseek-v2-lite-16b"])
def test_neural_scorer_refusals_match_jax(name):
    """At full depth RecurrentGemma's R, R, L stack is not uniform, and
    DeepSeek keeps a dense first layer off the exit grid: both packages
    refuse the scorer, with the same error and message."""
    jcfg = J_ARCHS[name].scaled(exit_interval=2)
    cfg = _port_cfg(jcfg)
    params = {"exit_heads": np.zeros((jcfg.n_layers // 2, 4), np.float32)}
    with pytest.raises(ValueError) as jerr:
        japi.NeuralScorer(params, jcfg, seq_len=8)
    with pytest.raises(ValueError) as err:
        api.NeuralScorer(params, cfg, seq_len=8)
    assert str(err.value) == str(jerr.value)
    # at smoke depth RecurrentGemma's two layers are R, R: uniform, served
    jcfg, cfg = _smoke(name)
    if cfg.uniform and not cfg.first_dense_layers:
        assert api.NeuralScorer(params, cfg, seq_len=8).n_exits == 2
