"""The paper's baselines and variants in the PyTorch port against the JAX
package: fixed orderings, the Fan et al. baseline, multi-class QWYC, the
masked-walk cascade, MoE expert contributions and the device candidate
sweep, on the same seeded numpy inputs; and the paper's claim (QWYC
evaluates fewer models than Fan) on benchmark-style data."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.core import cascade as j_cascade
from repro.core import evaluate_cascade as j_evaluate
from repro.core import fan as j_fan
from repro.core import fit_qwyc as j_fit
from repro.core import moe_qwyc as j_moe
from repro.core import multiclass as j_mc
from repro.core import orderings as j_ord
from repro.core import qwyc_distributed as j_dist
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.ensembles.gbt import apply_gbt_scores as j_apply_gbt_scores
from repro.ensembles.gbt import train_gbt as j_train_gbt
from repro_torch.convert import moe_params_from_numpy
from repro_torch.core import (
    cascade_apply,
    cascade_from_scores,
    evaluate_cascade,
    evaluate_fan,
    evaluate_multiclass,
    expert_contributions,
    fit_fan,
    fit_moe_qwyc,
    fit_qwyc,
    fit_qwyc_multiclass,
    gbt_order,
    greedy_mse_order,
    individual_mse_order,
    pack_model,
    random_order,
    report_moe_qwyc,
)
from repro_torch.core.moe_qwyc import _gate
from repro_torch.core.qwyc_distributed import fit_qwyc_sharded, sweep_candidates
from repro_torch.data.synthetic import make_dataset
from repro_torch.ensembles.gbt import train_gbt
from repro_torch.kernels import ops


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.uint32)


def _labels(rng, n, zero_one: bool):
    y = rng.integers(0, 2, size=n)
    return y if zero_one else 2 * y - 1


# ------------------------------------------------------------- orderings


@pytest.mark.parametrize("zero_one", [True, False])
def test_orderings_equal(zero_one):
    rng = np.random.default_rng(60)
    F = make_scores(rng, n=250, t=18)
    y = _labels(rng, 250, zero_one)
    np.testing.assert_array_equal(gbt_order(18), j_ord.gbt_order(18))
    for seed in (0, 7):
        np.testing.assert_array_equal(random_order(18, seed), j_ord.random_order(18, seed))
    np.testing.assert_array_equal(
        individual_mse_order(F, y), j_ord.individual_mse_order(F, y)
    )
    np.testing.assert_array_equal(greedy_mse_order(F, y), j_ord.greedy_mse_order(F, y))


# ------------------------------------------------------------------- Fan


def _assert_fan_equal(a, b):
    for f in ("order", "costs", "bin_lo", "mu", "sigma", "n_bins"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("lam", "gamma", "beta"):
        assert getattr(a, f) == getattr(b, f)


def _assert_eval_equal(a, b, arrays, scalars):
    for k in arrays:
        np.testing.assert_array_equal(a[k], b[k])
    for k in scalars:
        assert a[k] == b[k], k


@pytest.mark.parametrize("lam,costs", [(0.05, None), (0.01, "ramp")])
def test_fan_fit_and_evaluate_equal(lam, costs):
    rng = np.random.default_rng(61)
    F = make_scores(rng, n=400, t=20)
    Fte = make_scores(rng, n=300, t=20)
    order = rng.permutation(20)
    c = None if costs is None else np.linspace(1.0, 3.0, 20)
    m = fit_fan(F, order, lam=lam, gamma=2.0, beta=0.1, costs=c)
    jm = j_fan.fit_fan(F, order, lam=lam, gamma=2.0, beta=0.1, costs=c)
    _assert_fan_equal(m, jm)
    arrays = ("decisions", "exit_step", "full_decisions")
    scalars = ("mean_models", "mean_cost", "diff_rate")
    # the gamma sweep reuses the fitted statistics
    for gamma in (None, 0.5, 1.0, 4.0):
        _assert_eval_equal(
            evaluate_fan(m, Fte, gamma=gamma), j_fan.evaluate_fan(jm, Fte, gamma=gamma),
            arrays, scalars,
        )
    # out-of-range bins never stop early
    far = evaluate_fan(m, Fte + 1000.0)
    _assert_eval_equal(far, j_fan.evaluate_fan(jm, Fte + 1000.0), arrays, scalars)
    assert far["mean_models"] == 20.0


# ------------------------------------------------------------ multiclass


def _mc_scores(rng, n=300, t=10, k=4, signal=0.6):
    cls = rng.integers(0, k, size=n)
    base = rng.normal(size=(n, t, k)) * 0.5
    base[np.arange(n), :, cls] += signal
    return base


@pytest.mark.parametrize("alpha,optimize_order", [(0.0, True), (0.03, True), (0.02, False)])
def test_multiclass_equal(alpha, optimize_order):
    rng = np.random.default_rng(62)
    F = _mc_scores(rng)
    Fte = _mc_scores(rng, n=200)
    m = fit_qwyc_multiclass(F, alpha=alpha, optimize_order=optimize_order)
    jm = j_mc.fit_qwyc_multiclass(F, alpha=alpha, optimize_order=optimize_order)
    np.testing.assert_array_equal(m.order, jm.order)
    np.testing.assert_array_equal(m.eps, jm.eps)
    assert (m.train_mean_models, m.train_diff_rate) == (jm.train_mean_models, jm.train_diff_rate)
    _assert_eval_equal(
        evaluate_multiclass(m, Fte), j_mc.evaluate_multiclass(jm, Fte),
        ("decisions", "exit_step"), ("mean_models", "diff_rate"),
    )


# --------------------------------------------------------------- cascade


def _cascade_fixture(seed=63, n=200, t=16):
    rng = np.random.default_rng(seed)
    F = make_scores(rng, n=n, t=t).astype(np.float32)
    m = j_fit(F.astype(np.float64), beta=0.05, alpha=0.02)
    return F[:, m.order], m


def _assert_cascade_equal(out, jout, g_bits=True):
    np.testing.assert_array_equal(out.decisions.numpy(), np.asarray(jout.decisions))
    np.testing.assert_array_equal(out.exit_step.numpy(), np.asarray(jout.exit_step))
    np.testing.assert_array_equal(out.models_evaluated.numpy(), np.asarray(jout.models_evaluated))
    assert out.exit_step.dtype == torch.int32
    if g_bits:
        np.testing.assert_array_equal(_bits(out.g_final), _bits(jout.g_final))


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_cascade_from_scores_equal(mode):
    S, m = _cascade_fixture()
    eps_pos = np.full_like(m.eps_pos, np.inf) if mode == "neg_only" else m.eps_pos
    out = cascade_from_scores(S, eps_pos, m.eps_neg, m.beta, device="cpu")
    jout = j_cascade.cascade_from_scores(
        jnp.asarray(S), jnp.asarray(eps_pos), jnp.asarray(m.eps_neg), m.beta
    )
    _assert_cascade_equal(out, jout)
    # the masked walk agrees with the numpy evaluator's verdicts
    ev = j_evaluate(m, np.asarray(S, np.float64)[:, np.argsort(m.order)])
    if mode == "both":
        np.testing.assert_array_equal(out.exit_step.numpy(), ev["exit_step"])
    assert out.g_final.dtype == torch.float32


def test_cascade_apply_exact_columns_equal():
    S, m = _cascade_fixture(seed=64)
    params = {"col": S.T.copy()}
    out = cascade_apply(
        {"col": torch.from_numpy(params["col"])}, lambda p, x: p["col"],
        torch.zeros(S.shape[0], 1), m.eps_pos, m.eps_neg, m.beta, device="cpu",
    )
    jout = j_cascade.cascade_apply(
        {"col": jnp.asarray(params["col"])}, lambda p, x: p["col"],
        jnp.zeros((S.shape[0], 1)), jnp.asarray(m.eps_pos), jnp.asarray(m.eps_neg), m.beta,
    )
    _assert_cascade_equal(out, jout)


def _gap_thresholds(G: np.ndarray, q: float, gap: float) -> np.ndarray:
    """Per step, a threshold in the middle of the widest stretch between
    adjacent partial sums near quantile ``q``, at least ``2 * gap`` wide,
    so no partial sum lies within ``gap`` of it."""
    out = np.empty(G.shape[1])
    for t in range(G.shape[1]):
        v = np.sort(G[:, t])
        lo = int(q * (len(v) - 1))
        window = range(max(lo - 20, 0), min(lo + 20, len(v) - 1))
        j = max(window, key=lambda i: v[i + 1] - v[i])
        assert v[j + 1] - v[j] > 2 * gap
        out[t] = 0.5 * (v[j] + v[j + 1])
    return out


def test_cascade_apply_linear_within_tolerance():
    """A linear ``apply_fn``: PyTorch's and XLA's f32 products may differ
    in their last bits, so ``g_final`` matches within 1e-4 (relative to
    the row's absolute partial sums), and the verdicts are equal on a
    fixture where no partial sum lies within 1e-4 of a threshold."""
    rng = np.random.default_rng(65)
    n, d, T = 160, 6, 12
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(T, d)) * 0.4).astype(np.float32)
    b = (rng.normal(size=T) * 0.1).astype(np.float32)
    G = np.cumsum(X.astype(np.float64) @ w.T.astype(np.float64) + b, axis=1)
    eps_pos = _gap_thresholds(G, 0.9, 1e-4)
    eps_neg = _gap_thresholds(G, 0.1, 1e-4)
    beta = float(_gap_thresholds(G[:, -1:], 0.5, 1e-4)[0])
    for t in range(T):
        assert np.abs(G[:, t] - eps_pos[t]).min() > 1e-4
        assert np.abs(G[:, t] - eps_neg[t]).min() > 1e-4
    out = cascade_apply(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        lambda p, x: x @ p["w"] + p["b"], torch.from_numpy(X),
        eps_pos, eps_neg, beta, device="cpu",
    )
    jout = j_cascade.cascade_apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        lambda p, x: x @ p["w"] + p["b"], jnp.asarray(X),
        jnp.asarray(eps_pos), jnp.asarray(eps_neg), beta,
    )
    _assert_cascade_equal(out, jout, g_bits=False)
    scale = np.abs(G).max(axis=1) + 1.0
    np.testing.assert_array_less(
        np.abs(out.g_final.numpy() - np.asarray(jout.g_final)), 1e-4 * scale
    )
    assert 0 < int((out.exit_step.numpy() < T).sum()) < n


def test_pack_model_equal():
    rng = np.random.default_rng(66)
    tree = {"a": rng.normal(size=(9, 3)).astype(np.float32),
            "b": (rng.integers(0, 5, size=9).astype(np.int32),
                  rng.normal(size=(9,)).astype(np.float32))}
    order = rng.permutation(9)
    got = pack_model({"a": torch.from_numpy(tree["a"]),
                      "b": tuple(torch.from_numpy(v) for v in tree["b"])}, order)
    want = j_cascade.pack_model({"a": jnp.asarray(tree["a"]),
                                 "b": tuple(jnp.asarray(v) for v in tree["b"])}, order)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    for g, w in zip(got["b"], want["b"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert isinstance(got["b"], tuple)
    # arrays are made tensors
    np.testing.assert_array_equal(pack_model(tree["a"], order).numpy(), tree["a"][order])


# ------------------------------------------------------- candidate sweep


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("budget", [0, 3, 12])
def test_sweep_candidates_equal(mode, budget):
    rng = np.random.default_rng(67)
    G = (make_scores(rng, n=180, t=14) * 1.3).astype(np.float32)
    G[5, 2] = G[6, 2]  # a tie inside one candidate column
    G[:, 9] = np.round(G[:, 9], 1)  # a column full of ties
    full_pos = make_scores(rng, n=180, t=14).sum(1) >= 0
    got = sweep_candidates(torch.from_numpy(G), torch.from_numpy(full_pos), budget, mode=mode)
    want = j_dist.sweep_candidates(
        jnp.asarray(G), jnp.asarray(full_pos), jnp.int32(budget), mode=mode
    )
    for k in ("thr_neg", "thr_pos"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    for k in ("n_exited", "n_errors"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert int(got["n_exited"].sum()) > 0


@pytest.mark.parametrize("mode,alpha", [("both", 0.0), ("both", 0.02), ("neg_only", 0.02)])
def test_fit_qwyc_sharded_equal(mode, alpha):
    rng = np.random.default_rng(68)
    F = make_scores(rng, n=240, t=14)
    m = fit_qwyc_sharded(F, beta=0.0, alpha=alpha, mode=mode, device="cpu")
    jm = j_dist.fit_qwyc_sharded(F, beta=0.0, alpha=alpha, mode=mode)
    np.testing.assert_array_equal(m.order, jm.order)
    np.testing.assert_array_equal(m.eps_pos, jm.eps_pos)
    np.testing.assert_array_equal(m.eps_neg, jm.eps_neg)
    for f in ("train_mean_models", "train_mean_cost", "train_diff_rate", "beta", "alpha", "mode"):
        assert getattr(m, f) == getattr(jm, f), f
    Fte = make_scores(rng, n=120, t=14)
    _assert_eval_equal(
        evaluate_cascade(m, Fte), j_evaluate(jm, Fte),
        ("decisions", "exit_step"), ("mean_models", "diff_rate"),
    )


def test_fit_qwyc_sharded_mesh_raises_naming_a15():
    with pytest.raises(ValueError, match="ROADMAP A15"):
        fit_qwyc_sharded(np.zeros((4, 3)), mesh=object(), device="cpu")


# ------------------------------------------------------------------- MoE


def _moe(seed=69, n=64, d=32, e=8, f=16):
    rng = np.random.default_rng(seed)
    p = {
        "router": rng.normal(size=(d, e)) / np.sqrt(d),
        "wi": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
        "wo": rng.normal(size=(e, f, d)) / np.sqrt(f),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(n, d)).astype(np.float32)
    readout = rng.normal(size=d).astype(np.float32)
    return p, x, readout


@pytest.mark.parametrize("top_k", [1, 3])
def test_expert_contributions_match(top_k):
    p, x, readout = _moe()
    cfg = types.SimpleNamespace(n_experts=8, top_k=top_k)
    got = expert_contributions(
        moe_params_from_numpy(p["router"], p["wi"], p["wg"], p["wo"], device="cpu"),
        x, readout, cfg, device="cpu",
    )
    want = j_moe.expert_contributions(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(readout), cfg
    )
    assert got.shape == want.shape == (64, 8) and got.dtype == torch.float32
    # the same experts are routed: the gate's support equals the reference's
    gate = _gate(torch.from_numpy(x), torch.from_numpy(p["router"]), top_k)
    import jax

    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1)
    _, topi = jax.lax.top_k(probs, top_k)
    want_support = np.zeros((64, 8), bool)
    want_support[np.arange(64)[:, None], np.asarray(topi)] = True
    np.testing.assert_array_equal(gate.numpy() > 0, want_support)
    assert ((want == 0) | want_support).all()
    c = np.abs(want).max()
    np.testing.assert_array_less(np.abs(got.numpy() - want), 1e-5 * c + 1e-6)


def test_fit_and_report_moe_qwyc_equal():
    p, x, readout = _moe(seed=70, n=200)
    cfg = types.SimpleNamespace(n_experts=8, top_k=3)
    C = j_moe.expert_contributions(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(readout), cfg
    ).astype(np.float64)
    m, jm = fit_moe_qwyc(C[:120], alpha=0.02), j_moe.fit_moe_qwyc(C[:120], alpha=0.02)
    np.testing.assert_array_equal(m.order, jm.order)
    np.testing.assert_array_equal(m.eps_pos, jm.eps_pos)
    np.testing.assert_array_equal(m.eps_neg, jm.eps_neg)
    assert report_moe_qwyc(m, C[120:]) == j_moe.report_moe_qwyc(jm, C[120:])
    # a tensor of contributions reports the same
    assert report_moe_qwyc(m, torch.from_numpy(C[120:])) == j_moe.report_moe_qwyc(jm, C[120:])


# --------------------------------------------------------- paper's claim


def test_qwyc_beats_fan_on_benchmark_style_data():
    """The port's version of the JAX integration test: nomao at scale 0.4,
    120 trees of depth 4, scored by the port's B3 (plain version).  The
    scores equal the reference's ``apply_gbt_scores`` bit for bit, so both
    packages fit one matrix; QWYC and Fan equal the reference's, and QWYC
    evaluates fewer base models (the paper's claim)."""
    ds, jds = make_dataset("nomao", scale=0.4), j_make_dataset("nomao", scale=0.4)
    gbt = train_gbt(ds.x_train, ds.y_train, n_trees=120, depth=4, device="cpu")
    jg = j_train_gbt(jds.x_train, jds.y_train, n_trees=120, depth=4)
    np.testing.assert_array_equal(gbt.leaves.numpy(), jg.leaves)
    F_tr = ops.gbt_scores(gbt.feats, gbt.thrs, gbt.leaves, torch.from_numpy(ds.x_train))
    F_te = ops.gbt_scores(gbt.feats, gbt.thrs, gbt.leaves, torch.from_numpy(ds.x_test))
    st = jg.stacked()
    for F, x in ((F_tr, jds.x_train), (F_te, jds.x_test)):
        np.testing.assert_array_equal(
            _bits(F), _bits(j_apply_gbt_scores(st, jnp.asarray(x)))
        )
    F_tr, F_te = F_tr.numpy().astype(np.float64), F_te.numpy().astype(np.float64)
    beta = -gbt.base_score
    q, jq = fit_qwyc(F_tr, beta=beta, alpha=0.005), j_fit(F_tr, beta=beta, alpha=0.005)
    np.testing.assert_array_equal(q.order, jq.order)
    qe, jqe = evaluate_cascade(q, F_te), j_evaluate(jq, F_te)
    order = individual_mse_order(F_tr, ds.y_train)
    np.testing.assert_array_equal(order, j_ord.individual_mse_order(F_tr, jds.y_train))
    fan = fit_fan(F_tr, order, lam=0.01, gamma=3.0, beta=beta)
    jfan = j_fan.fit_fan(F_tr, order, lam=0.01, gamma=3.0, beta=beta)
    fe, jfe = evaluate_fan(fan, F_te), j_fan.evaluate_fan(jfan, F_te)
    for k in ("mean_models", "diff_rate"):
        assert qe[k] == jqe[k] and fe[k] == jfe[k], k
    # paper: QWYC* evaluates fewer base models at comparable faithfulness
    assert qe["mean_models"] < fe["mean_models"]
