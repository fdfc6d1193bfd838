"""Calibration parity of the PyTorch port with the JAX package: dataset,
GBT training, the QWYC fit and the cascade evaluation, all bit-equal
(the port keeps numpy copies of the host code)."""

import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.core import evaluate_cascade as j_evaluate
from repro.core import fit_qwyc as j_fit
from repro.core import fit_thresholds_for_order as j_fit_order
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.ensembles.gbt import train_gbt as j_train_gbt
from repro_torch.convert import gbt_params_from_numpy, qwyc_model_from_numpy
from repro_torch.core import evaluate_cascade, fit_qwyc, fit_thresholds_for_order
from repro_torch.data.synthetic import make_dataset
from repro_torch.ensembles.gbt import train_gbt


@pytest.fixture(scope="module")
def adult():
    return make_dataset("adult", scale=0.1), j_make_dataset("adult", scale=0.1)


def _assert_model_equal(a, b):
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.eps_pos, b.eps_pos)
    np.testing.assert_array_equal(a.eps_neg, b.eps_neg)
    assert a.train_mean_models == b.train_mean_models
    assert a.train_diff_rate == b.train_diff_rate


def _assert_eval_equal(a, b):
    for k in ("decisions", "exit_step", "full_decisions"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("mean_models", "mean_cost", "diff_rate"):
        assert a[k] == b[k]


@pytest.mark.parametrize("name", ["adult", "nomao"])
def test_dataset_equal(name):
    a, b = make_dataset(name, scale=0.05, seed=3), j_make_dataset(name, scale=0.05, seed=3)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_train_gbt_params_equal(adult):
    ds, jds = adult
    p = train_gbt(ds.x_train, ds.y_train, n_trees=12, depth=4, device="cpu")
    jp = j_train_gbt(jds.x_train, jds.y_train, n_trees=12, depth=4)
    np.testing.assert_array_equal(p.feats.numpy(), jp.feats)
    np.testing.assert_array_equal(p.thrs.numpy(), jp.thrs)
    np.testing.assert_array_equal(p.leaves.numpy(), jp.leaves)
    assert p.base_score == jp.base_score
    q = gbt_params_from_numpy(jp.feats, jp.thrs, jp.leaves, jp.base_score, device="cpu")
    assert torch.equal(q.leaves, p.leaves) and q.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_fit_and_evaluate_equal(mode):
    rng = np.random.default_rng(21)
    F = make_scores(rng, n=300, t=24)
    Fte = make_scores(rng, n=200, t=24)
    m = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
    jm = j_fit(F, beta=0.0, alpha=0.01, mode=mode)
    _assert_model_equal(m, jm)
    _assert_eval_equal(evaluate_cascade(m, Fte), j_evaluate(jm, Fte))
    order = np.random.default_rng(5).permutation(24)
    _assert_model_equal(
        fit_thresholds_for_order(F, order, alpha=0.02, mode=mode),
        j_fit_order(F, order, alpha=0.02, mode=mode),
    )


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_converted_model_evaluates_equal(mode):
    rng = np.random.default_rng(22)
    F = make_scores(rng, n=250, t=16)
    jm = j_fit(F, beta=0.1, alpha=0.02, mode=mode)
    m = qwyc_model_from_numpy(
        np.asarray(jm.order), np.asarray(jm.eps_pos), np.asarray(jm.eps_neg),
        jm.beta, np.asarray(jm.costs), jm.alpha, jm.mode,
    )
    _assert_eval_equal(evaluate_cascade(m, F), j_evaluate(jm, F))
    with pytest.raises(ValueError, match="permutation"):
        qwyc_model_from_numpy(
            np.zeros(16), jm.eps_pos, jm.eps_neg, 0.0, jm.costs, 0.0, mode
        )


@pytest.mark.parametrize("side", ["neg", "pos"])
def test_threshold_between_adjacent_doubles(side):
    """The exact optimizer's threshold exits what it counts when the cut
    falls between two adjacent doubles, where their midpoint rounds onto one
    of them; elsewhere it agrees with the JAX reference."""
    from repro.core.thresholds import optimize_threshold_sorted as j_sorted
    from repro_torch.core.thresholds import optimize_threshold_sorted

    sign = 1.0 if side == "neg" else -1.0
    g = sign * np.array([0.0] * 9 + [np.nextafter(-100.0, 0.0), -100.0])
    # the nearer of the pair is an error, so within budget 0 only the
    # farther one may exit
    fp = np.full(11, side == "pos")
    fp[9] = side == "neg"
    got = optimize_threshold_sorted(g, fp, 0, side)
    exits = g < got.threshold if side == "neg" else g > got.threshold
    errs = exits & (fp if side == "neg" else ~fp)
    assert (got.n_exited, got.n_errors) == (1, 0)
    assert (int(exits.sum()), int(errs.sum())) == (got.n_exited, got.n_errors)

    rng = np.random.default_rng(0)
    g = rng.normal(size=200)
    fp = rng.uniform(size=200) < 0.4
    for budget in (0, 3, 10):
        got = optimize_threshold_sorted(g, fp, budget, side)
        want = j_sorted(g, fp, budget, side)
        assert (got.threshold, got.n_exited, got.n_errors) == (
            want.threshold,
            want.n_exited,
            want.n_errors,
        )
