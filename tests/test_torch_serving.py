"""Serving parity of the PyTorch port with the JAX package on the CPU.

The port's ``QWYCServer`` over the device backend (device="cpu", the
kernels' plain versions, lazy ``TreeScorer``) against the JAX
``QWYCServer(exec_backend="host", score_fn=<apply_gbt_scores>)``: the
verdicts, ``models_evaluated`` and ``mean_models`` are equal.  The one
stated tolerance is ``full_score`` on that pair, 1e-5 relative: the JAX
host path sums the materialized f32 row with numpy's pairwise sum, the
device path carries a sequential f32 ``g_final``.  Where the port runs the
same path as JAX (its host backend over the same eager matrix), every
number is bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit_qwyc as j_fit
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.ensembles.gbt import apply_gbt_scores as j_apply_gbt_scores
from repro.ensembles.gbt import train_gbt as j_train_gbt
from repro.serving.engine import QWYCServer as JServer
from repro_torch.api.scorers import TreeScorer
from repro_torch.core import fit_qwyc
from repro_torch.ensembles.gbt import apply_gbt_scores, train_gbt
from repro_torch.launch import serve
from repro_torch.serving.engine import BACKENDS, QWYCServer

T = 60


@pytest.fixture(scope="module")
def adult():
    ds = j_make_dataset("adult", scale=0.1)
    jg = j_train_gbt(ds.x_train, ds.y_train, n_trees=T, depth=5)
    g = train_gbt(ds.x_train, ds.y_train, n_trees=T, depth=5, device="cpu")
    st = jg.stacked()
    F = np.asarray(j_apply_gbt_scores(st, jnp.asarray(ds.x_train))).astype(np.float64)
    fits = {}
    for mode in ("both", "neg_only"):
        fits[mode] = (
            j_fit(F, beta=-jg.base_score, alpha=0.01, mode=mode),
            fit_qwyc(F, beta=-g.base_score, alpha=0.01, mode=mode),
        )
    return ds, st, g, fits


def _serve(server, rows):
    for r in rows:
        server.submit(r)
    return server.drain()


def _jax_host(adult, mode, policy):
    ds, st, _, fits = adult
    srv = JServer(
        fits[mode][0], score_fn=lambda x: j_apply_gbt_scores(st, jnp.asarray(x)),
        exec_backend="host", backend=policy, batch_size=128,
    )
    return _serve(srv, ds.x_test), srv.stats


def _assert_verdicts_equal(a, b, a_stats, b_stats):
    assert [r["decision"] for r in a] == [r["decision"] for r in b]
    assert [r["models_evaluated"] for r in a] == [r["models_evaluated"] for r in b]
    assert a_stats.mean_models == b_stats.mean_models
    assert a_stats.models_evaluated == b_stats.models_evaluated


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("policy", BACKENDS)
def test_device_server_matches_jax_host_server(adult, mode, policy):
    ds, st, g, fits = adult
    want, want_stats = _jax_host(adult, mode, policy)
    srv = QWYCServer(
        fits[mode][1], scorer=TreeScorer(g.feats, g.thrs, g.leaves),
        exec_backend="device", device="cpu", backend=policy, batch_size=128,
    )
    got = _serve(srv, ds.x_test)
    _assert_verdicts_equal(want, got, want_stats, srv.stats)
    pairs = [(a["full_score"], b["full_score"]) for a, b in zip(want, got) if "full_score" in a]
    assert (len(pairs) > 0) == (mode == "neg_only")
    assert all("full_score" in b for a, b in zip(want, got) if "full_score" in a)
    for a, b in pairs:
        assert abs(a - b) <= 1e-5 * abs(a)


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("policy", BACKENDS)
def test_host_server_matches_jax_host_server_bit_for_bit(adult, mode, policy):
    ds, st, g, fits = adult
    want, want_stats = _jax_host(adult, mode, policy)
    params = g.stacked()
    srv = QWYCServer(
        fits[mode][1], score_fn=lambda x: apply_gbt_scores(params, x),
        exec_backend="host", device="cpu", backend=policy, batch_size=128,
    )
    got = _serve(srv, ds.x_test)
    assert got == want
    for k in ("scores_computed", "diffs_vs_full", "chunk_survivors", "actual_cost"):
        assert getattr(srv.stats, k) == getattr(want_stats, k)


def test_eager_device_server_uses_the_matrix_megakernel(adult):
    """score_fn on the device backend: the eager matrix goes through the
    matrix-variant stage step, with the audit from the materialized row."""
    ds, st, g, fits = adult
    want, want_stats = _jax_host(adult, "both", "sorted-kernel")
    params = g.stacked()
    srv = QWYCServer(
        fits["both"][1], score_fn=lambda x: apply_gbt_scores(params, x),
        exec_backend="device", device="cpu", batch_size=128,
    )
    got = _serve(srv, ds.x_test)
    _assert_verdicts_equal(want, got, want_stats, srv.stats)
    assert srv.stats.diffs_vs_full == want_stats.diffs_vs_full
    assert srv._dev[0].megakernel and srv._dev[1].slabs.variant == "matrix"


@pytest.mark.parametrize("extra", [[], ["--backend", "device", "--eager", "--policy", "kernel"]])
def test_cli_runs_on_cpu_and_prints_the_server_metrics(capsys, extra):
    serve.main(["--device", "cpu", "--T", str(T), "--scale", "0.1", "--alpha", "0.01", *extra])
    out = capsys.readouterr().out
    assert "[serve] dataset=adult train=800 test=200" in out
    assert "QWYC fit: train mean models" in out
    # the same numbers as a server driven directly with the CLI's setup
    ds = j_make_dataset("adult", scale=0.1)
    g = train_gbt(ds.x_train, ds.y_train, n_trees=T, depth=5, device="cpu")
    params = g.stacked()
    F = apply_gbt_scores(params, torch.from_numpy(ds.x_train)).numpy().astype(np.float64)
    m = fit_qwyc(F, beta=-g.base_score, alpha=0.01)
    kw = (
        {"score_fn": lambda x: apply_gbt_scores(params, x), "backend": "kernel"}
        if extra
        else {"scorer": TreeScorer(g.feats, g.thrs, g.leaves)}
    )
    srv = QWYCServer(m, exec_backend="device", device="cpu", **kw)
    _serve(srv, ds.x_test)
    st = srv.stats
    assert f"mean models {st.mean_models:.2f}/{T}" in out
    assert f"scores computed {st.scores_computed}/{st.scores_possible}" in out
    assert "200 requests in 1 batches (device backend" in out
