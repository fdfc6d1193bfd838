"""Lattice Filter-and-Score serving of the PyTorch port against the JAX
package on the CPU.

Inputs are made with numpy from a seed and go through both packages.  The
lattice scores, the executor's results and the served verdicts are held
with zero tolerance: the port contracts a lattice dimension by dimension in
the reference's order, so its f32 scores are the reference's bits.  The one
tolerance is training (1e-4 absolute on theta): the two backward passes
reduce in different orders.  ``full_score`` against the JAX host server
follows ``tests/test_torch_serving.py``'s rule (1e-5 relative: numpy's
pairwise sum of the materialized row against the device loop's sequential
f32 sum).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CascadePlan as JPlan
from repro.core import fit_qwyc as j_fit
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.ensembles import lattice as jl
from repro.kernels import device_executor as jde
from repro.kernels import ref as j_ref
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.serving.engine import QWYCServer as JServer
from repro_torch.api.scorers import LatticeScorer
from repro_torch.convert import lattice_params_from_numpy
from repro_torch.core import CascadePlan, evaluate_cascade, fit_qwyc
from repro_torch.ensembles import lattice as tl
from repro_torch.kernels import ops, ref
from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, lattice_stage_scorer
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel, lattice_scores_plain
from repro_torch.launch import serve
from repro_torch.serving.engine import BACKENDS, QWYCServer


@pytest.fixture(scope="module")
def rw2():
    return j_make_dataset("rw2", scale=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_init_lattice_ensemble_matches_jax(rw2, S):
    jp = jl.init_lattice_ensemble(40, rw2.D, S, seed=3)
    tp = tl.init_lattice_ensemble(40, rw2.D, S, seed=3, device="cpu")
    assert tp["feats"].dtype == torch.int32 and tp["theta"].dtype == torch.float32
    np.testing.assert_array_equal(tp["feats"].numpy(), np.asarray(jp["feats"]))
    np.testing.assert_array_equal(tp["theta"].numpy(), np.asarray(jp["theta"]))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_lattice_scores_bit_identical_to_jax(rw2, S, monkeypatch):
    """``apply_lattice_scores``, the B5 wrapper on a CPU tensor and
    ``ref.lattice_scores_ref`` are the JAX package's bits; so is a pass
    that takes the lattices in groups."""
    rng = np.random.default_rng(S)
    T = 40
    theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
    feats = np.stack([rng.choice(rw2.D, S, replace=False) for _ in range(T)]).astype(np.int32)
    x = rw2.x_test
    want = np.asarray(jl.apply_lattice_scores(
        {"feats": jnp.asarray(feats), "theta": jnp.asarray(theta)}, jnp.asarray(x)
    ))
    np.testing.assert_array_equal(
        np.asarray(j_ref.lattice_scores_ref(jnp.asarray(theta), jnp.asarray(feats), jnp.asarray(x))),
        want,
    )
    params = {"feats": _t(feats), "theta": _t(theta)}
    xt = _t(x)
    for got in (
        tl.apply_lattice_scores(params, xt),
        ref.lattice_scores_ref(params["theta"], params["feats"], xt),
        lattice_scores_kernel(params["theta"], params["feats"], xt),
        ops.lattice_scores(params["theta"], params["feats"], xt),
    ):
        np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(tl, "_GROUP_ELEMS", x.shape[0] * (1 << (S - 1)) * 7)
    np.testing.assert_array_equal(tl.apply_lattice_scores(params, xt).numpy(), want)
    np.testing.assert_allclose(
        tl.apply_lattice(params, xt).numpy(), want.sum(axis=1), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "t0,t1,use_rows,n_valid",
    [(0, None, False, None), (4, 12, False, None), (3, 11, True, None),
     (3, 11, True, 60), (0, 20, True, 0), (5, 6, False, 100), (0, 20, True, 150)],
)
def test_lattice_scores_plain_hooks_match_jax(rw2, t0, t1, use_rows, n_valid):
    """t0/t1, the ``rows`` gather (with indices past the end clamped, as
    ``jnp.take`` clamps), and the block guard: row blocks at or past
    ``n_valid`` are 0, including a ragged last block."""
    rng = np.random.default_rng(9)
    T, S, block_n = 20, 4, 64
    theta = rng.normal(size=(T, 1 << S)).astype(np.float32)
    feats = np.stack([rng.choice(rw2.D, S, replace=False) for _ in range(T)]).astype(np.int32)
    x = rw2.x_test[:150]
    rows = None
    if use_rows:
        rows = rng.permutation(x.shape[0])[:120]
        rows[-5:] = x.shape[0] + 3  # past the end: clamps to the last row
    kw = dict(block_n=block_n, t0=t0, t1=t1, n_valid=n_valid,
              rows=None if rows is None else _t(rows))
    out = lattice_scores_plain(_t(theta), _t(feats), _t(x), **kw)
    assert torch.equal(out, lattice_scores_kernel(_t(theta), _t(feats), _t(x), **kw))
    xs = x if rows is None else x[np.minimum(rows, x.shape[0] - 1)]
    t1_ = T if t1 is None else t1
    want = np.asarray(j_ref.lattice_scores_ref(
        jnp.asarray(theta[t0:t1_]), jnp.asarray(feats[t0:t1_]), jnp.asarray(xs)
    ))
    if n_valid is not None:
        dead = np.arange(xs.shape[0]) // block_n * block_n >= n_valid
        want = np.where(dead[:, None], 0.0, want)
        assert n_valid >= xs.shape[0] or dead.any()
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_lattice_corners_return_theta_exactly(S):
    """At the cube's corners (inputs 0 and 1) the interpolation is the
    vertex value itself, bit for bit, MSB-first."""
    rng = np.random.default_rng(S)
    d = S + 2
    theta = rng.normal(size=(1, 1 << S)).astype(np.float32)
    feats = np.arange(S, dtype=np.int32)[None]
    corners = np.zeros((1 << S, d), np.float32)
    for c in range(1 << S):
        for j in range(S):
            corners[c, j] = (c >> (S - 1 - j)) & 1
    got = lattice_scores_plain(_t(theta), _t(feats), _t(corners), block_n=16)
    np.testing.assert_array_equal(got.numpy()[:, 0], theta[0])
    want = j_ref.lattice_scores_ref(jnp.asarray(theta), jnp.asarray(feats), jnp.asarray(corners))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adamw_update_matches_jax():
    from repro_torch.optim.adamw import adamw_init, adamw_update

    rng = np.random.default_rng(0)
    p = rng.normal(size=(30, 16)).astype(np.float32)
    state_j, state_t = j_adamw_init(jnp.asarray(p)), adamw_init(_t(p))
    pj, pt = jnp.asarray(p), _t(p)
    for _ in range(3):
        g = rng.normal(size=p.shape).astype(np.float32)
        pj, state_j = j_adamw_update(pj, jnp.asarray(g), state_j, lr=0.05, weight_decay=0.01)
        pt, state_t = adamw_update(pt, _t(g), state_t, lr=0.05, weight_decay=0.01)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-7)
        np.testing.assert_allclose(state_t.nu.numpy(), np.asarray(state_j.nu), rtol=0, atol=1e-7)
    assert int(state_t.step) == int(state_j.step) == 3


@pytest.mark.parametrize("mode", ["joint", "independent"])
def test_train_lattice_ensemble_matches_jax(rw2, mode):
    jp = jl.init_lattice_ensemble(24, rw2.D, 8, seed=1)
    want = jl.train_lattice_ensemble(jp, rw2.x_train, rw2.y_train, mode=mode, steps=20, batch=512)
    tp = lattice_params_from_numpy(np.asarray(jp["theta"]), np.asarray(jp["feats"]), "cpu")
    got = tl.train_lattice_ensemble(tp, rw2.x_train, rw2.y_train, mode=mode, steps=20, batch=512)
    np.testing.assert_allclose(got["theta"].numpy(), np.asarray(want["theta"]), rtol=0, atol=1e-4)
    assert not np.array_equal(got["theta"].numpy(), np.asarray(jp["theta"]))  # it trained
    assert torch.equal(got["feats"], tp["feats"])


@pytest.fixture(scope="module")
def trained(rw2):
    """exp4_rw2_joint's recipe at a small size: rw2 at scale 0.1, T = 24,
    S = 8, joint training in JAX, carried across to the port."""
    T = 24
    jp = jl.init_lattice_ensemble(T, rw2.D, 8, seed=0)
    jp = jl.train_lattice_ensemble(jp, rw2.x_train, rw2.y_train, mode="joint", steps=40)
    theta, feats = np.asarray(jp["theta"]), np.asarray(jp["feats"])
    F_tr = np.asarray(jl.apply_lattice_scores(jp, jnp.asarray(rw2.x_train))).astype(np.float64)
    fits = {
        mode: (j_fit(F_tr, beta=0.0, alpha=0.01, mode=mode),
               fit_qwyc(F_tr, beta=0.0, alpha=0.01, mode=mode))
        for mode in ("both", "neg_only")
    }
    return jp, theta, feats, fits


def _assert_same(a, b):
    np.testing.assert_array_equal(a.decisions, b.decisions)
    np.testing.assert_array_equal(a.exit_step, b.exit_step)
    np.testing.assert_array_equal(
        np.asarray(a.g_final, np.float32), np.asarray(b.g_final, np.float32)
    )
    assert [dataclasses.astuple(s) for s in a.chunk_stats] == [
        dataclasses.astuple(s) for s in b.chunk_stats
    ]
    assert a.scores_computed == b.scores_computed


@pytest.mark.parametrize("chunk_t", [4, 8])
@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_device_executor_lattice_matches_jax(rw2, trained, chunk_t, mode):
    """The port's lattice stage loop, fused (B4 lattice) and unfused (B5 +
    B2), against the JAX device loop over the ``lattice_scores_ref``
    ordered matrix: verdicts, f32 ``g_final`` and billing equal."""
    jp, theta, feats, fits = trained
    jm, m = fits[mode]
    F = np.asarray(j_ref.lattice_scores_ref(jp["theta"], jp["feats"], jnp.asarray(rw2.x_test)))
    ordered = F[:, jm.order]
    row_order = np.argsort(ordered[:, 0], kind="stable")
    n = F.shape[0]
    jplan = dataclasses.replace(JPlan.from_qwyc(jm, chunk_t=chunk_t), lead_t=1)
    jdplan = jde.DevicePlan.from_plan(jplan)
    jscorer = dataclasses.replace(jde.matrix_stage_scorer(jdplan), block_n=64)
    want = jde.DeviceExecutor(jdplan, jscorer, block_n=64, megakernel=False).run(
        ordered, n, row_order=row_order, capacity=256
    )
    plan = dataclasses.replace(CascadePlan.from_qwyc(m, chunk_t=chunk_t), lead_t=1)
    dplan = DevicePlan.from_plan(plan)
    scorer = lattice_stage_scorer(dplan, theta[m.order], feats[m.order], block_n=64, device="cpu")
    assert scorer.slabs.variant == "lattice"
    got = {}
    for mk in (None, False):
        ex = DeviceExecutor(dplan, scorer, block_n=64, megakernel=mk, device="cpu")
        assert ex.megakernel == (mk is None)
        got[mk] = ex.run(rw2.x_test, n, row_order=row_order, capacity=256)
        _assert_same(want, got[mk])
    ev = evaluate_cascade(m, F.astype(np.float64))
    np.testing.assert_array_equal(got[None].decisions, ev["decisions"])
    np.testing.assert_array_equal(got[None].exit_step, ev["exit_step"])
    assert 1 < len(want.chunk_stats) and (ev["exit_step"] < m.T).any()


def _serve(server, rows):
    for r in rows:
        server.submit(r)
    return server.drain()


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("policy", BACKENDS)
def test_lattice_server_matches_jax_host_server(rw2, trained, mode, policy):
    jp, theta, feats, fits = trained
    jsrv = JServer(
        fits[mode][0], score_fn=lambda x: jl.apply_lattice_scores(jp, jnp.asarray(x)),
        exec_backend="host", backend=policy, batch_size=128,
    )
    want = _serve(jsrv, rw2.x_test)
    params = lattice_params_from_numpy(theta, feats, device="cpu")
    srv = QWYCServer(
        fits[mode][1], scorer=LatticeScorer(params["theta"], params["feats"]),
        exec_backend="device", device="cpu", backend=policy, batch_size=128,
    )
    got = _serve(srv, rw2.x_test)
    assert [r["decision"] for r in got] == [r["decision"] for r in want]
    assert [r["models_evaluated"] for r in got] == [r["models_evaluated"] for r in want]
    assert srv.stats.mean_models == jsrv.stats.mean_models
    assert srv.stats.models_evaluated == jsrv.stats.models_evaluated
    pairs = [(a["full_score"], b["full_score"]) for a, b in zip(want, got) if "full_score" in a]
    assert (len(pairs) > 0) == (mode == "neg_only")
    assert all("full_score" in b for a, b in zip(want, got) if "full_score" in a)
    for a, b in pairs:
        assert abs(a - b) <= 1e-5 * abs(a)


def test_cli_serves_lattices_on_cpu(rw2, capsys):
    argv = ["--device", "cpu", "--dataset", "rw2", "--ensemble", "lattice", "--T", "12",
            "--scale", "0.1", "--alpha", "0.01", "--mode", "neg_only"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] dataset=rw2 train=800 test=200" in out
    assert "QWYC fit: train mean models" in out
    # the same numbers as a server driven directly with the CLI's setup
    lat = tl.init_lattice_ensemble(12, rw2.D, 8, seed=0, device="cpu")
    lat = tl.train_lattice_ensemble(lat, rw2.x_train, rw2.y_train, mode="joint", steps=300)
    F = tl.apply_lattice_scores(lat, torch.from_numpy(rw2.x_train)).numpy().astype(np.float64)
    m = fit_qwyc(F, beta=0.0, alpha=0.01, mode="neg_only")
    srv = QWYCServer(
        m, scorer=LatticeScorer(lat["theta"], lat["feats"], block_n=serve.SCORE_BLOCK_N),
        exec_backend="device", device="cpu",
    )
    _serve(srv, rw2.x_test)
    st = srv.stats
    assert f"mean models {st.mean_models:.2f}/12" in out
    assert f"scores computed {st.scores_computed}/{st.scores_possible}" in out
    assert "200 requests in 1 batches (device backend, sorted-kernel policy, lazy)" in out


def test_lattice_scorer_rejects_rows_narrower_than_its_features():
    """The kernels index x by the lattices' feature ids unchecked, so the
    scorer refuses rows with fewer features than the ensemble reads."""
    plan = CascadePlan(
        order=np.arange(4), eps_pos=np.full(4, np.inf), eps_neg=np.full(4, -np.inf),
        beta=0.0, costs=np.ones(4), chunk_t=2,
    )
    dplan = DevicePlan.from_plan(plan)
    feats = np.array([[0, 5], [1, 2], [3, 4], [2, 0]], dtype=np.int32)
    scorer = lattice_stage_scorer(dplan, np.zeros((4, 4), np.float32), feats, device="cpu")
    assert scorer.prepare(np.zeros((3, 6), np.float32)).shape == (3, 6)
    with pytest.raises(ValueError, match=r"\(n, >= 6\) feature rows"):
        scorer.prepare(np.zeros((3, 5), np.float32))
