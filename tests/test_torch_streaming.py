"""Streaming admission (continuous batching) of the PyTorch port against the
JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.  The
port's streaming loop, its lane decide (B6) and its mixed-stage step (B7)
give the JAX package's decisions, exit steps, admission and decision steps,
step counts, occupancy and billing exactly.  ``g_final`` is bit-identical
for matrix and tree ensembles (an exact select, then sequential f32 adds).

Lattices are the one tolerance.  The JAX lanes (``lane_fn`` and the lane
branch of ``mega_lane_pallas``) contract a lattice in corner-weight form,
``sum(w * theta)`` over the 2^S vertices, while every lattice evaluator of
the port contracts dimension by dimension (``ensembles.lattice.interpolate``
and ``csrc/lattice.cuh``).  Both round each operation in f32, in another
order, so the port's lattice ``g_final`` is held to ``_lattice_bound`` of
the JAX one, and bit for bit to the port's own batch path and to a
dimension-order expectation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.api.scorers import LatticeScorer as JLatticeScorer
from repro.api.scorers import TreeScorer as JTreeScorer
from repro.core import CascadePlan as JPlan
from repro.core import fit_qwyc as j_fit
from repro.kernels import device_executor as jde
from repro.kernels import megakernel as jmk
from repro.kernels.cascade_kernel import cascade_lane_pallas
from repro.serving.engine import StreamingServer as JStreamingServer
from repro_torch.api.scorers import LatticeScorer, TreeScorer
from repro_torch.convert import qwyc_model_from_numpy
from repro_torch.core import CascadePlan, evaluate_cascade
from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.ensembles.lattice import apply_lattice_scores
from repro_torch.kernels import _build
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.cascade_kernel import (
    cascade_lane_kernel,
    cascade_lane_plain,
    threshold_step,
)
from repro_torch.kernels.device_executor import (
    STREAM_BURST,
    DeviceExecutor,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    stream_occupancy,
    tree_stage_scorer,
)
from repro_torch.launch import serve
from repro_torch.serving.engine import StreamingServer

F32_ULP = 2.0**-23


def _t(a):
    return torch.from_numpy(np.array(a))


def _poisson_steps(rng, n, rate):
    """Nondecreasing integer arrival steps from a Poisson trace."""
    return np.floor(np.cumsum(rng.exponential(1.0 / rate, size=n))).astype(np.int32)


def _lattice_bound(exit_step, theta, S):
    """Per-row bound on |g_port - g_jax| for lattice lanes.

    Form: exit_step x c x 2^-23 x scale.
    * scale = sum over all T lattices of max |theta|: a lattice's score is
      a convex combination of its vertex values (inputs in [0, 1]), so
      every score, and every partial sum g, is at most ``scale`` in size.
    * c = 2^S + 4 S + 2.  Per position, the corner-weight form rounds S - 1
      products per weight, one product with theta and 2^S - 1 adds: within
      (2^S + S) u of the exact interpolant; the dimension-order form rounds
      three times per halving, S halvings: within 3 S u (u = 2^-24,
      first order, relative to ``scale``).  The two adds into g (one per
      form) each round within u of ``scale``.  That sums to
      (2^S + 4 S + 2) u per position; counting it in units of 2^-23 = 2u
      leaves a factor of two for the second-order terms.
    Positions past a row's exit add nothing, so the bound grows with
    exit_step, the positions the row walked.
    """
    scale = float(np.abs(theta).max(axis=1).sum())
    c = 2**S + 4 * S + 2
    return np.asarray(exit_step, np.float64) * c * F32_ULP * scale


def _port_model(jm):
    return qwyc_model_from_numpy(
        jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha, jm.mode
    )


# -- fixtures: one small ensemble of each kind, fitted in both modes --------


@pytest.fixture(scope="module")
def ensembles():
    rng = np.random.default_rng(61)
    n = 150
    out = {}
    # matrix: a precomputed score matrix
    F = make_scores(rng, n=n, t=24)
    out["matrix"] = dict(F=F, x=None)
    # tree: 24 oblivious trees of depth 3 over 8 features
    t, depth, d = 24, 3, 8
    feats = rng.integers(0, d, size=(t, depth)).astype(np.int32)
    thrs = rng.uniform(size=(t, depth)).astype(np.float32)
    leaves = rng.normal(size=(t, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    params = {"feats": _t(feats), "thrs": _t(thrs), "leaves": _t(leaves)}
    F = apply_gbt_scores(params, _t(x)).numpy().astype(np.float64)
    out["tree"] = dict(F=F, x=x, feats=feats, thrs=thrs, leaves=leaves)
    # lattice: 18 lattices over S = 4 of 6 features
    t, S, D = 18, 4, 6
    lf = np.stack([rng.choice(D, S, replace=False) for _ in range(t)]).astype(np.int32)
    theta = rng.normal(scale=0.5, size=(t, 1 << S)).astype(np.float32)
    x = rng.uniform(size=(n, D)).astype(np.float32)
    F = apply_lattice_scores({"feats": _t(lf), "theta": _t(theta)}, _t(x))
    out["lattice"] = dict(F=F.numpy().astype(np.float64), x=x, feats=lf, theta=theta, S=S)
    for case in out.values():
        case["fits"] = {
            mode: j_fit(case["F"], beta=0.0, alpha=0.02, mode=mode)
            for mode in ("both", "neg_only")
        }
    return out


def _operand(variant, case, order):
    """What both packages' scorers ``prepare``: the ordered score matrix or
    the feature rows."""
    return case["F"][:, order].astype(np.float32) if variant == "matrix" else case["x"]


def _port_scorer(variant, case, dplan, order):
    if variant == "matrix":
        return matrix_stage_scorer(dplan, device="cpu")
    if variant == "tree":
        p = [case[k][order] for k in ("feats", "thrs", "leaves")]
        return tree_stage_scorer(dplan, *p, block_n=32, device="cpu")
    p = [case["theta"][order], case["feats"][order]]
    return lattice_stage_scorer(dplan, *p, block_n=32, device="cpu")


def _jax_scorer(variant, case, jdplan, order):
    if variant == "matrix":
        return jde.matrix_stage_scorer(jdplan)
    if variant == "tree":
        p = [case[k][order] for k in ("feats", "thrs", "leaves")]
        return jde.tree_stage_scorer(jdplan, *p, block_n=32)
    p = [case["theta"][order], case["feats"][order]]
    return jde.lattice_stage_scorer(jdplan, *p, block_n=32)


# -- stream_occupancy ----------------------------------------------------


@pytest.mark.parametrize("steps_run", [0, 1, 9, 40])
def test_stream_occupancy_matches_jax(steps_run):
    rng = np.random.default_rng(steps_run)
    if steps_run:
        admit = rng.integers(0, steps_run, size=50)
        done = np.minimum(admit + rng.integers(0, 6, size=50), steps_run - 1)
    else:
        admit = done = np.zeros(0, dtype=np.int64)
    want = jde.stream_occupancy(admit, done, steps_run)
    got = stream_occupancy(admit, done, steps_run)
    assert got.dtype == np.int64 and got.shape == (steps_run,)
    np.testing.assert_array_equal(got, want)
    if steps_run:
        assert got.sum() == (done - admit + 1).sum()


# -- B6: the lane decide --------------------------------------------------


@pytest.mark.parametrize("n_valid", [None, 0, 77, 200])
def test_cascade_lane_plain_bit_identical_to_pallas(n_valid):
    """B6's plain version against ``cascade_lane_pallas`` in interpret
    mode: per-lane threshold rows (lanes at different stages, ±inf padded
    columns of a ragged stage), relative exits, rows past n_valid inert."""
    rng = np.random.default_rng(5 if n_valid is None else n_valid)
    m, ct = 200, 8
    g0 = rng.normal(size=m).astype(np.float32)
    s = rng.normal(size=(m, ct)).astype(np.float32)
    ep = rng.uniform(0.5, 3.0, size=(m, ct)).astype(np.float32)
    en = -rng.uniform(0.5, 3.0, size=(m, ct)).astype(np.float32)
    ragged = rng.random(m) < 0.3  # lanes on a ragged last stage of width 5
    ep[ragged, 5:], en[ragged, 5:], s[ragged, 5:] = np.inf, -np.inf, 0.0
    nv = None if n_valid is None else jnp.int32(n_valid)
    want = cascade_lane_pallas(
        jnp.asarray(g0), jnp.asarray(s), jnp.asarray(ep), jnp.asarray(en),
        block_n=64, interpret=True, n_valid=nv,
    )
    nv_t = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32)
    _build.LAUNCHES.clear()
    got = cascade_lane_kernel(_t(g0), _t(s), _t(ep), _t(en), block_n=64, n_valid=nv_t)
    assert sum(_build.LAUNCHES.values()) == 0  # a CPU tensor launches nothing
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got, cascade_lane_plain(_t(g0), _t(s), _t(ep), _t(en), nv_t)):
        assert torch.equal(a, b)
    live = m if n_valid is None else n_valid
    assert (got[3][live:] == 0).all() and (got[1][live:] == 0).all()
    if live:
        assert (got[3][:live] > 0).any() and (got[3][:live] == 0).any()


# -- B7: the mixed-stage step ----------------------------------------------


def _lane_inputs(variant, seed=0, n_valid=200):
    """A random plan (S 9 stages of W 4, a ragged last stage), its slabs
    in both packages, and one mixed-stage buffer: lanes spread over every
    stage, last-stage (stop) lanes, trash lanes past n_valid, cap 256 in
    blocks of 64."""
    rng = np.random.default_rng(seed)
    T, W = 34, 4
    plan = JPlan(
        order=np.arange(T), eps_pos=rng.uniform(0.4, 2.0, size=T),
        eps_neg=-rng.uniform(0.4, 2.0, size=T), beta=0.0, costs=np.ones(T),
        chunk_t=W,
    )
    jdplan = jde.DevicePlan.from_plan(plan)
    pplan = CascadePlan(
        order=plan.order, eps_pos=plan.eps_pos, eps_neg=plan.eps_neg, beta=0.0,
        costs=plan.costs, chunk_t=W,
    )
    dplan = DevicePlan.from_plan(pplan)
    S = dplan.S
    assert S == 9 and dplan.widths[-1] == 2
    cap, n_rows = 256, 300
    d = 7
    case = {}
    if variant == "matrix":
        x = rng.normal(scale=0.6, size=(n_rows, dplan.T_pad)).astype(np.float32)
        jslabs = jmk.build_matrix_slabs(jdplan, quant="f32")
        slabs = mk.build_matrix_slabs(dplan, device="cpu")
    elif variant == "tree":
        depth = 3
        case = dict(
            feats=rng.integers(0, d, size=(T, depth)).astype(np.int32),
            thrs=rng.uniform(size=(T, depth)).astype(np.float32),
            leaves=rng.normal(scale=0.6, size=(T, 1 << depth)).astype(np.float32),
        )
        x = rng.uniform(size=(n_rows, d)).astype(np.float32)
        jslabs = jmk.build_tree_slabs(
            jdplan, case["feats"], case["thrs"], case["leaves"], quant="f32"
        )
        slabs = mk.build_tree_slabs(
            dplan, case["feats"], case["thrs"], case["leaves"], device="cpu"
        )
    else:
        Sl = 4
        case = dict(
            feats=np.stack([rng.choice(d, Sl, replace=False) for _ in range(T)]).astype(np.int32),
            theta=rng.normal(scale=0.6, size=(T, 1 << Sl)).astype(np.float32),
        )
        x = rng.uniform(size=(n_rows, d)).astype(np.float32)
        x[:20] = np.round(x[:20])  # corners
        jslabs = jmk.build_lattice_slabs(jdplan, case["theta"], case["feats"], quant="f32")
        slabs = mk.build_lattice_slabs(dplan, case["theta"], case["feats"], device="cpu")
    stage = rng.integers(0, S, size=cap).astype(np.int32)
    stage[:S] = np.arange(S)  # every stage in the first block
    rows = rng.permutation(n_rows)[:cap].astype(np.int64)
    rows[n_valid:] = n_rows - 1
    g0 = rng.normal(scale=0.5, size=cap).astype(np.float32)
    return dict(
        plan=plan, jdplan=jdplan, dplan=dplan, jslabs=jslabs, slabs=slabs, x=x,
        stage=stage, stop=stage >= S - 1, rows=rows, g0=g0, n_valid=n_valid, **case,
    )


def _jax_mega_lane(c):
    jd = c["jdplan"]
    x, rows, stage = c["x"], c["rows"], c["stage"]
    xr = x[rows]
    if c["slabs"].variant == "matrix":
        idx = jd.stage_t0[stage][:, None] + np.arange(jd.W)[None, :]
        xr = np.take_along_axis(xr, idx, axis=1)
    return jmk.mega_lane_pallas(
        c["jslabs"], jnp.asarray(xr), jmk.gather_lane_slabs(c["jslabs"], jnp.asarray(stage)),
        jnp.asarray(c["g0"]), jnp.asarray(jd.eps_pos[stage]), jnp.asarray(jd.eps_neg[stage]),
        jnp.asarray(c["stop"]), jnp.int32(c["n_valid"]), block_n=64, interpret=True,
    )


def _port_mega_lane(c, fn=mk.mega_lane):
    dp = c["dplan"]
    return fn(
        c["slabs"], _t(c["x"]), _t(c["rows"]), _t(c["g0"]), _t(c["stage"]),
        _t(c["stop"]), torch.tensor(c["n_valid"], dtype=torch.int32),
        _t(dp.eps_pos), _t(dp.eps_neg), block_n=64,
    )


@pytest.mark.parametrize("n_valid", [0, 100, 200, 256])
@pytest.mark.parametrize("variant", ["matrix", "tree"])
def test_mega_lane_plain_bit_identical_to_pallas(variant, n_valid):
    """B7's plain version (matrix and tree lanes) against
    ``mega_lane_pallas`` in interpret mode, all six outputs exactly: stop
    lanes out of the pack, rows retiring mid-block, n_valid 0."""
    c = _lane_inputs(variant, seed=n_valid, n_valid=n_valid)
    want = _jax_mega_lane(c)
    _build.LAUNCHES.clear()
    got = _port_mega_lane(c)
    assert sum(_build.LAUNCHES.values()) == 0
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"output {k}")
    act, ex, pack = got[1].numpy(), got[3].numpy(), got[4].numpy()
    if n_valid:
        assert (ex[:n_valid] > 0).any() and (act[:n_valid] == 1).any()
        assert (pack[c["stop"] & (act == 1)] == 256).all()
        assert (act[c["stop"]] == 1).any()  # some stop lanes ran out active
    else:
        assert (act == 0).all() and int(got[5]) == 0


def _expected_lattice_lanes(c):
    """The dimension-order expectation of B7's lattice lanes: each lane's
    W scores by the port's batch evaluator (``apply_lattice_scores``) on
    its stage's lattices, walked with its own threshold row."""
    dp = c["dplan"]
    cap = c["g0"].shape[0]
    nv = c["n_valid"]
    g = _t(c["g0"]).clone()
    act = torch.arange(cap) < nv
    dec = torch.zeros(cap, dtype=torch.bool)
    ex = torch.zeros(cap, dtype=torch.int32)
    scores = torch.zeros(cap, dp.W)
    for i in range(cap):
        s = int(c["stage"][i])
        t0, t1 = c["plan"].stages[s]
        params = {"feats": _t(c["feats"][t0:t1]), "theta": _t(c["theta"][t0:t1])}
        scores[i, : t1 - t0] = apply_lattice_scores(params, _t(c["x"][c["rows"][i : i + 1]]))[0]
    ep, en = _t(dp.eps_pos[c["stage"]]), _t(dp.eps_neg[c["stage"]])
    for j in range(dp.W):
        g, act, dec, ex = threshold_step(g, act, dec, ex, scores[:, j], ep[:, j], en[:, j], j + 1)
    return g, act, dec, ex


@pytest.mark.parametrize("n_valid", [0, 100, 256])
def test_mega_lane_plain_lattice(n_valid):
    """B7's lattice lanes: against ``mega_lane_pallas`` the verdicts, exits
    and pack equal and ``g`` within ``_lattice_bound``; against the port's
    own dimension-order expectation, bit for bit."""
    c = _lane_inputs("lattice", seed=7 + n_valid, n_valid=n_valid)
    want = _jax_mega_lane(c)
    got = _port_mega_lane(c)
    for k in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"output {k}")
    # W positions walked at most in this one step
    bound = _lattice_bound(np.full(256, c["dplan"].W), c["theta"], 4)
    err = np.abs(got[0].numpy().astype(np.float64) - np.asarray(want[0], np.float64))
    assert (err <= bound).all(), err.max()
    g, act, dec, ex = _expected_lattice_lanes(c)
    live = torch.arange(256) // 64 * 64 < n_valid
    assert torch.equal(got[0], torch.where(live, g, _t(c["g0"])))
    assert torch.equal(got[1], act.to(torch.int32))
    assert torch.equal(got[2], dec.to(torch.int32))
    assert torch.equal(got[3], ex)
    if n_valid:
        assert (ex[:n_valid] > 0).any() and (act[:n_valid]).any()


def test_mega_lane_kernel_raw_outputs_exclude_stop_lanes():
    """The raw block outputs: the prefix and the block counts count the
    lanes that stay active and are not on their last stage."""
    c = _lane_inputs("tree", seed=3, n_valid=256)
    g, act, dec, ex, pfx, cnt = _port_mega_lane(c, fn=mk.mega_lane_kernel)
    keep = (act.numpy() == 1) & ~c["stop"]
    np.testing.assert_array_equal(cnt.numpy(), keep.reshape(4, 64).sum(axis=1))
    want_pfx = np.cumsum(keep.reshape(4, 64), axis=1).reshape(-1) - 1
    np.testing.assert_array_equal(pfx.numpy(), want_pfx)


# -- the streaming loop -----------------------------------------------------


def _assert_stream_equal(a, b, g=True):
    for k in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.steps_run == b.steps_run
    assert a.capacity == b.capacity
    assert a.scores_computed == b.scores_computed
    assert a.scores_possible == b.scores_possible
    if g:
        np.testing.assert_array_equal(
            np.asarray(a.g_final, np.float32), np.asarray(b.g_final, np.float32)
        )


# (arrivals rate or None, capacity, ring capacity): everyone waiting with
# capacity below n; a Poisson trace with a ring larger than n
SCENARIOS = [(None, 64, None), (16.0, 32, 256)]


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("variant", ["matrix", "tree", "lattice"])
def test_run_stream_matches_jax(ensembles, variant, megakernel, mode):
    """The port's ``run_stream`` (B7 fused, or ``lane_fn`` + B6) against
    JAX's ``run_stream`` with the same megakernel setting: verdicts, exit,
    admission and decision steps, steps run, occupancy and billing equal;
    ``g_final`` bit-identical (matrix, tree) or within ``_lattice_bound``
    (lattice).  The port's streaming ``g_final`` also equals its own batch
    path's bit for bit, and decisions equal ``evaluate_cascade``."""
    case = ensembles[variant]
    jm = case["fits"][mode]
    m = _port_model(jm)
    n = case["F"].shape[0]
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=4))
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    jscorer = _jax_scorer(variant, case, jdplan, jm.order)
    scorer = _port_scorer(variant, case, dplan, jm.order)
    x = _operand(variant, case, jm.order)
    jex = jde.DeviceExecutor(jdplan, jscorer, block_n=32, megakernel=megakernel)
    ex = DeviceExecutor(dplan, scorer, block_n=32, megakernel=megakernel, device="cpu")
    assert ex.megakernel == megakernel
    ev = evaluate_cascade(m, case["F"])
    batch = ex.run(x, n)
    rng = np.random.default_rng(62)
    for rate, cap, ring in SCENARIOS:
        arr = None if rate is None else _poisson_steps(rng, n, rate)
        want = jex.run_stream(x, n, arrivals=arr, capacity=cap, ring_capacity=ring)
        got = ex.run_stream(x, n, arrivals=arr, capacity=cap, ring_capacity=ring)
        _assert_stream_equal(got, want, g=variant != "lattice")
        if variant == "lattice":
            err = np.abs(got.g_final.astype(np.float64) - np.asarray(want.g_final, np.float64))
            bound = _lattice_bound(got.exit_step, case["theta"], case["S"])
            assert (err <= bound).all(), (err.max(), bound.min())
        np.testing.assert_array_equal(got.decisions, ev["decisions"])
        np.testing.assert_array_equal(got.exit_step, ev["exit_step"])
        np.testing.assert_array_equal(got.g_final, batch.g_final)
        if arr is not None:
            assert (got.admit_step >= arr).all()
        assert got.occupancy.sum() == got.latency_steps.sum()
        assert got.steps_run == got.done_step.max() + 1
        assert got.steps_run <= got.steps_enqueued < got.steps_run + STREAM_BURST
        assert got.syncs >= 2
        assert got.occupancy.max() <= got.capacity
        # rows exited early, and lanes were refilled mid-run
        assert (got.exit_step < m.T).any() and (got.admit_step > 0).any()


@pytest.mark.parametrize("variant", ["matrix", "tree", "lattice"])
def test_run_stream_fused_equals_unfused(ensembles, variant):
    """Fused (B7) and unfused (``lane_fn`` + B6) streaming, bit for bit in
    every field, at a capacity that keeps the lanes full."""
    case = ensembles[variant]
    jm = case["fits"]["neg_only"]
    m = _port_model(jm)
    n = case["F"].shape[0]
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=8))
    scorer = _port_scorer(variant, case, dplan, jm.order)
    x = _operand(variant, case, jm.order)
    arr = _poisson_steps(np.random.default_rng(3), n, 40.0)
    res = {}
    for mkl in (True, False):
        ex = DeviceExecutor(dplan, scorer, block_n=32, megakernel=mkl, device="cpu")
        res[mkl] = ex.run_stream(x, n, arrivals=arr, capacity=32)
    _assert_stream_equal(res[True], res[False])
    assert res[True].steps_enqueued == res[False].steps_enqueued
    assert res[True].syncs == res[False].syncs
    assert res[True].mean_occupancy > 0.5


def test_run_stream_edges(ensembles):
    case = ensembles["matrix"]
    jm = case["fits"]["both"]
    m = _port_model(jm)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    scorer = matrix_stage_scorer(dplan, device="cpu")
    ex = DeviceExecutor(dplan, scorer, block_n=32, device="cpu")
    x = case["F"][:, jm.order].astype(np.float32)
    res = ex.run_stream(x[:0], 0)
    assert res.decisions.shape == (0,) and res.steps_run == 0 and res.mean_occupancy == 0.0
    with pytest.raises(ValueError, match="nondecreasing"):
        ex.run_stream(x[:3], 3, arrivals=[0, 2, 1])
    no_lane = dataclasses.replace(scorer, lane_fn=None)
    with pytest.raises(ValueError, match="lane_fn"):
        DeviceExecutor(dplan, no_lane, megakernel=False, device="cpu").run_stream(x, 10)
    # slabs without lane_fn: streaming runs through B7
    res = DeviceExecutor(dplan, no_lane, block_n=32, device="cpu").run_stream(x, 40)
    np.testing.assert_array_equal(res.exit_step, evaluate_cascade(m, case["F"][:40])["exit_step"])
    # one row arriving late: the loop idles until it comes
    res = ex.run_stream(x[:1], 1, arrivals=[30])
    assert res.admit_step.tolist() == [30] and res.steps_run == res.done_step[0] + 1
    assert res.occupancy[:30].sum() == 0 and res.steps_enqueued >= 31


# -- StreamingServer --------------------------------------------------------


def _stream_serve(srv, X, arrivals):
    for i in range(X.shape[0]):
        srv.submit(X[i], arrival=arrivals[i])
    return srv.drain()


def _assert_servers_equal(got_srv, got, want_srv, want):
    assert [r["decision"] for r in got] == [r["decision"] for r in want]
    assert [r["models_evaluated"] for r in got] == [r["models_evaluated"] for r in want]
    a, b = got_srv.stats, want_srv.stats
    for k in ("n_requests", "n_batches", "models_evaluated", "scores_computed",
              "scores_possible", "admitted_rows", "stream_steps", "stream_slot_steps",
              "stream_cap_steps", "latency_steps"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.mean_occupancy == b.mean_occupancy
    assert a.latency_p99 == b.latency_p99 and a.latency_mean == b.latency_mean
    assert len(got_srv.stream_results) == len(want_srv.stream_results)


@pytest.mark.parametrize("mode", ["both", "neg_only"])
@pytest.mark.parametrize("variant", ["tree", "lattice"])
def test_streaming_server_matches_jax(ensembles, variant, mode):
    """``StreamingServer`` under a seeded Poisson trace against JAX's, the
    JAX server held on its device rung (a silent fall to the host would
    pass as parity otherwise): results and every streaming stat equal."""
    case = ensembles[variant]
    jm = case["fits"][mode]
    m = _port_model(jm)
    if variant == "tree":
        p = [case[k] for k in ("feats", "thrs", "leaves")]
        jsc, sc = JTreeScorer(*p, block_n=32), TreeScorer(*p, block_n=32)
    else:
        p = [case["theta"], case["feats"]]
        jsc, sc = JLatticeScorer(*p, block_n=32), LatticeScorer(*p, block_n=32)
    kw = dict(batch_size=32, window=64, chunk_t=4, block_n=32)
    jsrv = JStreamingServer(jm, scorer=jsc, exec_backend="device", **kw)
    srv = StreamingServer(m, scorer=sc, exec_backend="device", device="cpu", **kw)
    X = case["x"]
    arrivals = _poisson_steps(np.random.default_rng(66), X.shape[0], 16.0).astype(float)
    want = _stream_serve(jsrv, X, arrivals)
    got = _stream_serve(srv, X, arrivals)
    assert jsrv.exec.name == "device"
    assert srv.stats.n_batches == 3 and len(got) == X.shape[0]
    _assert_servers_equal(srv, got, jsrv, want)
    for a, b in zip(srv.stream_results, jsrv.stream_results):
        np.testing.assert_array_equal(a.done_step, b.done_step)
    if mode == "neg_only":
        fs = [(r["full_score"], w["full_score"]) for r, w in zip(got, want) if r["decision"]]
        assert fs and all("full_score" in w for r, w in zip(got, want) if r["decision"])
        if variant == "tree":
            assert all(a == b for a, b in fs)
        else:
            assert all(abs(a - b) <= 1e-4 for a, b in fs)
    ev = evaluate_cascade(m, case["F"])
    assert [r["decision"] for r in got] == ev["decisions"].tolist()


def test_streaming_server_max_wait_partial_waves(ensembles):
    """The admission deadline launches partial waves; the eager score_fn
    path (matrix lanes) equals JAX's."""
    case = ensembles["tree"]
    jm = case["fits"]["both"]
    m = _port_model(jm)
    params = {k: _t(case[k]) for k in ("feats", "thrs", "leaves")}

    def score_fn(x):
        return apply_gbt_scores(params, torch.as_tensor(np.asarray(x)))

    def jscore_fn(x):
        return score_fn(x).numpy()

    kw = dict(batch_size=16, window=512, max_wait=4.0, chunk_t=4)
    jsrv = JStreamingServer(jm, score_fn=jscore_fn, exec_backend="device", **kw)
    srv = StreamingServer(m, score_fn=score_fn, exec_backend="device", device="cpu", **kw)
    X = case["x"][:60]
    arrivals = np.arange(60, dtype=float)  # 1 step apart: a breach every 4
    want = _stream_serve(jsrv, X, arrivals)
    got = _stream_serve(srv, X, arrivals)
    assert jsrv.exec.name == "device"
    assert srv.stats.n_batches >= 5  # the deadline fired, the window never filled
    _assert_servers_equal(srv, got, jsrv, want)
    assert srv._dev[2] is True  # the eager matrix operand
    assert srv.stats.scores_computed == 60 * m.T


def test_streaming_server_interleaved_submit_flush_drain(ensembles):
    case = ensembles["lattice"]
    jm = case["fits"]["neg_only"]
    m = _port_model(jm)
    p = [case["theta"], case["feats"]]
    kw = dict(batch_size=32, window=64, chunk_t=4, block_n=32)
    jsrv = JStreamingServer(jm, scorer=JLatticeScorer(*p, block_n=32), exec_backend="device", **kw)
    srv = StreamingServer(m, scorer=LatticeScorer(*p, block_n=32), exec_backend="device",
                          device="cpu", **kw)
    X = case["x"]
    outs = []
    for s in (jsrv, srv):
        assert s.drain() == [] and s.stats.n_batches == 0
        for i in range(10):
            s.submit(X[i], arrival=float(i))
        first = s.flush()  # explicit partial wave
        for i in range(10, 90):
            s.submit(X[i], arrival=float(i // 3 + 10))
        mid = s.flush()
        for i in range(90, 150):
            s.submit(X[i])  # default: the last stamp seen
        outs.append((len(first), len(mid), s.drain()))
        assert s.drain() == []
    (jf, jm_, want), (f, mid, got) = outs
    assert (f, mid) == (jf, jm_) == (10, 16)
    assert len(got) == 150
    _assert_servers_equal(srv, got, jsrv, want)


def test_streaming_server_validation(ensembles):
    case = ensembles["tree"]
    m = _port_model(case["fits"]["both"])
    sc = TreeScorer(case["feats"], case["thrs"], case["leaves"])
    with pytest.raises(ValueError, match="sorting policy"):
        StreamingServer(m, scorer=sc, backend="sorted-kernel", device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        StreamingServer(m, score_fn=lambda x: x, exec_backend="host", device="cpu")
    with pytest.raises(ValueError, match="window"):
        StreamingServer(m, scorer=sc, batch_size=64, window=32, device="cpu")
    srv = StreamingServer(m, scorer=sc, batch_size=16, device="cpu")
    assert srv.window == 64 and srv.exec.name == "device"
    srv.submit(case["x"][0], arrival=5.0)
    with pytest.raises(ValueError, match="nondecreasing"):
        srv.submit(case["x"][1], arrival=1.0)
    assert len(srv.drain()) == 1 and not srv._squeue


# -- the CLI ------------------------------------------------------------------


def test_cli_streams_on_cpu(capsys):
    argv = ["--device", "cpu", "--T", "24", "--scale", "0.1", "--alpha", "0.01",
            "--streaming", "--arrival-rate", "16", "--batch-size", "64"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] streaming: 200 admitted over " in out
    assert "200 requests in 1 batches (device backend, streaming, lazy)" in out
    assert "latency (steps) mean " in out
    serve.main(argv + ["--stream-window", "64", "--max-wait", "3"])
    out2 = capsys.readouterr().out
    assert "(max_wait=3.0)" in out2 and "200 admitted" in out2
    # the same decision metrics: streaming does not change a verdict
    line = [ln for ln in out.splitlines() if "mean models" in ln][0]
    assert line in out2
    with pytest.raises(SystemExit):
        serve.main(argv + ["--backend", "host"])


# -- the compiled-program contract: one streaming program per ring geometry --


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("variant", ["matrix", "tree", "lattice"])
def test_stream_waves_share_one_trace_like_jax(ensembles, variant, megakernel):
    """The reference's ``test_megakernel.py:226``: waves with different
    arrival traces at one shape share one trace, in both packages; a new
    lane capacity is a second program.  Every wave equals JAX's, and the
    port enqueues whole bursts (the first sync after the last arrival)."""
    case = ensembles[variant]
    jm = case["fits"]["both"]
    m = _port_model(jm)
    n = case["F"].shape[0]
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=4))
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    jex = jde.DeviceExecutor(jdplan, _jax_scorer(variant, case, jdplan, jm.order),
                             block_n=32, megakernel=megakernel)
    ex = DeviceExecutor(dplan, _port_scorer(variant, case, dplan, jm.order), block_n=32,
                        megakernel=megakernel, device="cpu")
    x = _operand(variant, case, jm.order)
    for seed, hi in ((0, 12), (1, 12), (2, 40)):
        arr = np.sort(np.random.default_rng(seed).integers(0, hi, size=n)).astype(np.int32)
        want = jex.run_stream(x, n, arrivals=arr, capacity=64)
        got = ex.run_stream(x, n, arrivals=arr, capacity=64)
        _assert_stream_equal(got, want, g=variant != "lattice")
        assert got.steps_enqueued % STREAM_BURST == 0
        assert got.steps_enqueued >= arr[-1] + 1
    assert ex.traces == jex.traces == 1
    arr = np.zeros(n, dtype=np.int32)
    _assert_stream_equal(ex.run_stream(x, n, arrivals=arr, capacity=32),
                         jex.run_stream(x, n, arrivals=arr, capacity=32),
                         g=variant != "lattice")
    assert ex.traces == jex.traces == 2


def test_streaming_server_one_trace_like_jax(ensembles):
    """A server's waves (two full windows and a partial one) share one
    program: the port's executor counts what JAX's counts."""
    case = ensembles["tree"]
    jm = case["fits"]["both"]
    m = _port_model(jm)
    p = [case[k] for k in ("feats", "thrs", "leaves")]
    kw = dict(batch_size=32, window=64, chunk_t=4, block_n=32)
    jsrv = JStreamingServer(jm, scorer=JTreeScorer(*p, block_n=32), exec_backend="device", **kw)
    srv = StreamingServer(m, scorer=TreeScorer(*p, block_n=32), exec_backend="device",
                          device="cpu", **kw)
    X = case["x"]
    arrivals = _poisson_steps(np.random.default_rng(66), X.shape[0], 16.0).astype(float)
    _assert_servers_equal(srv, _stream_serve(srv, X, arrivals), jsrv,
                          _stream_serve(jsrv, X, arrivals))
    assert srv.stats.n_batches == 3
    assert srv._dev[0].traces == jsrv._dev[0].traces == 1
