"""Quantised parameter slabs (bf16, int8) of the PyTorch port against the
JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:

* Slabs (payload, per-stage ``scale``, ``eps_position``), the tolerance
  oracle's helpers and every trees and matrix result: bit for bit.
* Lattice ``g`` against any JAX lane-mode result (``mega_lane_pallas``,
  ``run_stream``): within ``_lattice_bound``, ROADMAP C4's bound, because
  JAX's lane kernel contracts a lattice in corner-weight form and the port
  dimension by dimension.  Verdicts, exits and billing are equal there too.

B4 has no runnable JAX kernel at quantised slabs (``pl.load`` is gone, C1),
so its plain version is held against ``mega_lane_pallas`` fed what B4 sees:
every lane at one stage, none flagged ``stop``.  The port's batch
``run(megakernel=True)`` is then held to its own ``run_stream`` bit for bit
and to ``run(megakernel=False)`` under ``check_parity``.
"""

import json
import types
from pathlib import Path

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
from repro.serving.engine import StreamingServer as JStreamingServer
from repro_torch.api.scorers import LatticeScorer, TreeScorer
from repro_torch.convert import param_slabs_from_numpy, qwyc_model_from_numpy
from repro_torch.core import CascadePlan, fit_qwyc
from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.ensembles.lattice import apply_lattice_scores
from repro_torch.kernels import _build
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.serving.engine import QWYCServer, StreamingServer

F32_ULP = 2.0**-23
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / "results" / "baseline_billing.json"
# (variant, quant) pairs the slabs support: int8 matrix slabs are refused
CASES = [("tree", "bf16"), ("tree", "int8"), ("lattice", "bf16"), ("lattice", "int8"),
         ("matrix", "bf16")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _lattice_bound(exit_step, theta, S, g_scale=0.0):
    """ROADMAP C4's bound on |g_port - g_jax| for lattice lanes: exit_step
    x (2^S + 4 S + 2) x 2^-23 x scale, scale = ``g_scale`` (the partial
    sums' start) + the sum over lattices of max |theta| (every score is a
    convex combination of its vertex values).  See
    ``tests/test_torch_streaming.py::_lattice_bound``."""
    scale = g_scale + float(np.abs(theta).max(axis=1).sum())
    return np.asarray(exit_step, np.float64) * (2**S + 4 * S + 2) * F32_ULP * scale


def _port_model(jm):
    return qwyc_model_from_numpy(
        jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha, jm.mode
    )


def _grid(rng, quant, shape):
    """Payloads already on the quantisation grid, as in
    ``tests/test_megakernel.py::_representable``: bf16-rounded normals, or
    int8 multiples of a power-of-two scale with every model's slab max
    pinned to 127 of them (so each stage's computed scale is exactly it)."""
    if quant == "bf16":
        v = rng.normal(size=shape).astype(np.float32)
        return np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
    sc = 2.0**-7
    v = (rng.integers(-127, 128, size=shape) * sc).astype(np.float32)
    v[:, 0] = 127 * sc
    return v


# -- fixtures: one small ensemble of each kind, fitted once ---------------


def _ensemble(variant, rng, grid_quant=None, n=150):
    """Params (ORIGINAL order), operand and score matrix of a small
    ensemble: 16 depth-3 trees over 8 features, 18 lattices over S = 4 of 6
    features, or a (n, 24) score matrix.  ``grid_quant`` puts the payload
    on that quantisation grid."""
    if variant == "matrix":
        F = make_scores(rng, n=n, t=24)
        return dict(F=F, x=None)
    if variant == "tree":
        t, depth, d = 16, 3, 8
        feats = rng.integers(0, d, size=(t, depth)).astype(np.int32)
        thrs = rng.uniform(size=(t, depth)).astype(np.float32)
        shape = (t, 1 << depth)
        leaves = (_grid(rng, grid_quant, shape) if grid_quant
                  else rng.normal(size=shape).astype(np.float32))
        x = rng.uniform(size=(n, d)).astype(np.float32)
        F = apply_gbt_scores({"feats": _t(feats), "thrs": _t(thrs), "leaves": _t(leaves)}, _t(x))
        return dict(F=F.numpy().astype(np.float64), x=x, feats=feats, thrs=thrs, leaves=leaves)
    t, S, D = 18, 4, 6
    feats = np.stack([rng.choice(D, S, replace=False) for _ in range(t)]).astype(np.int32)
    shape = (t, 1 << S)
    theta = (_grid(rng, grid_quant, shape) if grid_quant
             else rng.normal(scale=0.5, size=shape).astype(np.float32))
    x = rng.uniform(size=(n, D)).astype(np.float32)
    F = apply_lattice_scores({"feats": _t(feats), "theta": _t(theta)}, _t(x))
    return dict(F=F.numpy().astype(np.float64), x=x, feats=feats, theta=theta, S=S)


@pytest.fixture(scope="module")
def ensembles():
    rng = np.random.default_rng(17)
    out = {}
    for variant in ("matrix", "tree", "lattice"):
        case = _ensemble(variant, rng)
        case["fit"] = j_fit(case["F"], beta=0.0, alpha=0.02, mode="both")
        out[variant] = case
    return out


def _plans(case, quant, chunk_t=5):
    jm = case["fit"]
    jplan = JPlan.from_qwyc(jm, chunk_t=chunk_t)
    m = _port_model(jm)
    return jm, jde.DevicePlan.from_plan(jplan, quant=quant), m, DevicePlan.from_plan(
        CascadePlan.from_qwyc(m, chunk_t=chunk_t), quant=quant
    )


def _scorers(variant, case, jdplan, dplan, order, quant):
    if variant == "matrix":
        return jde.matrix_stage_scorer(jdplan), matrix_stage_scorer(dplan, device="cpu")
    if variant == "tree":
        p = [case[k][order] for k in ("feats", "thrs", "leaves")]
        return (jde.tree_stage_scorer(jdplan, *p, block_n=32, quant=quant),
                tree_stage_scorer(dplan, *p, block_n=32, quant=quant, device="cpu"))
    p = [case["theta"][order], case["feats"][order]]
    return (jde.lattice_stage_scorer(jdplan, *p, block_n=32, quant=quant),
            lattice_stage_scorer(dplan, *p, block_n=32, quant=quant, device="cpu"))


def _operand(variant, case, order):
    return case["F"][:, order].astype(np.float32) if variant == "matrix" else case["x"]


# -- slabs -----------------------------------------------------------------


def _raw_payload(rng, shape, stages):
    """Raw normals off every grid, with bf16 ties (both roundings), signed
    zeros, and one stage all zero (its int8 scale falls back to 1.0)."""
    v = rng.normal(size=shape).astype(np.float32)
    v[0, :4] = [1 + 2.0**-8, 1 + 3 * 2.0**-8, -0.0, 0.0]
    v[1, :2] = [-(1 + 2.0**-8), 3.0e-39]  # a tie and an f32 subnormal
    t0, t1 = stages[1]
    v[t0:t1] = 0.0
    return v


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("variant", ["tree", "lattice"])
def test_slabs_equal_reference_bit_for_bit(variant, quant):
    """``build_{tree,lattice}_slabs`` at each storage: payload, scale,
    eps_position, feature ids and thresholds equal the JAX package's bit for
    bit on raw payloads; ``param_slabs_from_numpy`` carries JAX's slabs
    across to the same slabs."""
    rng = np.random.default_rng(3)
    T = 23
    plan = CascadePlan(order=np.arange(T), eps_pos=np.ones(T), eps_neg=-np.ones(T),
                       beta=0.0, costs=np.ones(T), chunk_t=5, lead_t=1)
    jplan = JPlan(order=np.arange(T), eps_pos=np.ones(T), eps_neg=-np.ones(T),
                  beta=0.0, costs=np.ones(T), chunk_t=5, lead_t=1)
    dplan, jdplan = DevicePlan.from_plan(plan, quant), jde.DevicePlan.from_plan(jplan, quant)
    if variant == "tree":
        depth = 3
        args = (rng.integers(0, 8, size=(T, depth)).astype(np.int32),
                rng.uniform(size=(T, depth)).astype(np.float32),
                _raw_payload(rng, (T, 1 << depth), plan.stages))
        got = mk.build_tree_slabs(dplan, *args, quant=quant, device="cpu")
        want = jmk.build_tree_slabs(jdplan, *args, quant=quant)
        names = ("feats", "thrs", "payload")
    else:
        S = 4
        args = (_raw_payload(rng, (T, 1 << S), plan.stages),
                np.stack([rng.choice(6, S, replace=False) for _ in range(T)]).astype(np.int32))
        got = mk.build_lattice_slabs(dplan, *args, quant=quant, device="cpu")
        want = jmk.build_lattice_slabs(jdplan, *args, quant=quant)
        names = ("feats", "payload")
    assert got.data["payload"].dtype == mk.PAYLOAD_DTYPES[quant]
    for name in names:
        a, b = got.data[name], np.asarray(want.data[name])
        if name == "payload" and quant == "bf16":
            a, b = a.float(), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy().view(np.uint8), np.ascontiguousarray(b).view(np.uint8))
    np.testing.assert_array_equal(_bits(got.scale.numpy()), _bits(want.scale))
    np.testing.assert_array_equal(got.eps_position.view(np.int64),
                                  np.asarray(want.eps_position, np.float64).view(np.int64))
    assert (got.W, got.S, got.x_dtype) == (want.W, want.S, None)
    if quant == "int8":
        assert got.scale[1, 0] == 1.0 and (got.data["payload"][1] == 0).all()
    if quant != "f32":
        assert got.eps_position.max() > 0.0
    # JAX's slabs carried across
    data = {n: np.asarray(want.data[n]).astype(np.float32) if n == "payload" and quant == "bf16"
            else np.asarray(want.data[n]) for n in names}
    carried = param_slabs_from_numpy(variant, quant, data, np.asarray(want.scale),
                                     want.eps_position, want.W, want.S, device="cpu")
    for name in names:
        assert carried.data[name].dtype == got.data[name].dtype
        assert torch.equal(carried.data[name], got.data[name])
    assert torch.equal(carried.scale, got.scale)
    np.testing.assert_array_equal(carried.eps_position, got.eps_position)


def test_matrix_slabs_and_oracle_helpers_equal_reference():
    """Matrix slabs (bf16: the operand's storage dtype, unit scales, zero
    errors), int8 matrix slabs refused with the reference's message,
    ``matrix_eps_position``, ``tolerance_bound`` and ``check_parity`` (the
    same report, the same raises) equal the JAX package's."""
    rng = np.random.default_rng(5)
    F = make_scores(rng, n=90, t=20)
    jm = j_fit(F, beta=0.0, alpha=0.02)
    _, jdplan, _, dplan = _plans(dict(fit=jm), "bf16", chunk_t=4)
    got, want = mk.build_matrix_slabs(dplan, quant="bf16", device="cpu"), \
        jmk.build_matrix_slabs(jdplan, quant="bf16")
    assert got.x_dtype == torch.bfloat16 and want.x_dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.eps_position, want.eps_position)
    np.testing.assert_array_equal(got.data["widths"].numpy(), np.asarray(want.data["widths"])[:, 0])
    msgs = []
    for build in (lambda: mk.build_matrix_slabs(dplan, quant="int8", device="cpu"),
                  lambda: jmk.build_matrix_slabs(jdplan, quant="int8")):
        try:
            build()
        except ValueError as e:
            msgs.append(str(e))
    assert len(msgs) == 2 and msgs[0] == msgs[1] and "f32/bf16 only" in msgs[0]
    Fo = F[:, jm.order]
    Fo[0, :3] = [1 + 2.0**-8, -(1 + 3 * 2.0**-8), 1e-40]
    for quant in ("f32", "bf16"):
        np.testing.assert_array_equal(mk.matrix_eps_position(Fo, quant),
                                      jmk.matrix_eps_position(Fo, quant))
    assert mk.matrix_eps_position(Fo, "bf16").max() > 0.0
    with pytest.raises(ValueError, match="f32/bf16 only"):
        mk.matrix_eps_position(Fo, "int8")
    # tolerance_bound on random errors, walks past T and g scales
    eps = rng.uniform(0, 1e-3, size=20)
    steps = rng.integers(-2, 24, size=50)
    for g_scale in (1.0, 37.5):
        np.testing.assert_array_equal(mk.tolerance_bound(eps, steps, g_scale),
                                      jmk.tolerance_bound(eps, steps, g_scale))
    # check_parity: a pass, then each way to fail
    n = 50
    res = lambda d, e, g: types.SimpleNamespace(decisions=d, exit_step=e, g_final=g)  # noqa: E731
    dec = rng.random(n) < 0.5
    ex = rng.integers(1, 21, size=n)
    g = rng.normal(size=n).astype(np.float32)
    g_near = g + np.float32(1e-4) * (rng.random(n) < 0.3)
    cases = [
        (res(dec, ex, g), res(dec, ex, g_near)),
        (res(dec, ex, g), res(dec, ex, g)),
        (res(dec, ex, g), res(dec[:-1], ex[:-1], g[:-1])),
        (res(dec, ex, g), res(dec, np.where(np.arange(n) == 7, ex + 1, ex), g)),
        (res(dec, ex, g), res(~dec, ex, g)),
        (res(dec, ex, g), res(dec, ex, g + np.float32(1.0))),
    ]
    eps_pos = np.full(20, 1e-5)
    for a, b in cases:
        outs = []
        for fn in (mk.check_parity, jmk.check_parity):
            try:
                outs.append(("ok", fn(a, b, eps_pos, g_scale=2.0)))
            except AssertionError as e:
                outs.append(("raise", str(e)))
        assert outs[0] == outs[1]
    assert mk.check_parity(*cases[1], eps_pos)["exact"]


def test_param_slabs_from_numpy_refuses_what_it_cannot_carry():
    with pytest.raises(ValueError, match="tree or lattice"):
        param_slabs_from_numpy("matrix", "bf16", {}, np.ones((2, 1)), np.zeros(4), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="quant must be one of"):
        param_slabs_from_numpy("tree", "fp8", {}, np.ones((2, 1)), np.zeros(4), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        param_slabs_from_numpy(
            "lattice", "int8", {"feats": np.zeros((2, 3, 2)), "payload": np.zeros((2, 2, 4))},
            np.ones((2, 1)), np.zeros(4), 2, 2, device="cpu",
        )


# -- B7 and B4 plain versions against mega_lane_pallas ----------------------


def _step_inputs(variant, quant, seed):
    """A random plan (S 9 stages of W 4, a ragged last stage), its slabs at
    ``quant`` in both packages (raw payloads, off the grid), and a
    mixed-stage buffer: every stage in the first block, last-stage (stop)
    lanes, trash lanes past n_valid, cap 96 in blocks of 32."""
    rng = np.random.default_rng(seed)
    T, W = 34, 4
    eps = rng.uniform(0.4, 2.0, size=T), -rng.uniform(0.4, 2.0, size=T)
    jplan = JPlan(order=np.arange(T), eps_pos=eps[0], eps_neg=eps[1], beta=0.0,
                  costs=np.ones(T), chunk_t=W)
    plan = CascadePlan(order=np.arange(T), eps_pos=eps[0], eps_neg=eps[1], beta=0.0,
                       costs=np.ones(T), chunk_t=W)
    jdplan, dplan = jde.DevicePlan.from_plan(jplan, quant), DevicePlan.from_plan(plan, quant)
    S, n_rows, d, cap = dplan.S, 200, 7, 96
    theta = None
    if variant == "matrix":
        x = rng.normal(scale=0.6, size=(n_rows, dplan.T_pad)).astype(np.float32)
        x[0, :2] = [1 + 2.0**-8, 1 + 3 * 2.0**-8]  # bf16 ties
        jslabs = jmk.build_matrix_slabs(jdplan, quant=quant)
        slabs = mk.build_matrix_slabs(dplan, quant=quant, device="cpu")
        x_port = _t(x).to(torch.bfloat16)
        x_jax = jnp.asarray(x, jnp.bfloat16)
    elif variant == "tree":
        p = (rng.integers(0, d, size=(T, 3)).astype(np.int32),
             rng.uniform(size=(T, 3)).astype(np.float32),
             rng.normal(scale=0.6, size=(T, 8)).astype(np.float32))
        x = rng.uniform(size=(n_rows, d)).astype(np.float32)
        jslabs = jmk.build_tree_slabs(jdplan, *p, quant=quant)
        slabs = mk.build_tree_slabs(dplan, *p, quant=quant, device="cpu")
        x_port, x_jax = _t(x), jnp.asarray(x)
    else:
        theta = rng.normal(scale=0.6, size=(T, 16)).astype(np.float32)
        lf = np.stack([rng.choice(d, 4, replace=False) for _ in range(T)]).astype(np.int32)
        x = rng.uniform(size=(n_rows, d)).astype(np.float32)
        x[:20] = np.round(x[:20])  # corners
        jslabs = jmk.build_lattice_slabs(jdplan, theta, lf, quant=quant)
        slabs = mk.build_lattice_slabs(dplan, theta, lf, quant=quant, device="cpu")
        x_port, x_jax = _t(x), jnp.asarray(x)
    stage = rng.integers(0, S, size=cap).astype(np.int32)
    stage[:S] = np.arange(S)
    rows = rng.permutation(n_rows)[:cap].astype(np.int64)
    g0 = rng.normal(scale=0.5, size=cap).astype(np.float32)
    return dict(jdplan=jdplan, dplan=dplan, jslabs=jslabs, slabs=slabs, x_port=x_port,
                x_jax=x_jax, stage=stage, rows=rows, g0=g0, theta=theta)


def _jax_lane_step(c, stage, stop, n_valid):
    """JAX's mega_lane_pallas on lanes at ``stage`` (the matrix variant takes
    each lane's (cap, W) columns pre-sliced, at the storage dtype)."""
    jd = c["jdplan"]
    xr = c["x_jax"][c["rows"]]
    if c["slabs"].variant == "matrix":
        idx = jd.stage_t0[stage][:, None] + np.arange(jd.W)[None, :]
        xr = jnp.take_along_axis(xr, jnp.asarray(idx), axis=1)
    return jmk.mega_lane_pallas(
        c["jslabs"], xr, jmk.gather_lane_slabs(c["jslabs"], jnp.asarray(stage)),
        jnp.asarray(c["g0"]), jnp.asarray(jd.eps_pos[stage]), jnp.asarray(jd.eps_neg[stage]),
        jnp.asarray(stop), jnp.int32(n_valid), block_n=32, interpret=True,
    )


def _assert_step_equal(got, want, c, lattice_walk):
    """(g, active, decided, exit_rel, pack, n_keep) equal; lattice g within
    C4's bound over the ``lattice_walk`` positions a lane walked."""
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy(), np.asarray(b)
        if k == 0 and c["theta"] is not None:
            bound = _lattice_bound(lattice_walk, c["theta"], 4, float(np.abs(c["g0"]).max()))
            assert (np.abs(a.astype(np.float64) - b) <= bound).all()
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("n_valid", [0, 50, 96])
@pytest.mark.parametrize("variant,quant", CASES)
def test_mega_lane_plain_equals_pallas_at_quant(variant, quant, n_valid):
    """B7's plain version at bf16/int8 slabs against ``mega_lane_pallas`` in
    interpret mode: lanes at every stage, stop lanes, n_valid 0, partial,
    all; launches nothing on a CPU tensor."""
    c = _step_inputs(variant, quant, seed=7 + n_valid)
    stop = c["stage"] >= c["dplan"].S - 1
    want = _jax_lane_step(c, c["stage"], stop, n_valid)
    dp = c["dplan"]
    _build.LAUNCHES.clear()
    got = mk.mega_lane(
        c["slabs"], c["x_port"], _t(c["rows"]), _t(c["g0"]), _t(c["stage"]), _t(stop),
        torch.tensor(n_valid, dtype=torch.int32), _t(dp.eps_pos), _t(dp.eps_neg), block_n=32,
    )
    assert sum(_build.LAUNCHES.values()) == 0
    _assert_step_equal(got, want, c, lattice_walk=dp.W)
    if n_valid:
        assert (got[3][:n_valid] > 0).any() and (got[1][:n_valid] > 0).any()


@pytest.mark.parametrize("stage", [0, 4, 8])
@pytest.mark.parametrize("variant,quant", CASES)
def test_mega_stage_plain_equals_uniform_lane_pallas(variant, quant, stage):
    """B4's plain version at bf16/int8 slabs against ``mega_lane_pallas`` fed
    B4's step: every lane at ``stage`` (the lead, a full and the ragged last
    stage), no stop lanes, a partial live count."""
    c = _step_inputs(variant, quant, seed=30 + stage)
    dp, cap = c["dplan"], c["g0"].shape[0]
    st = np.full(cap, stage, np.int32)
    n_valid = 70
    want = _jax_lane_step(c, st, np.zeros(cap, bool), n_valid)
    x = c["x_port"][_t(c["rows"])]
    got = mk.mega_stage(
        c["slabs"], x, _t(c["g0"]), stage, int(dp.stage_t0[stage]),
        torch.tensor(n_valid, dtype=torch.int32), _t(dp.eps_pos), _t(dp.eps_neg), block_n=32,
    )
    _assert_step_equal(got, want, c, lattice_walk=dp.W)


# -- the executor -----------------------------------------------------------


@pytest.mark.parametrize("variant,quant", CASES)
def test_run_stream_megakernel_equals_reference(ensembles, variant, quant):
    """``run_stream(megakernel=True)`` at bf16/int8 slabs (raw weights)
    against JAX's: decisions, exits, admission and decision steps, steps,
    occupancy and billing equal; g bit for bit (lattices: C4's bound)."""
    case = ensembles[variant]
    jm, jdplan, m, dplan = _plans(case, quant)
    order = np.asarray(jm.order)
    jsc, sc = _scorers(variant, case, jdplan, dplan, order, quant)
    X = _operand(variant, case, order)
    n = X.shape[0]
    arr = np.sort(np.random.default_rng(2).integers(0, 8, size=n)).astype(np.int32)
    want = jde.DeviceExecutor(jdplan, jsc, block_n=32, megakernel=True).run_stream(
        X, n, arrivals=arr, capacity=32)
    ex = DeviceExecutor(dplan, sc, block_n=32, megakernel=True, device="cpu")
    got = ex.run_stream(X, n, arrivals=arr, capacity=32)
    assert ex.megakernel and sc.slabs.quant == quant
    for k in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)), err_msg=k)
    assert (got.steps_run, got.scores_computed, got.scores_possible) == (
        want.steps_run, want.scores_computed, want.scores_possible)
    if variant == "lattice":
        bound = _lattice_bound(got.exit_step, case["theta"], case["S"])
        assert (np.abs(got.g_final.astype(np.float64) - np.asarray(want.g_final)) <= bound).all()
    else:
        np.testing.assert_array_equal(_bits(got.g_final), _bits(want.g_final))


@pytest.mark.parametrize("variant,quant", [("tree", "bf16"), ("tree", "int8"),
                                           ("lattice", "bf16"), ("lattice", "int8")])
def test_batch_run_on_grid_payloads(variant, quant):
    """The protocol of ``tests/test_megakernel.py``'s quantised tests on
    payloads already on the grid (``eps_position == 0``): batch
    ``run(megakernel=True)`` equals the port's ``run_stream`` in verdicts,
    exits and g bit for bit, and ``run(megakernel=False)`` under
    ``check_parity`` (exactly, billing equal)."""
    rng = np.random.default_rng(17)
    case = _ensemble(variant, rng, grid_quant=quant)
    case["fit"] = j_fit(case["F"], beta=0.0, alpha=0.02, mode="both")
    jm, _, m, dplan = _plans(case, quant)
    order = np.asarray(jm.order)
    if variant == "tree":
        sc = tree_stage_scorer(dplan, *[case[k][order] for k in ("feats", "thrs", "leaves")],
                               block_n=32, device="cpu")
        payload = case["leaves"]
    else:
        sc = lattice_stage_scorer(dplan, case["theta"][order], case["feats"][order],
                                  block_n=32, device="cpu")
        payload = case["theta"]
    assert sc.slabs.quant == quant and sc.slabs.eps_position.max() == 0.0
    X, n = case["x"], case["x"].shape[0]
    fused = DeviceExecutor(dplan, sc, block_n=32, megakernel=True, device="cpu")
    oracle = DeviceExecutor(dplan, sc, block_n=32, megakernel=False, device="cpu")
    rows = np.random.default_rng(4).permutation(n)
    res, orc = fused.run(X, n, row_order=rows), oracle.run(X, n, row_order=rows)
    rep = mk.check_parity(orc, res, sc.slabs.eps_position,
                          g_scale=float(np.abs(payload).max() * m.T))
    assert rep["exact"] and res.scores_computed == orc.scores_computed
    assert [c.n_in for c in res.chunk_stats] == [c.n_in for c in orc.chunk_stats]
    s_res = fused.run_stream(X, n, capacity=64)
    np.testing.assert_array_equal(s_res.decisions, res.decisions)
    np.testing.assert_array_equal(s_res.exit_step, res.exit_step)
    np.testing.assert_array_equal(_bits(s_res.g_final), _bits(res.g_final))


def test_matrix_bf16_batch_within_tolerance():
    """The bf16 matrix batch path against JAX's ``run(megakernel=False)`` on
    the bf16 plan (the f32 oracle; it runs), under ``check_parity`` with
    ``matrix_eps_position``, on the fixture of
    ``tests/test_megakernel.py::test_matrix_bf16_within_tolerance`` (seed 3,
    n 220, t 24, chunk_t 4); the port's own unfused run equals JAX's
    exactly."""
    F = make_scores(np.random.default_rng(3), n=220, t=24)
    case = dict(F=F, fit=j_fit(F, beta=0.0, alpha=0.02))
    jm, jdplan, m, dplan = _plans(case, "bf16", chunk_t=4)
    Fo = _operand("matrix", case, np.asarray(jm.order))
    n = Fo.shape[0]
    jsc = jde.matrix_stage_scorer(jdplan)
    want = jde.DeviceExecutor(jdplan, jsc, block_n=32, megakernel=False).run(Fo, n)
    sc = matrix_stage_scorer(dplan, device="cpu")
    res = DeviceExecutor(dplan, sc, block_n=32, megakernel=True, device="cpu").run(Fo, n)
    off = DeviceExecutor(dplan, sc, block_n=32, megakernel=False, device="cpu").run(Fo, n)
    rep = mk.check_parity(want, res, mk.matrix_eps_position(Fo, "bf16"),
                          g_scale=float(np.abs(Fo).sum(axis=1).max()))
    assert rep["max_err"] <= rep["max_bound"] and not rep["exact"]
    assert res.scores_computed == want.scores_computed
    for k in ("decisions", "exit_step"):
        np.testing.assert_array_equal(getattr(off, k), np.asarray(getattr(want, k)))
    np.testing.assert_array_equal(_bits(off.g_final), _bits(want.g_final))


def test_megakernel_default_stays_off_for_quantized_slabs(ensembles):
    case = ensembles["tree"]
    for quant, default_on in (("f32", True), ("bf16", False), ("int8", False)):
        jm, _, _, dplan = _plans(case, quant)
        order = np.asarray(jm.order)
        sc = tree_stage_scorer(dplan, *[case[k][order] for k in ("feats", "thrs", "leaves")],
                               device="cpu")
        assert DeviceExecutor(dplan, sc, device="cpu").megakernel is default_on
        assert DeviceExecutor(dplan, sc, megakernel=True, device="cpu").megakernel
        assert not DeviceExecutor(dplan, sc, megakernel=False, device="cpu").megakernel


# -- servers ----------------------------------------------------------------


def _stream_serve(srv, X, arrivals):
    for i in range(X.shape[0]):
        srv.submit(X[i], arrival=arrivals[i])
    return srv.drain()


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quantized_servers_on_cpu(ensembles, quant):
    """``StreamingServer`` with ``TreeScorer(quant=)`` and
    ``backend_opts={"megakernel": True}`` equals JAX's (results and every
    streaming stat); ``QWYCServer`` with the same scorer serves the fused
    quantised batch step and agrees with the streaming server's verdicts,
    models and per-row g."""
    case = ensembles["tree"]
    jm = case["fit"]
    m = _port_model(jm)
    p = [case[k] for k in ("feats", "thrs", "leaves")]
    kw = dict(batch_size=32, window=64, chunk_t=4, block_n=32,
              backend_opts={"megakernel": True})
    jsrv = JStreamingServer(jm, scorer=JTreeScorer(*p, block_n=32, quant=quant),
                            exec_backend="device", **kw)
    srv = StreamingServer(m, scorer=TreeScorer(*p, block_n=32, quant=quant),
                          exec_backend="device", device="cpu", **kw)
    X = case["x"]
    arrivals = np.floor(np.cumsum(np.random.default_rng(66).exponential(1 / 16.0, size=len(X))))
    want, got = _stream_serve(jsrv, X, arrivals), _stream_serve(srv, X, arrivals)
    assert jsrv.exec.name == "device" and srv._dev[0].megakernel
    assert srv._dev[0].scorer.slabs.quant == quant
    assert [r["decision"] for r in got] == [r["decision"] for r in want]
    assert [r["models_evaluated"] for r in got] == [r["models_evaluated"] for r in want]
    for k in ("n_requests", "n_batches", "models_evaluated", "scores_computed",
              "stream_steps", "stream_slot_steps", "latency_steps"):
        assert getattr(srv.stats, k) == getattr(jsrv.stats, k), k
    g_stream = np.concatenate([r.g_final for r in srv.stream_results])
    np.testing.assert_array_equal(
        _bits(g_stream), _bits(np.concatenate([np.asarray(r.g_final) for r in jsrv.stream_results])))
    batch = QWYCServer(m, scorer=TreeScorer(*p, block_n=32, quant=quant), batch_size=64,
                       chunk_t=4, block_n=32, backend="kernel", exec_backend="device",
                       device="cpu", backend_opts={"megakernel": True})
    _build.LAUNCHES.clear()
    for row in X:
        batch.submit(row)
    res = batch.drain()
    assert sum(_build.LAUNCHES.values()) == 0
    assert batch._dev[0].megakernel and batch._dev[1].slabs.quant == quant
    assert [r["decision"] for r in res] == [r["decision"] for r in got]
    assert [r["models_evaluated"] for r in res] == [r["models_evaluated"] for r in got]
    g_batch = np.concatenate([r.g_final for r in batch.flush_results])
    np.testing.assert_array_equal(_bits(g_batch), _bits(g_stream))


# -- the billing keys of the bf16 megakernel ----------------------------------


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_bf16_megakernel_billing_keys(mode):
    """``benchmarks/perf_gate.py``'s fixture (seed 2026, n 512, t 32, alpha
    0.01, chunk_t 8, block 64) through the port: the bf16 megakernel on the
    bf16-rounded operand and the multi-kernel run on the f32 operand bill
    ``baseline_billing.json``'s ``{mode}.device.{bf16mk,multikernel}.{scores,
    stages}`` key by key, and the bf16 megakernel's verdicts and exits equal
    its multi-kernel run's."""
    counters = json.loads(BASELINE.read_text())["counters"]
    rng = np.random.default_rng(2026)
    n, t = 512, 32
    z = rng.normal(size=(n, 1))
    F = (rng.normal(size=(n, t)) * 0.7 + 0.4 * z).astype(np.float64)
    m = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
    plan = CascadePlan.from_qwyc(m, chunk_t=8)
    Fo = F[:, m.order].astype(np.float32)
    dplan = DevicePlan.from_plan(plan)
    multi = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
                           megakernel=False, device="cpu").run(Fo, n)
    Fq = np.asarray(jnp.asarray(Fo, jnp.bfloat16), np.float32)
    dplan_q = DevicePlan.from_plan(plan, quant="bf16")
    sc_q = matrix_stage_scorer(dplan_q, device="cpu")
    qres = DeviceExecutor(dplan_q, sc_q, block_n=64, megakernel=True, device="cpu").run(Fq, n)
    qfres = DeviceExecutor(dplan_q, sc_q, block_n=64, megakernel=False, device="cpu").run(Fq, n)
    np.testing.assert_array_equal(qres.decisions, qfres.decisions)
    np.testing.assert_array_equal(qres.exit_step, qfres.exit_step)
    assert qres.scores_computed == qfres.scores_computed
    got = {
        f"{mode}.device.bf16mk.scores": qres.scores_computed,
        f"{mode}.device.bf16mk.stages": len(qres.chunk_stats),
        f"{mode}.device.multikernel.scores": multi.scores_computed,
        f"{mode}.device.multikernel.stages": len(multi.chunk_stats),
    }
    assert got == {k: counters[k] for k in got}
