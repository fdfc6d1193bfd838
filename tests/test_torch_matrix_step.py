"""The matrix variant of B4 (``mega_stage``) reading the score matrix in
place through ``rows=``, against the gathered form and the JAX package on
the CPU.

Inputs are made with numpy from a seed.  Every comparison is exact (bit
for bit): a matrix score is a load (f32) or a bf16 widen, and the walk is
the same f32 arithmetic in both packages.

B4 has no runnable JAX kernel (``mega_stage_pallas`` uses ``pl.load``,
gone under the installed JAX: ROADMAP C1), so the oracle is
``mega_lane_pallas`` in interpret mode fed what B4 sees: every lane at one
stage, none flagged ``stop``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.core import CascadePlan as JPlan
from repro.core import fit_qwyc as j_fit
from repro.kernels import device_executor as jde
from repro.kernels import megakernel as jmk
from repro_torch.core import CascadePlan
from repro_torch.convert import qwyc_model_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, matrix_stage_scorer

CAP = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _case(W, quant, seed):
    """A random plan of T 61 after a lead model (stages of ``W`` columns
    from t0 = 1 + W k: misaligned starts, a ragged last stage), its matrix
    slabs in both packages, a (200, T_pad) operand at the storage dtype
    and a buffer of CAP lanes reading a permutation of its rows, the last
    ones the executor's trash row id CAP and the very last ids past the
    operand (clamped into range)."""
    rng = np.random.default_rng(seed)
    T = 61
    eps = rng.uniform(0.3, 1.5, size=T), -rng.uniform(0.3, 1.5, size=T)
    kw = dict(order=np.arange(T), eps_pos=eps[0], eps_neg=eps[1], beta=0.0,
              costs=np.ones(T), chunk_t=W, lead_t=1)
    jdplan = jde.DevicePlan.from_plan(JPlan(**kw), quant)
    dplan = DevicePlan.from_plan(CascadePlan(**kw), quant)
    x = rng.normal(scale=0.4, size=(200, dplan.T_pad)).astype(np.float32)
    x[0, :2] = [1 + 2.0**-8, 1 + 3 * 2.0**-8]  # bf16 ties
    rows = rng.permutation(200)[:CAP].astype(np.int64)
    rows[-9:] = CAP  # the executor's trash row id
    rows[-2:] = [200, 10**6]  # past the operand
    dtype = torch.bfloat16 if quant == "bf16" else torch.float32
    return dict(
        jdplan=jdplan, dplan=dplan, rows=rows,
        jslabs=jmk.build_matrix_slabs(jdplan, quant=quant),
        slabs=mk.build_matrix_slabs(dplan, quant=quant, device="cpu"),
        x=_t(x).to(dtype), x_jax=jnp.asarray(x, jnp.bfloat16 if quant == "bf16" else jnp.float32),
        g0=rng.normal(scale=0.5, size=CAP).astype(np.float32),
    )


def _jax_uniform_step(c, stage, n_valid, block_n):
    """``mega_lane_pallas`` with every lane at ``stage``, no stop lanes: B4's
    step (the lane kernel takes each lane's W columns pre-sliced)."""
    jd = c["jdplan"]
    st = np.full(CAP, stage, np.int32)
    rows = np.clip(c["rows"], 0, c["x_jax"].shape[0] - 1)
    idx = jd.stage_t0[st][:, None] + np.arange(jd.W)[None, :]
    xr = jnp.take_along_axis(c["x_jax"][rows], jnp.asarray(idx), axis=1)
    return jmk.mega_lane_pallas(
        c["jslabs"], xr, jmk.gather_lane_slabs(c["jslabs"], jnp.asarray(st)),
        jnp.asarray(c["g0"]), jnp.asarray(jd.eps_pos[st]), jnp.asarray(jd.eps_neg[st]),
        jnp.zeros(CAP, bool), jnp.int32(n_valid), block_n=block_n, interpret=True,
    )


@pytest.mark.parametrize("block_n", [64, 50])
@pytest.mark.parametrize("n_valid", [0, 77, CAP])
@pytest.mark.parametrize("W", [1, 8, 13])
@pytest.mark.parametrize("quant", ["f32", "bf16"])
def test_rows_form_equals_gathered_and_pallas(quant, W, n_valid, block_n):
    """``mega_stage_plain(rows=r)`` equals ``mega_stage_plain`` on ``x[r]``
    output by output (raw per-block outputs), and ``mega_stage(rows=r)``
    equals JAX's lane kernel at one stage, at the lead stage, a full stage
    and the ragged last one; a CPU tensor launches nothing."""
    c = _case(W, quant, seed=W * 10 + n_valid % 7)
    dp = c["dplan"]
    rows, x, g0 = _t(c["rows"]), c["x"], _t(c["g0"])
    x_gathered = x[torch.clamp(rows, 0, x.shape[0] - 1)]
    eps = _t(dp.eps_pos), _t(dp.eps_neg)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    exited = 0
    for stage in (0, dp.S // 2, dp.S - 1):
        t0 = int(dp.stage_t0[stage])
        args = (c["slabs"], x, g0, stage, t0, nv, *eps)
        _build.LAUNCHES.clear()
        got = mk.mega_stage_kernel(*args, block_n=block_n, rows=rows)
        assert sum(_build.LAUNCHES.values()) == 0
        want = mk.mega_stage_plain(c["slabs"], x_gathered, g0, stage, t0, nv, *eps,
                                   block_n=block_n)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        combined = mk.mega_stage(*args, block_n=block_n, rows=rows)
        oracle = _jax_uniform_step(c, stage, n_valid, block_n)
        np.testing.assert_array_equal(_bits(combined[0]), _bits(oracle[0]))
        for a, b in zip(combined[1:], oracle[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
        exited += int((got[3][:n_valid] > 0).sum())
    if n_valid:
        assert exited > 0  # the thresholds retire rows


def test_rows_form_only_for_the_matrix_variant():
    """``rows=`` is the matrix variant's: the tree and lattice variants take
    their rows gathered, on the CPU as on the card."""
    rng = np.random.default_rng(3)
    dp = DevicePlan.from_plan(CascadePlan(
        order=np.arange(12), eps_pos=np.ones(12), eps_neg=-np.ones(12), beta=0.0,
        costs=np.ones(12), chunk_t=4))
    slabs = mk.build_tree_slabs(
        dp, rng.integers(0, 3, size=(12, 2)).astype(np.int32),
        rng.uniform(size=(12, 2)).astype(np.float32),
        rng.normal(size=(12, 4)).astype(np.float32), device="cpu")
    x = _t(rng.uniform(size=(9, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="rows= reads the matrix variant"):
        mk.mega_stage(slabs, x, torch.zeros(8), 0, 0, 8, _t(dp.eps_pos), _t(dp.eps_neg),
                      block_n=4, rows=torch.arange(8))


@pytest.mark.parametrize("chunk_t,block_n", [(1, 64), (8, 64), (8, 50), (13, 50)])
def test_executor_matrix_megakernel_equals_jax(chunk_t, block_n):
    """``DeviceExecutor(matrix_stage_scorer, megakernel=True)`` on the CPU,
    whose stages read the operand in place, equals the JAX package's
    ``DeviceExecutor(megakernel=False)``: verdicts, exits, ``g_final`` bit
    for bit and per-stage billing, over a sorted row order and a capacity
    with trash lanes."""
    rng = np.random.default_rng(chunk_t + block_n)
    F = make_scores(rng, n=230, t=40)
    jm = j_fit(F, beta=0.0, alpha=0.02)
    m = qwyc_model_from_numpy(jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs,
                              jm.alpha, jm.mode)
    jplan = dataclasses.replace(JPlan.from_qwyc(jm, chunk_t=chunk_t), lead_t=1)
    plan = dataclasses.replace(CascadePlan.from_qwyc(m, chunk_t=chunk_t), lead_t=1)
    jdplan, dplan = jde.DevicePlan.from_plan(jplan), DevicePlan.from_plan(plan)
    Fo = F[:, np.asarray(jm.order)].astype(np.float32)
    n = Fo.shape[0]
    order = np.argsort(Fo[:, 0], kind="stable")
    want = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=block_n,
                              megakernel=False).run(Fo, n, row_order=order, capacity=300)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=block_n,
                        megakernel=True, device="cpu")
    got = ex.run(Fo, n, row_order=order, capacity=300)
    np.testing.assert_array_equal(got.decisions, np.asarray(want.decisions))
    np.testing.assert_array_equal(got.exit_step, np.asarray(want.exit_step))
    np.testing.assert_array_equal(_bits(got.g_final), _bits(want.g_final))
    assert [dataclasses.astuple(s) for s in got.chunk_stats] == [
        dataclasses.astuple(s) for s in want.chunk_stats
    ]
    assert got.scores_computed == want.scores_computed
    assert (np.asarray(got.exit_step) < plan.T).any()  # rows exit early


def test_step_kernel_label_names_the_matrix_kernel():
    """``step_kernel_label`` names the four instantiations of
    ``matrix_step_kernel<P, kLanes>``, so the build's stack and spill check
    covers them."""
    names = [f"_ZN12_GLOBAL__N_118matrix_step_kernelI{p}Lb{k}EEEvNS_10MatrixArgsENS_7OutputsE"
             for p in ("f", "13__nv_bfloat16") for k in (0, 1)]
    assert [_build.step_kernel_label(n) for n in names] == [
        "B4 matrix f32", "B7 matrix f32", "B4 matrix bf16", "B7 matrix bf16"]
