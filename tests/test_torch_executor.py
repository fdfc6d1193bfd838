"""Executor parity of the PyTorch port with the JAX package on the CPU.

The port's ``ChunkedExecutor`` (both decides) and ``DeviceExecutor``
(device="cpu": every kernel wrapper takes its plain version; tree and
matrix scorers, megakernel on and off) give the JAX package's decisions,
exit steps, f32 ``g_final`` and per-stage billing bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_scores
from repro.core import CascadePlan as JPlan
from repro.core import ChunkedExecutor as JChunked
from repro.core import fit_qwyc as j_fit
from repro.core import matrix_producer as j_matrix_producer
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.ensembles.gbt import apply_gbt_scores as j_apply_gbt_scores
from repro.ensembles.gbt import train_gbt as j_train_gbt
from repro.kernels import device_executor as jde
from repro.kernels import ops as j_ops
from repro_torch.api.scorers import MatrixScorer
from repro_torch.core import (
    CascadePlan,
    ChunkedExecutor,
    evaluate_cascade,
    fit_qwyc,
    matrix_producer,
)
from repro_torch.kernels import ops
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
    tree_stage_scorer,
)


def _assert_same(a, b, g=True):
    np.testing.assert_array_equal(a.decisions, b.decisions)
    np.testing.assert_array_equal(a.exit_step, b.exit_step)
    if g:
        np.testing.assert_array_equal(
            np.asarray(a.g_final, np.float32), np.asarray(b.g_final, np.float32)
        )
    assert [dataclasses.astuple(s) for s in a.chunk_stats] == [
        dataclasses.astuple(s) for s in b.chunk_stats
    ]
    assert a.scores_computed == b.scores_computed


@pytest.fixture(scope="module")
def gbt_case():
    """exp1-shaped at a small size: adult at scale 0.1, T = 60, depth 5."""
    ds = j_make_dataset("adult", scale=0.1)
    g = j_train_gbt(ds.x_train, ds.y_train, n_trees=60, depth=5)
    st = g.stacked()
    F_tr = np.asarray(j_apply_gbt_scores(st, jnp.asarray(ds.x_train))).astype(np.float64)
    F_te = np.asarray(j_apply_gbt_scores(st, jnp.asarray(ds.x_test)))
    m = j_fit(F_tr, beta=-g.base_score, alpha=0.01)
    return ds, g, F_te, m


@pytest.mark.parametrize("decide", ["reference", "kernel"])
@pytest.mark.parametrize("chunk_t", [5, 8, 16])
def test_chunked_executor_matches_jax(gbt_case, decide, chunk_t):
    ds, g, F, m = gbt_case
    ordered = F[:, m.order]
    jplan = JPlan.from_qwyc(m, chunk_t=chunk_t)
    plan = CascadePlan.from_qwyc(m, chunk_t=chunk_t)
    row_order = np.argsort(ordered[:, 0], kind="stable")
    if decide == "kernel":
        jd = j_ops.kernel_decide_fn(block_n=64, interpret=True)
        d = ops.kernel_decide_fn(block_n=64, device="cpu")
    else:
        jd = d = None
    want = JChunked(jplan, j_matrix_producer(ordered), decide_fn=jd, bill_block=64).run(
        F.shape[0], row_order=row_order
    )
    got = ChunkedExecutor(plan, matrix_producer(ordered), decide_fn=d, bill_block=64).run(
        F.shape[0], row_order=row_order
    )
    _assert_same(want, got)
    assert got.g_final.dtype == want.g_final.dtype


@pytest.fixture(scope="module")
def jax_device_result(gbt_case):
    """JAX DeviceExecutor over the apply_gbt_scores ordered matrix, the
    multi-kernel path (the megakernel's tree kernel is dead under this
    jax), sorted-kernel plan (lead stage), batch 256."""
    ds, g, F, m = gbt_case
    plan = dataclasses.replace(JPlan.from_qwyc(m, chunk_t=8), lead_t=1)
    dplan = jde.DevicePlan.from_plan(plan)
    scorer = dataclasses.replace(jde.matrix_stage_scorer(dplan), block_n=64)
    ex = jde.DeviceExecutor(dplan, scorer, block_n=64, megakernel=False)
    ordered = F[:, m.order]
    row_order = np.argsort(ordered[:, 0], kind="stable")
    return ex.run(ordered, F.shape[0], row_order=row_order, capacity=256)


@pytest.mark.parametrize("megakernel", [None, False])
@pytest.mark.parametrize("scorer_kind", ["tree", "matrix", "MatrixScorer"])
def test_device_executor_matches_jax(gbt_case, jax_device_result, megakernel, scorer_kind):
    ds, g, F, m = gbt_case
    plan = dataclasses.replace(CascadePlan.from_qwyc(m, chunk_t=8), lead_t=1)
    dplan = DevicePlan.from_plan(plan)
    order = m.order
    if scorer_kind == "tree":
        scorer = tree_stage_scorer(
            dplan, g.feats[order], g.thrs[order], g.leaves[order], block_n=64,
            device="cpu",
        )
        batch = ds.x_test
    elif scorer_kind == "matrix":
        scorer = dataclasses.replace(matrix_stage_scorer(dplan, device="cpu"), block_n=64)
        batch = F[:, order]
    else:  # the public template over the ORIGINAL-order matrix
        scorer = dataclasses.replace(MatrixScorer().bind(dplan, device="cpu"), block_n=64)
        batch = F
    ex = DeviceExecutor(dplan, scorer, block_n=64, megakernel=megakernel, device="cpu")
    assert ex.megakernel == (megakernel is None)
    row_order = np.argsort(F[:, order][:, 0], kind="stable")
    got = ex.run(batch, F.shape[0], row_order=row_order, capacity=256)
    _assert_same(jax_device_result, got)
    ev = evaluate_cascade(m, F)
    np.testing.assert_array_equal(got.decisions, ev["decisions"])
    np.testing.assert_array_equal(got.exit_step, ev["exit_step"])


@pytest.mark.parametrize("chunk_t", [1, 8, 100])
@pytest.mark.parametrize("lead_t", [0, 1])
def test_edge_plans_parity_both_executors(chunk_t, lead_t):
    """The degenerate stage grids of the reference's edge-plan test, through
    both of the port's executors and both device stage paths."""
    rng = np.random.default_rng(12)
    F = make_scores(rng, n=200, t=16)
    m = fit_qwyc(F, beta=0.0, alpha=0.01)
    ev = evaluate_cascade(m, F)
    plan = dataclasses.replace(CascadePlan.from_qwyc(m, chunk_t=chunk_t), lead_t=lead_t)
    host = ChunkedExecutor(plan, matrix_producer(F[:, m.order])).run(F.shape[0])
    dplan = DevicePlan.from_plan(plan)
    devs = [
        DeviceExecutor(
            dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
            megakernel=mk, device="cpu",
        ).run(F[:, m.order].astype(np.float32), F.shape[0])
        for mk in (None, False)
    ]
    for res in [host] + devs:
        np.testing.assert_array_equal(res.decisions, ev["decisions"])
        np.testing.assert_array_equal(res.exit_step, ev["exit_step"])
    _assert_same(devs[0], devs[1])


def test_partial_batch_and_empty_batch():
    """A flush smaller than the pinned capacity retires rows mid-block and
    pads the rest; n = 0 returns an empty result."""
    rng = np.random.default_rng(13)
    F = make_scores(rng, n=90, t=12)
    m = fit_qwyc(F, beta=0.0, alpha=0.02)
    plan = CascadePlan.from_qwyc(m, chunk_t=4)
    dplan = DevicePlan.from_plan(plan)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), device="cpu")
    ordered = F[:, m.order].astype(np.float32)
    order = torch.from_numpy(rng.permutation(90))
    res = ex.run(ordered, 90, row_order=order, capacity=200)
    ev = evaluate_cascade(m, F)
    np.testing.assert_array_equal(res.decisions, ev["decisions"])
    np.testing.assert_array_equal(res.exit_step, ev["exit_step"])
    assert res.chunk_stats[0].scores_computed == 128 * dplan.W
    empty = ex.run(np.zeros((0, m.T), np.float32), 0)
    assert empty.decisions.shape == (0,) and empty.chunk_stats == []


# -- the compiled-program contract: DeviceExecutor.traces ----------------------
# The reference counts one jit trace per program key; the port counts one
# per key too (on the card, one CUDA graph each).  These hold the port's
# count to the JAX executor's own on the same fixtures (the JAX side on its
# multi-kernel path: its batch megakernel is dead under this jax).


def _trace_fixture(seed=13, n=200, t=16, chunk_t=4):
    rng = np.random.default_rng(seed)
    F = make_scores(rng, n=n, t=t)
    m = fit_qwyc(F, beta=0.0, alpha=0.01)
    jm = j_fit(F, beta=0.0, alpha=0.01)
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=chunk_t))
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=chunk_t))
    jex = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=64,
                             megakernel=False)
    return F, m, jex, dplan


@pytest.mark.parametrize("megakernel", [None, False])
@pytest.mark.parametrize("chunk_t", [1, 8, 100])
@pytest.mark.parametrize("lead_t", [0, 1])
def test_traces_one_per_run_shape_matches_jax(chunk_t, lead_t, megakernel):
    """The reference's ``test_executor.py:187``: one run of a plan, one
    trace, on every degenerate stage grid."""
    rng = np.random.default_rng(12)
    F = make_scores(rng, n=200, t=16)
    m = fit_qwyc(F, beta=0.0, alpha=0.01)
    jm = j_fit(F, beta=0.0, alpha=0.01)
    jdplan = jde.DevicePlan.from_plan(
        dataclasses.replace(JPlan.from_qwyc(jm, chunk_t=chunk_t), lead_t=lead_t))
    dplan = DevicePlan.from_plan(
        dataclasses.replace(CascadePlan.from_qwyc(m, chunk_t=chunk_t), lead_t=lead_t))
    jex = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=64,
                             megakernel=False)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
                        megakernel=megakernel, device="cpu")
    Fo = F[:, m.order].astype(np.float32)
    _assert_same(jex.run(Fo, F.shape[0]), ex.run(Fo, F.shape[0]))
    assert ex.traces == jex.traces == 1


def test_traces_empty_batch_matches_jax():
    """``test_executor.py:207``: n = 0 runs no program."""
    F, m, jex, dplan = _trace_fixture()
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), device="cpu")
    empty = np.zeros((0, m.T), dtype=np.float32)
    jex.run(empty, 0)
    ex.run(empty, 0)
    ex.run_stream(empty, 0)
    assert ex.traces == jex.traces == 0


@pytest.mark.parametrize("megakernel", [None, False])
def test_traces_across_flushes_and_capacities_match_jax(megakernel):
    """``test_executor.py:297``: three runs, a permuted row order and a
    smaller live count at the same pinned capacity share one trace; a new
    capacity is a second program (in both packages)."""
    F, m, jex, dplan = _trace_fixture(seed=16, n=200, t=20)
    ex = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device="cpu"), block_n=64,
                        megakernel=megakernel, device="cpu")
    Fo = F[:, m.order].astype(np.float32)
    n = F.shape[0]
    perm = np.random.default_rng(7).permutation(n)
    calls = [
        dict(batch=Fo, n=n), dict(batch=Fo, n=n), dict(batch=Fo, n=n),
        dict(batch=Fo, n=n, row_order=perm), dict(batch=Fo[:100], n=100, capacity=n),
    ]
    for kw in calls:
        _assert_same(jex.run(**kw), ex.run(**kw))
    assert ex.traces == jex.traces == 1
    _assert_same(jex.run(Fo, n, capacity=512), ex.run(Fo, n, capacity=512))
    assert ex.traces == jex.traces == 2


def test_compiled_cascade_traces_match_jax():
    """``test_api.py:242-266``: ``CompiledCascade.traces`` is the device
    executor's count (one program, reused by a second evaluate) and None on
    the host backend, as in the reference."""
    from repro import api as japi
    from repro_torch import api

    rng = np.random.default_rng(40)
    F = make_scores(rng, n=300, t=20)
    fitted = api.fit(F, beta=0.0, alpha=0.01, chunk_t=4, device="cpu")
    jfitted = japi.fit(F, beta=0.0, alpha=0.01, chunk_t=4)
    compiled = fitted.compile("device", block_n=64, device="cpu")
    m = fitted.model
    jdplan = jde.DevicePlan.from_plan(jfitted.plan())
    jex = jde.DeviceExecutor(jdplan, jde.matrix_stage_scorer(jdplan), block_n=64,
                             megakernel=False)
    for _ in range(2):
        _assert_same(jex.run(F[:, m.order].astype(np.float32), F.shape[0]),
                     compiled.evaluate(scores=F))
        assert compiled.traces == jex.traces == 1
    assert fitted.compile("host", device="cpu").traces is None
    assert jfitted.compile("host").traces is None
