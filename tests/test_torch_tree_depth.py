"""Trees at the depths users serve: the port's B4 and B7 plain versions and
its streaming loop against the JAX package on the CPU, and the depth limits
the kernels' wrappers check.

The paper serves GBTs of depth 5 (exp1_adult) and 9 (exp2_nomao,
``repro.configs.qwyc_paper``).  Inputs are made with numpy from a seed and
go through both packages.  Every result is held bit for bit: a tree score
is an exact leaf select (int8: one rounded multiply by the stage's scale),
and the walk is a sequence of f32 adds in model order.

JAX's batch megakernel does not run under the installed jax (``pl.load``,
ROADMAP C1), so B4's plain version is held against ``mega_lane_pallas`` in
interpret mode fed what B4 sees: every lane at one stage, none flagged
``stop``, as ``tests/test_torch_quant.py`` does at depth 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CascadePlan as JPlan
from repro.core import fit_qwyc as j_fit
from repro.kernels import device_executor as jde
from repro.kernels import megakernel as jmk
from repro_torch.convert import qwyc_model_from_numpy
from repro_torch.core import CascadePlan, evaluate_cascade
from repro_torch.ensembles.gbt import apply_gbt_scores
from repro_torch.kernels import _build
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.device_executor import DeviceExecutor, DevicePlan, tree_stage_scorer

# depths 1 and 10 (B3's old limit), exp2_nomao's depth (9), and a depth
# only streaming reaches (12)
DEPTHS = [1, 2, 9, 10, 12]
QUANTS = ["f32", "bf16", "int8"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _step_inputs(depth, quant, seed):
    """A random plan (9 stages of W 4, a ragged last stage), 34 trees of
    ``depth`` over 7 features at ``quant`` in both packages (raw normal
    leaves, off every grid), rows with feature values on a threshold (the
    compare is strict), and a mixed-stage buffer: every stage in the first
    block, last-stage (stop) lanes, cap 96 in blocks of 32."""
    rng = np.random.default_rng(seed)
    T, W, d, n_rows, cap = 34, 4, 7, 200, 96
    eps = rng.uniform(0.4, 2.0, size=T), -rng.uniform(0.4, 2.0, size=T)
    kw = dict(order=np.arange(T), eps_pos=eps[0], eps_neg=eps[1], beta=0.0,
              costs=np.ones(T), chunk_t=W)
    jdplan = jde.DevicePlan.from_plan(JPlan(**kw), quant)
    dplan = DevicePlan.from_plan(CascadePlan(**kw), quant)
    feats = rng.integers(0, d, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(scale=0.6, size=(T, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(n_rows, d)).astype(np.float32)
    for r in range(10):  # ties: the value equals a threshold of its tree
        x[r, feats[r, depth - 1]] = thrs[r, depth - 1]
    stage = rng.integers(0, dplan.S, size=cap).astype(np.int32)
    stage[: dplan.S] = np.arange(dplan.S)
    return dict(
        jdplan=jdplan, dplan=dplan, x=x,
        jslabs=jmk.build_tree_slabs(jdplan, feats, thrs, leaves, quant=quant),
        slabs=mk.build_tree_slabs(dplan, feats, thrs, leaves, quant=quant, device="cpu"),
        stage=stage, rows=rng.permutation(n_rows)[:cap].astype(np.int64),
        g0=rng.normal(scale=0.5, size=cap).astype(np.float32),
    )


def _jax_lane_step(c, stage, stop, n_valid):
    jd = c["jdplan"]
    return jmk.mega_lane_pallas(
        c["jslabs"], jnp.asarray(c["x"])[c["rows"]],
        jmk.gather_lane_slabs(c["jslabs"], jnp.asarray(stage)),
        jnp.asarray(c["g0"]), jnp.asarray(jd.eps_pos[stage]), jnp.asarray(jd.eps_neg[stage]),
        jnp.asarray(stop), jnp.int32(n_valid), block_n=32, interpret=True,
    )


def _assert_step_equal(got, want):
    """(g, active, decided, exit_rel, pack, n_keep) equal, g bit for bit
    (up to the sign of a zero)."""
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_mega_lane_plain_tree_equals_pallas(depth, quant):
    """B7's plain version on trees of ``depth`` against ``mega_lane_pallas``
    in interpret mode: lanes at every stage, stop lanes, a partial live
    count; rows exit mid-block and some stop lane runs out active."""
    c = _step_inputs(depth, quant, seed=depth)
    dp = c["dplan"]
    stop = c["stage"] >= dp.S - 1
    n_valid = 80
    want = _jax_lane_step(c, c["stage"], stop, n_valid)
    _build.LAUNCHES.clear()
    got = mk.mega_lane(
        c["slabs"], _t(c["x"]), _t(c["rows"]), _t(c["g0"]), _t(c["stage"]), _t(stop),
        torch.tensor(n_valid, dtype=torch.int32), _t(dp.eps_pos), _t(dp.eps_neg), block_n=32,
    )
    assert sum(_build.LAUNCHES.values()) == 0
    _assert_step_equal(got, want)
    live = got[3][:n_valid]
    assert (live > 0).any() and (live == 0).any()
    assert ((got[1] == 1) & _t(stop)).any()


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_mega_stage_plain_tree_equals_uniform_lane_pallas(depth, quant):
    """B4's plain version on trees of ``depth`` against ``mega_lane_pallas``
    fed B4's step: every lane at a full stage, no stop lanes, a partial
    live count."""
    c = _step_inputs(depth, quant, seed=40 + depth)
    dp, cap = c["dplan"], c["g0"].shape[0]
    stage, n_valid = 4, 70
    want = _jax_lane_step(c, np.full(cap, stage, np.int32), np.zeros(cap, bool), n_valid)
    got = mk.mega_stage(
        c["slabs"], _t(c["x"])[_t(c["rows"])], _t(c["g0"]), stage, int(dp.stage_t0[stage]),
        torch.tensor(n_valid, dtype=torch.int32), _t(dp.eps_pos), _t(dp.eps_neg), block_n=32,
    )
    _assert_step_equal(got, want)
    assert (got[3][:n_valid] > 0).any() and (got[1][:n_valid] > 0).any()


@pytest.mark.parametrize("quant", QUANTS)
def test_run_stream_depth9_matches_jax(quant):
    """exp2_nomao's tree depth through ``run_stream`` (B7 fused) at each
    storage against JAX's: verdicts, exit, admission and decision steps,
    steps, occupancy and billing equal, ``g_final`` bit for bit; at f32 the
    verdicts equal ``evaluate_cascade``."""
    rng = np.random.default_rng(9)
    n, T, depth, d = 120, 20, 9, 10
    feats = rng.integers(0, d, size=(T, depth)).astype(np.int32)
    thrs = rng.uniform(size=(T, depth)).astype(np.float32)
    leaves = rng.normal(size=(T, 1 << depth)).astype(np.float32)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    F = apply_gbt_scores({"feats": _t(feats), "thrs": _t(thrs), "leaves": _t(leaves)}, _t(x))
    jm = j_fit(F.numpy().astype(np.float64), beta=0.0, alpha=0.02, mode="both")
    m = qwyc_model_from_numpy(jm.order, jm.eps_pos, jm.eps_neg, jm.beta, jm.costs, jm.alpha,
                              jm.mode)
    jdplan = jde.DevicePlan.from_plan(JPlan.from_qwyc(jm, chunk_t=4), quant)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4), quant)
    p = [a[np.asarray(jm.order)] for a in (feats, thrs, leaves)]
    jex = jde.DeviceExecutor(jdplan, jde.tree_stage_scorer(jdplan, *p, block_n=32, quant=quant),
                             block_n=32, megakernel=True)
    ex = DeviceExecutor(dplan, tree_stage_scorer(dplan, *p, block_n=32, quant=quant, device="cpu"),
                        block_n=32, megakernel=True, device="cpu")
    arr = np.sort(rng.integers(0, 10, size=n)).astype(np.int32)
    want = jex.run_stream(x, n, arrivals=arr, capacity=32)
    got = ex.run_stream(x, n, arrivals=arr, capacity=32)
    for k in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)), err_msg=k)
    assert (got.steps_run, got.scores_computed, got.scores_possible) == (
        want.steps_run, want.scores_computed, want.scores_possible)
    np.testing.assert_array_equal(np.asarray(got.g_final, np.float32).view(np.int32),
                                  np.asarray(want.g_final, np.float32).view(np.int32))
    assert (got.exit_step < m.T).any() and (got.admit_step > 0).any()
    if quant == "f32":
        np.testing.assert_array_equal(got.decisions, evaluate_cascade(m, F.numpy())["decisions"])


@pytest.mark.parametrize("name,limit", sorted(mk.MAX_TREE_DEPTH.items()))
def test_tree_depth_limits_are_named(name, limit):
    """The wrappers' shared depth check: B4 (``mega_stage``) takes trees
    whose staged leaf table fits a CTA, B7 (``mega_lane``) any depth its
    int leaf index reaches; past either the error names the limit."""
    for depth in (0, 5, 9, limit):
        mk.check_tree_depth(name, depth)
    for depth in (-1, limit + 1):
        with pytest.raises(ValueError, match=rf"{name}: tree depth {depth} not in \[0, {limit}\]"):
            mk.check_tree_depth(name, depth)
    assert mk.MAX_TREE_DEPTH["mega_stage"] == 15  # 2^15 f32 leaves: 128 KB of 227 KB


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111step_kernelINS_9TreeModelEfLb0EEEvNS_8StepArgsENS_7OutputsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111step_kernelINS_9TreeModelEfLb0EEEvNS_8StepArgsENS_7OutputsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111step_kernelINS_12LatticeModelILi8EEEaLb1EEEvNS_8StepArgsENS_7OutputsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111step_kernelINS_12LatticeModelILi8EEEaLb1EEEvNS_8StepArgsENS_7OutputsE
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_kernel_resources_read_the_ptxas_log():
    """``_build.parse_ptxas`` reads each kernel's registers and stack frame
    from an ``-Xptxas=-v`` build log, and ``step_kernel_label`` names the
    step kernels' instantiations."""
    got = _build.parse_ptxas(PTXAS_LOG)
    assert list(got.values()) == [dict(registers=40, stack=0, spill=0),
                                  dict(registers=128, stack=16, spill=16)]
    assert [_build.step_kernel_label(k) for k in got] == ["B4 tree f32", "B7 lattice S=8 int8"]
    assert _build.step_kernel_label("_ZN12_GLOBAL__N_116mega_lane_kernelIf") is None

