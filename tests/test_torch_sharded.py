"""The port's data-parallel sharded executor against the JAX package's.

The reference's ``ShardedDeviceExecutor`` needs several XLA devices, which
the tier-1 run does not have (its own sharded tests skip there).  So this
file is its own oracle script: a module-scoped fixture runs it as
``python tests/test_torch_sharded.py out.npz`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``, and the ``__main__`` block (which imports only the
JAX package, JAX and numpy) runs the reference with the matrix scorer and
``megakernel=False`` on the billing gate's fixtures (seed 2026 at 1/2/4
shards, rebalance off and on; the seed-2028/2029 streaming trace; the
seed-2032 ranking groups) and on the skewed seed-35 fixture, where the
rebalance fires.  The port (``device="cpu"``, every kernel's plain version)
must give the same decisions, exit steps, ``g_final`` bits, per-stage
billing, ``last_run_info`` arrays, rebalanced stages and traces.

The tree, lattice and fused paths cannot run in the reference's sharded
executor on the CPU (its Pallas batch step dies in interpret mode), so they
are held to the port's own ``DeviceExecutor`` (itself held to the
reference) and to ``evaluate_cascade``, at 1, 2 and 4 shards.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHARDS = (1, 2, 4)


# -- fixtures, shared by the oracle and the tests (numpy only) ---------------------


def gate_matrix():
    """The billing gate's seed-2026 (512, 32) score matrix."""
    rng = np.random.default_rng(2026)
    z = rng.normal(size=(512, 1))
    return (rng.normal(size=(512, 32)) * 0.7 + 0.4 * z).astype(np.float64)


def skewed_matrix(fit):
    """``tests/test_sharded.py``'s ``_skewed_setup`` (seed 35, n 512, T 24):
    the first quarter of the rows all exit at stage 1.  ``fit`` is a
    package's ``fit_qwyc``; returns (F, model)."""
    rng = np.random.default_rng(35)
    z = rng.normal(size=(512, 1))
    F = (rng.normal(size=(512, 24)) * 0.3 + 0.1 * z).astype(np.float64)
    m = fit(F, beta=0.0, alpha=0.01)
    F[:128, m.order[0]] = 50.0  # a guaranteed stage-1 positive exit
    return F, m


def stream_fixture():
    """The gate's seed-2027 linear ensemble (384 rows, T 24) and its
    seed-2029 arrival steps."""
    rng = np.random.default_rng(2027)
    W = rng.normal(size=(24, 8))
    X = rng.normal(size=(384, 8)).astype(np.float32)
    arr = np.sort(np.random.default_rng(2029).integers(0, 48, size=384)).astype(np.int32)
    return (X @ W.T).astype(np.float64), arr


def ranking_fixture():
    """The gate's seed-2032 ragged query groups: (F, sizes)."""
    rng = np.random.default_rng(2032)
    sizes = rng.integers(1, 17, size=24).astype(np.int64)
    qual = rng.exponential(1.0, size=int(sizes.sum()))
    return rng.normal(size=(int(sizes.sum()), 24)) * 0.1 + qual[:, None], sizes


BATCH_CASES = [
    (mode, shards, reb) for mode in ("both", "neg_only") for shards in SHARDS
    for reb in (False, True)
]
SKEW_CASES = [(order, reb) for order in ("plain", "sorted") for reb in (False, True)]
STREAM_CASES = [(shards, mk) for shards in (2, 4) for mk in (True, False)]


def _record(out, prefix, res, info, traces):
    out[f"{prefix}/decisions"] = np.asarray(res.decisions)
    out[f"{prefix}/exit_step"] = np.asarray(res.exit_step)
    out[f"{prefix}/g_bits"] = np.asarray(res.g_final, np.float32).view(np.int32)
    out[f"{prefix}/chunk_stats"] = np.array(
        [dataclasses.astuple(c) for c in res.chunk_stats], np.int64
    ).reshape(-1, 5)
    out[f"{prefix}/scores"] = np.int64(res.scores_computed)
    out[f"{prefix}/traces"] = np.int64(traces)
    for name in ("per_shard_n_in", "per_shard_final_live", "per_shard_scores"):
        out[f"{prefix}/{name}"] = np.asarray(info[name])
    out[f"{prefix}/stages_run"] = np.int64(info["stages_run"])
    out[f"{prefix}/rebalanced"] = np.asarray(info["rebalanced_stages"], np.int64)


def oracle(path):
    """The reference's sharded executor on every fixture -> ``path`` (npz)."""
    import jax

    from repro.core import CascadePlan, fit_qwyc
    from repro.kernels.device_executor import DevicePlan, matrix_stage_scorer
    from repro.kernels.sharded_executor import ShardedDeviceExecutor
    from repro.launch.mesh import make_serving_mesh
    from repro.ranking import fit_grouped
    from repro.ranking.bucketing import bucket_layout, group_offsets, pack_by_bucket

    if len(jax.devices()) < 4:
        raise SystemExit(f"the oracle needs 4 XLA devices, got {jax.devices()}")
    out = {}
    F = gate_matrix()
    for mode, shards, reb in BATCH_CASES:
        m = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
        dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=8))
        sx = ShardedDeviceExecutor(
            dplan, matrix_stage_scorer(dplan), make_serving_mesh(shards), block_n=64,
            rebalance=reb, megakernel=False,
        )
        res = sx.run(F[:, m.order].astype(np.float32), 512)
        info = sx.last_run_info
        # a smaller flush at the same capacity reuses the program
        sx.run(F[:300, m.order].astype(np.float32), 300, capacity=512)
        _record(out, f"batch/{mode}/{shards}/{reb}", res, info, sx.traces)
        out[f"batch/{mode}/order"] = np.asarray(m.order)
    Fk, mk_ = skewed_matrix(fit_qwyc)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(mk_, chunk_t=1))
    Fko = Fk[:, mk_.order].astype(np.float32)
    for order, reb in SKEW_CASES:
        row_order = None if order == "plain" else np.argsort(Fko[:, 0], kind="stable")
        sx = ShardedDeviceExecutor(
            dplan, matrix_stage_scorer(dplan), make_serving_mesh(4), block_n=32,
            rebalance=reb, megakernel=False,
        )
        res = sx.run(Fko, 512, row_order=row_order)
        _record(out, f"skew/{order}/{reb}", res, sx.last_run_info, sx.traces)
    out["skew/order"] = np.asarray(mk_.order)
    Fs, arr = stream_fixture()
    ms = fit_qwyc(Fs, beta=0.0, alpha=0.01)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(ms, chunk_t=6))
    for shards, mkf in STREAM_CASES:
        sx = ShardedDeviceExecutor(
            dplan, matrix_stage_scorer(dplan), make_serving_mesh(shards), block_n=32,
            megakernel=mkf,
        )
        r = sx.run_stream(Fs[:, ms.order].astype(np.float32), 384, arrivals=arr, capacity=64)
        p = f"stream/{shards}/{mkf}"
        for name in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
            out[f"{p}/{name}"] = np.asarray(getattr(r, name))
        out[f"{p}/g_bits"] = np.asarray(r.g_final, np.float32).view(np.int32)
        out[f"{p}/steps_run"] = np.int64(r.steps_run)
        out[f"{p}/capacity"] = np.int64(r.capacity)
        out[f"{p}/scores"] = np.int64(r.scores_computed)
        out[f"{p}/per_shard_occupancy"] = np.asarray(sx.last_run_info["per_shard_occupancy"])
        out[f"{p}/traces"] = np.int64(sx.traces)
    Fr, sizes = ranking_fixture()
    gp = fit_grouped(Fr, sizes, 3, alpha=0.05, chunk_t=6)
    gdplan = DevicePlan.from_plan(gp.plan)
    Ford = np.ascontiguousarray(Fr.astype(np.float32)[:, gp.plan.order])
    goff = group_offsets(sizes)
    packs = pack_by_bucket(sizes, gp.buckets)
    capq = max(len(g) for g in packs.values())
    for shards in (2, 4):
        sx = ShardedDeviceExecutor(
            gdplan, matrix_stage_scorer(gdplan), make_serving_mesh(shards), block_n=32,
            megakernel=False,
        )
        for b, gidx in sorted(packs.items()):
            rows_b, valid_b = bucket_layout(sizes[gidx], b, offsets=goff[gidx])
            r = sx.run_grouped(Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k,
                               capacity_groups=capq)
            p = f"grouped/{shards}/{b}"
            out[f"{p}/verdicts"] = np.asarray(r.verdicts)
            out[f"{p}/exit_stage"] = np.asarray(r.exit_stage)
            out[f"{p}/margin_bits"] = np.asarray(r.margin, np.float32).view(np.int32)
            out[f"{p}/scores"] = np.int64(r.scores_computed)
            out[f"{p}/chunk_stats"] = np.array(
                [dataclasses.astuple(c) for c in r.chunk_stats], np.int64
            ).reshape(-1, 5)
            for name in ("per_shard_n_in", "per_shard_final_live", "per_shard_scores"):
                out[f"{p}/{name}"] = np.asarray(sx.last_run_info[name])
        out[f"grouped/{shards}/traces"] = np.int64(sx.traces)
    np.savez(path, **out)


if __name__ == "__main__":
    oracle(sys.argv[1])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------------

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import CascadePlan, evaluate_cascade, fit_qwyc  # noqa: E402
from repro_torch.kernels.device_executor import (  # noqa: E402
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
)
from repro_torch.kernels.sharded_executor import (  # noqa: E402
    ShardedDeviceExecutor,
    critical_blocks,
)
from repro_torch.launch.mesh import batch_axes, make_serving_mesh  # noqa: E402
from repro_torch.ranking import fit_grouped  # noqa: E402
from repro_torch.ranking.bucketing import (  # noqa: E402
    bucket_layout,
    group_offsets,
    pack_by_bucket,
)

CPU = "cpu"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, from this file run as a script on 4 forced
    XLA host devices (about 15 s)."""
    path = tmp_path_factory.mktemp("sharded_oracle") / "ref.npz"
    env = dict(
        os.environ,
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu",
        PYTHONPATH=str(ROOT / "src"),
    )
    proc = subprocess.run(
        [sys.executable, __file__, str(path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        pytest.fail(f"the reference oracle failed (exit {proc.returncode}):\n{proc.stderr}")
    with np.load(path) as z:
        return dict(z)


def _executor(dplan, shards, **kw):
    return ShardedDeviceExecutor(
        dplan, matrix_stage_scorer(dplan, device=CPU), make_serving_mesh(shards, device=CPU),
        **kw,
    )


def _assert_recorded(ref, prefix, res, info, traces):
    got = {}
    _record(got, prefix, res, info, traces)
    for key, want in ((k, v) for k, v in ref.items() if k.startswith(prefix + "/")):
        np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("mode,shards,reb", BATCH_CASES)
def test_batch_matches_reference(ref, mode, shards, reb):
    """The gate's fixture at 1/2/4 shards, rebalance off and on: every
    result, the billing, ``last_run_info`` and the trace count."""
    F = gate_matrix()
    m = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
    np.testing.assert_array_equal(np.asarray(m.order), ref[f"batch/{mode}/order"])
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=8))
    sx = _executor(dplan, shards, block_n=64, rebalance=reb, megakernel=False)
    res = sx.run(F[:, m.order].astype(np.float32), 512)
    info = sx.last_run_info
    sx.run(F[:300, m.order].astype(np.float32), 300, capacity=512)
    _assert_recorded(ref, f"batch/{mode}/{shards}/{reb}", res, info, sx.traces)
    assert sx.traces == 1
    np.testing.assert_array_equal(res.decisions, evaluate_cascade(m, F)["decisions"])


@pytest.mark.parametrize("order,reb", SKEW_CASES)
def test_skewed_rebalance_matches_reference(ref, order, reb):
    """The skewed fixture at 4 shards: the rebalance fires at stage 0 and
    the port logs the same stages, occupancy and results."""
    F, m = skewed_matrix(fit_qwyc)
    np.testing.assert_array_equal(np.asarray(m.order), ref["skew/order"])
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=1))
    Fo = F[:, m.order].astype(np.float32)
    row_order = None if order == "plain" else np.argsort(Fo[:, 0], kind="stable")
    sx = _executor(dplan, 4, block_n=32, rebalance=reb, megakernel=False)
    res = sx.run(Fo, 512, row_order=row_order)
    _assert_recorded(ref, f"skew/{order}/{reb}", res, sx.last_run_info, sx.traces)
    assert bool(sx.last_run_info["rebalanced_stages"]) == reb
    if reb:
        assert 0 in sx.last_run_info["rebalanced_stages"]
        occ1 = sx.last_run_info["per_shard_n_in"][:, 1]
        assert occ1.max() - occ1.min() <= 1


def test_skewed_rebalance_cuts_critical_blocks(ref):
    """A stage is as slow as its fullest shard: with a sorted order the
    rebalance shortens the critical path (per-stage max live blocks,
    summed), in the port as in the reference."""
    F, m = skewed_matrix(fit_qwyc)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=1))
    Fo = F[:, m.order].astype(np.float32)
    order = np.argsort(Fo[:, 0], kind="stable")
    crit = {}
    for reb in (False, True):
        sx = _executor(dplan, 4, block_n=32, rebalance=reb)
        sx.run(Fo, 512, row_order=order)
        crit[reb] = critical_blocks(sx.last_run_info["per_shard_n_in"], 32)
        assert crit[reb] == critical_blocks(ref[f"skew/sorted/{reb}/per_shard_n_in"], 32)
    assert crit[True] < crit[False]


@pytest.mark.parametrize("shards,mk", STREAM_CASES)
def test_stream_matches_reference(ref, shards, mk):
    """``run_stream`` over per-shard rings (round-robin deal), fused (B7)
    and unfused (B6): verdicts, ``g_final`` bits, the timeline, occupancy,
    billing and traces."""
    Fs, arr = stream_fixture()
    ms = fit_qwyc(Fs, beta=0.0, alpha=0.01)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(ms, chunk_t=6))
    sx = _executor(dplan, shards, block_n=32, megakernel=mk)
    r = sx.run_stream(Fs[:, ms.order].astype(np.float32), 384, arrivals=arr, capacity=64)
    p = f"stream/{shards}/{mk}"
    for name in ("decisions", "exit_step", "admit_step", "done_step", "occupancy"):
        np.testing.assert_array_equal(getattr(r, name), ref[f"{p}/{name}"], err_msg=name)
    np.testing.assert_array_equal(r.g_final.view(np.int32), ref[f"{p}/g_bits"])
    assert (r.steps_run, r.capacity, r.scores_computed, sx.traces) == (
        ref[f"{p}/steps_run"], ref[f"{p}/capacity"], ref[f"{p}/scores"], ref[f"{p}/traces"]
    )
    np.testing.assert_array_equal(
        sx.last_run_info["per_shard_occupancy"], ref[f"{p}/per_shard_occupancy"]
    )


@pytest.mark.parametrize("shards", (2, 4))
def test_grouped_matches_reference(ref, shards):
    """``run_grouped`` with whole groups a shard, bucket by bucket: the
    verdicts, exit stages, margin bits, billing, occupancy and one program
    per bucket shape."""
    Fr, sizes = ranking_fixture()
    gp = fit_grouped(Fr, sizes, 3, alpha=0.05, chunk_t=6)
    gdplan = DevicePlan.from_plan(gp.plan)
    Ford = np.ascontiguousarray(Fr.astype(np.float32)[:, gp.plan.order])
    goff = group_offsets(sizes)
    packs = pack_by_bucket(sizes, gp.buckets)
    capq = max(len(g) for g in packs.values())
    sx = _executor(gdplan, shards, block_n=32, megakernel=False)
    for b, gidx in sorted(packs.items()):
        rows_b, valid_b = bucket_layout(sizes[gidx], b, offsets=goff[gidx])
        r = sx.run_grouped(Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k, capacity_groups=capq)
        p = f"grouped/{shards}/{b}"
        np.testing.assert_array_equal(r.verdicts, ref[f"{p}/verdicts"])
        np.testing.assert_array_equal(r.exit_stage, ref[f"{p}/exit_stage"])
        np.testing.assert_array_equal(r.margin.view(np.int32), ref[f"{p}/margin_bits"])
        assert r.scores_computed == ref[f"{p}/scores"]
        np.testing.assert_array_equal(
            np.array([dataclasses.astuple(c) for c in r.chunk_stats]).reshape(-1, 5),
            ref[f"{p}/chunk_stats"],
        )
        for name in ("per_shard_n_in", "per_shard_final_live", "per_shard_scores"):
            np.testing.assert_array_equal(sx.last_run_info[name], ref[f"{p}/{name}"])
    assert sx.traces == ref[f"grouped/{shards}/traces"] == len(packs)


# -- paths the reference cannot run here: held to the port's DeviceExecutor ---------


def _same(a, b):
    """Equal results and billing (``ExecutorResult`` or ``StreamResult``)."""
    np.testing.assert_array_equal(a.decisions, b.decisions)
    np.testing.assert_array_equal(a.exit_step, b.exit_step)
    np.testing.assert_array_equal(
        np.asarray(a.g_final, np.float32).view(np.int32),
        np.asarray(b.g_final, np.float32).view(np.int32),
    )


@pytest.fixture(scope="module")
def ensembles():
    """A GBT (T 24, depth 4) and a lattice ensemble (T 16, S 3) on adult at
    scale 0.05, their scorers and fits on the train scores."""
    from repro_torch.api.scorers import LatticeScorer, TreeScorer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.ensembles.gbt import train_gbt
    from repro_torch.ensembles.lattice import init_lattice_ensemble
    from repro_torch.kernels import ops

    ds = make_dataset("adult", scale=0.05)
    gbt = train_gbt(ds.x_train, ds.y_train, n_trees=24, depth=4, device=CPU)
    lat = init_lattice_ensemble(16, ds.D, S=3, seed=0, device=CPU)
    xtr = torch.from_numpy(ds.x_train)
    out = {"x": ds.x_test.astype(np.float32)}
    for name, scores, sc, beta in (
        ("tree", ops.gbt_scores(gbt.feats, gbt.thrs, gbt.leaves, xtr),
         TreeScorer(gbt.feats, gbt.thrs, gbt.leaves, block_n=32), -gbt.base_score),
        ("lattice", ops.lattice_scores(lat["theta"], lat["feats"], xtr),
         LatticeScorer(lat["theta"], lat["feats"], block_n=32), 0.0),
    ):
        F = scores.numpy().astype(np.float64)
        m = fit_qwyc(F, beta=beta, alpha=0.02)
        out[name] = (sc, m)
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("family", ["tree", "lattice"])
def test_batch_scorers_match_device_executor(ensembles, family, shards, fused):
    """Tree and lattice scorers, fused (B4) and unfused (B3/B5 + B2's step
    form), sorted order with rebalance: the 1-D loop's results bit for bit
    and ``evaluate_cascade``'s verdicts; one shard bills as the 1-D loop."""
    sc, m = ensembles[family]
    x = ensembles["x"]
    n = x.shape[0]
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    bound = sc.bind(dplan, device=CPU)
    one = DeviceExecutor(dplan, bound, block_n=32, megakernel=fused, device=CPU).run(x, n)
    order = np.argsort(one.exit_step, kind="stable")  # easy rows on the first shards
    sx = ShardedDeviceExecutor(
        dplan, bound, make_serving_mesh(shards, device=CPU), block_n=32, megakernel=fused,
        rebalance=True,
    )
    res = sx.run(x, n, row_order=order)
    _same(res, one)
    if shards == 1:
        assert res.chunk_stats == one.chunk_stats and sx.last_run_info["rebalanced_stages"] == []
    info = sx.last_run_info
    assert info["per_shard_n_in"].sum(axis=0).tolist() == [c.n_in for c in res.chunk_stats]
    assert info["per_shard_scores"].sum() == res.scores_computed


@pytest.mark.parametrize("shards", SHARDS)
def test_stream_tree_fused_matches_batch(ensembles, shards):
    """The fused streaming step (B7 tree) over per-shard rings gives the
    batch loop's verdicts, exits and ``g_final`` bits; at one shard the
    1-D streaming loop's whole timeline."""
    sc, m = ensembles["tree"]
    x = ensembles["x"]
    n = x.shape[0]
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    bound = sc.bind(dplan, device=CPU)
    arr = np.sort(np.random.default_rng(2028).integers(0, 12, size=n))
    dex = DeviceExecutor(dplan, bound, block_n=32, device=CPU)
    batch = dex.run(x, n)
    one = dex.run_stream(x, n, arrivals=arr, capacity=64)
    sx = ShardedDeviceExecutor(dplan, bound, make_serving_mesh(shards, device=CPU), block_n=32)
    r = sx.run_stream(x, n, arrivals=arr, capacity=64)
    _same(r, batch)
    assert sx.megakernel and sx.traces == 1
    assert r.capacity == shards * -(-(-(-64 // shards)) // 32) * 32
    assert sx.last_run_info["per_shard_admitted"].tolist() == [
        len(range(k, n, shards)) for k in range(shards)
    ]
    if shards == 1:
        for name in ("admit_step", "done_step", "occupancy"):
            np.testing.assert_array_equal(getattr(r, name), getattr(one, name))
        assert (r.steps_run, r.scores_computed) == (one.steps_run, one.scores_computed)


def test_one_shard_grouped_equals_device_executor():
    """``run_grouped`` at one shard: the 1-D loop's verdicts, margins,
    billing and trace count."""
    Fr, sizes = ranking_fixture()
    gp = fit_grouped(Fr, sizes, 3, alpha=0.05, chunk_t=6)
    gdplan = DevicePlan.from_plan(gp.plan)
    Ford = np.ascontiguousarray(Fr.astype(np.float32)[:, gp.plan.order])
    goff = group_offsets(sizes)
    dex = DeviceExecutor(gdplan, matrix_stage_scorer(gdplan, device=CPU), block_n=32, device=CPU)
    sx = _executor(gdplan, 1, block_n=32)
    for b, gidx in sorted(pack_by_bucket(sizes, gp.buckets).items()):
        rows_b, valid_b = bucket_layout(sizes[gidx], b, offsets=goff[gidx])
        args = (Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k)
        a, r = dex.run_grouped(*args), sx.run_grouped(*args)
        np.testing.assert_array_equal(a.verdicts, r.verdicts)
        np.testing.assert_array_equal(a.exit_stage, r.exit_stage)
        np.testing.assert_array_equal(a.margin.view(np.int32), r.margin.view(np.int32))
        assert (a.chunk_stats, a.scores_computed) == (r.chunk_stats, r.scores_computed)
    assert sx.traces == dex.traces


def test_neural_state_migrates_with_rebalance():
    """A stateful scorer (a 4-layer ``NeuralScorer``, exit every layer) at 2
    shards with rebalance: the sorted order drains shard 0 first, the
    rebalance fires and moves the residual streams with their rows, and
    the verdicts and exits equal the 1-D loop's; ``g_final`` within 1e-5
    (the per-shard matmuls run at another row count)."""
    from repro_torch import api
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_params

    cfg = ModelConfig(
        name="tiny", arch_type="dense", n_layers=4, d_model=16, n_heads=2, n_kv_heads=1,
        head_dim=8, d_ff=32, vocab_size=32, exit_interval=1,
    )
    params = init_params(cfg, torch.Generator().manual_seed(5), device=CPU)
    toks = np.random.default_rng(6).integers(0, 32, size=(96, 8))
    sc = api.NeuralScorer(params, cfg, seq_len=8)
    fitted = api.fit(sc, toks, alpha=0.2, chunk_t=1, device=CPU)
    dplan = DevicePlan.from_plan(fitted.plan())
    bound = sc.bind(dplan, device=CPU)
    one = DeviceExecutor(dplan, bound, block_n=8, device=CPU).run(toks, 96)
    assert (one.exit_step < dplan.plan.T).any()
    order = np.argsort(one.exit_step, kind="stable")
    sx = ShardedDeviceExecutor(dplan, bound, make_serving_mesh(2, device=CPU), block_n=8,
                               rebalance=True)
    r = sx.run(toks, 96, row_order=order)
    assert sx.last_run_info["rebalanced_stages"], "the rebalance never fired"
    np.testing.assert_array_equal(r.decisions, one.decisions)
    np.testing.assert_array_equal(r.exit_step, one.exit_step)
    np.testing.assert_allclose(r.g_final, one.g_final, rtol=0, atol=1e-5)
    s = sx.run_stream(toks, 96, capacity=16)
    np.testing.assert_array_equal(s.decisions, one.decisions)
    np.testing.assert_array_equal(s.exit_step, one.exit_step)


# -- validation, the mesh and the empty batch ---------------------------------------


def test_serving_mesh_and_validation_errors():
    """The mesh's shape and its checks; the executor's refusals as the
    reference's; an empty batch."""
    from repro_torch.launch.mesh import ServingMesh

    mesh = make_serving_mesh(3, device=CPU)
    assert (mesh.axis_names, mesh.shape, batch_axes(mesh)) == (("data",), {"data": 3}, ("data",))
    for bad in ((0, 1), (2, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            make_serving_mesh(*bad, device=CPU)
    # a model axis gives the 2-D mesh, and the executor runs on it
    mesh2 = make_serving_mesh(2, model_shards=2, device=CPU)
    assert (mesh2.axis_names, mesh2.shape, batch_axes(mesh2)) == (
        ("data", "model"), {"data": 2, "model": 2}, ("data",))
    m = fit_qwyc(gate_matrix(), beta=0.0, alpha=0.01)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=8))
    scorer = matrix_stage_scorer(dplan, device=CPU)
    two_d = ServingMesh(("data", "model"), {"data": 2, "model": 2}, torch.device(CPU))
    sx2 = ShardedDeviceExecutor(dplan, scorer, two_d)
    assert (sx2.shards, sx2.model_shards, sx2.megakernel) == (2, 2, False)
    r2 = sx2.run(gate_matrix()[:, m.order].astype(np.float32), 512)
    np.testing.assert_array_equal(r2.decisions, evaluate_cascade(m, gate_matrix())["decisions"])
    assert sx2.last_run_info["mesh_shape"] == (2, 2)
    with pytest.raises(ValueError, match="'data' axis"):
        ShardedDeviceExecutor(dplan, scorer, ServingMesh(("x",), {"x": 2}, torch.device(CPU)))
    sx = _executor(dplan, 4, block_n=64)
    Fo = gate_matrix()[:, m.order].astype(np.float32)
    with pytest.raises(ValueError, match="capacity 100 cannot hold n=512 rows on a 4-shard"):
        sx.run(Fo, 512, capacity=100)
    with pytest.raises(ValueError, match=r"row_order must be a \(512,\)-shaped"):
        sx.run(Fo, 512, row_order=np.arange(10))
    with pytest.raises(ValueError, match="arrivals must be nondecreasing"):
        sx.run_stream(Fo, 512, arrivals=np.arange(512)[::-1])
    empty = sx.run(Fo, 0)
    assert empty.decisions.shape == (0,) and empty.scores_computed == 0 and sx.traces == 0
    assert sx.run_stream(Fo, 0).capacity == 4 * 64
    with pytest.raises(ValueError, match="megakernel=True needs a scorer with ParamSlabs"):
        ShardedDeviceExecutor(
            dplan, dataclasses.replace(scorer, slabs=None), make_serving_mesh(2, device=CPU),
            megakernel=True,
        )


# -- the front door: servers, compile, the ladder ------------------------------------


def _serve_rows(server, x, arrivals=None):
    for i, row in enumerate(x):
        if arrivals is None:
            server.submit(row)
        else:
            server.submit(row, arrival=float(arrivals[i]))
    return server.drain()


def _verdicts(results):
    return [(r["decision"], r["models_evaluated"]) for r in results]


@pytest.mark.parametrize("policy", ["kernel", "sorted-kernel"])
@pytest.mark.parametrize("shards", (2, 4))
def test_server_sharded_matches_device_server(ensembles, shards, policy):
    """``QWYCServer(exec_backend="sharded")`` with the lazy tree scorer: a
    flush serves ``shards x batch_size`` rows, every verdict and model
    count equals the device server's, and the billing is the sharded
    loop's."""
    from repro_torch.serving.engine import QWYCServer

    sc, m = ensembles["tree"]
    x = ensembles["x"]
    kw = dict(scorer=sc, batch_size=16, backend=policy, chunk_t=4, block_n=32,
              audit_full_scores=False, device=CPU)
    want = _serve_rows(QWYCServer(m, exec_backend="device", **kw), x)
    srv = QWYCServer(m, exec_backend="sharded",
                     backend_opts={"shards": shards, "rebalance": True}, **kw)
    got = _serve_rows(srv, x)
    assert _verdicts(got) == _verdicts(want)
    assert srv.flush_size == 16 * shards and srv.n_shards == shards and srv.rebalance
    assert srv.stats.n_batches == -(-len(x) // (16 * shards))
    ex = srv._dev[0]
    assert isinstance(ex, ShardedDeviceExecutor) and ex.traces == 1
    assert sum(r.scores_computed for r in srv.flush_results) <= srv.stats.scores_computed


def test_streaming_server_sharded_matches_device_server(ensembles):
    """``StreamingServer`` sharded at 4: every verdict equals the device
    server's; the lanes are ``4 x batch_size`` (block-padded a shard)."""
    from repro_torch.serving.engine import StreamingServer

    sc, m = ensembles["tree"]
    x = ensembles["x"]
    arrivals = np.cumsum(np.random.default_rng(2028).exponential(0.25, size=len(x)))
    kw = dict(scorer=sc, batch_size=32, chunk_t=4, block_n=32, audit_full_scores=False,
              device=CPU)
    want = _serve_rows(StreamingServer(m, exec_backend="device", **kw), x, arrivals)
    srv = StreamingServer(m, exec_backend="sharded", backend_opts={"shards": 4}, **kw)
    got = _serve_rows(srv, x, arrivals)
    assert _verdicts(got) == _verdicts(want)
    assert srv.stats.admitted_rows == len(x)
    assert all(r.capacity == 4 * 32 for r in srv.stream_results)


def test_server_sharded_spellings_and_refusals(ensembles):
    """``mesh=`` and a shard count under ``"auto"`` mean the sharded
    backend; ``rebalance`` / ``shards`` on the device backend and a model
    axis are refused."""
    from repro_torch.serving.engine import QWYCServer

    sc, m = ensembles["tree"]
    kw = dict(scorer=sc, batch_size=16, chunk_t=4, device=CPU)
    srv = QWYCServer(m, mesh=make_serving_mesh(3, device=CPU), rebalance=True, **kw)
    assert (srv.exec.name, srv.n_shards, srv.flush_size, srv.rebalance) == ("sharded", 3, 48, True)
    assert QWYCServer(m, backend_opts={"shards": 2}, **kw).exec.name == "sharded"
    assert QWYCServer(m, **kw).exec.name == "device"
    with pytest.raises(ValueError, match="rebalance=True requires the sharded backend"):
        QWYCServer(m, exec_backend="device", rebalance=True, **kw)
    with pytest.raises(ValueError, match="mesh/shards require a data-parallel backend"):
        QWYCServer(m, exec_backend="device", backend_opts={"shards": 2}, **kw)
    # a model axis: the server's mesh is 2-D and its flush the data axis's
    srv2 = QWYCServer(m, backend_opts={"shards": 2, "model_shards": 2}, **kw)
    assert (srv2.exec.name, srv2.mesh.shape, srv2.n_shards, srv2.flush_size) == (
        "sharded", {"data": 2, "model": 2}, 2, 32)


def test_compile_sharded_evaluate_serve_and_rank():
    """``compile("sharded", shards=4)``: ``evaluate`` equals the device
    rung's, ``serve()`` carries the shards to its server, ``rank()`` goes
    through the sharded grouped loop and equals the device rung's; grouped
    streaming has no sharded path; ``"auto"`` on the CPU is the device
    rung, which refuses shard options."""
    from repro_torch import api

    F = gate_matrix()
    fitted = api.fit(F, alpha=0.01, chunk_t=8)
    c = fitted.compile("sharded", shards=4, rebalance=True, device=CPU)
    assert (c.backend_name, c._executor.shards, c._executor.rebalance) == ("sharded", 4, True)
    _same(c.evaluate(scores=F), fitted.compile("device", device=CPU).evaluate(scores=F))
    srv = c.serve(score_fn=lambda x: x, batch_size=32)  # the rows are their own scores
    assert (srv.exec.name, srv.n_shards, srv.flush_size) == ("sharded", 4, 128)
    with pytest.raises(ValueError, match="require a data-parallel backend"):
        fitted.compile("auto", shards=2, device=CPU)
    Fr, sizes = ranking_fixture()
    ranked = api.fit(Fr, groups=sizes, topk=3, alpha=0.05, chunk_t=6)
    rs = ranked.compile("sharded", shards=4, device=CPU)
    assert rs.rank(scores=Fr, groups=sizes) == ranked.compile("device", device=CPU).rank(
        scores=Fr, groups=sizes
    )
    assert isinstance(rs._executor, ShardedDeviceExecutor) and rs.traces >= 1
    with pytest.raises(ValueError, match="no grouped streaming path"):
        rs.serve(streaming=True)


def test_drop_device_falls_sharded_to_device(ensembles):
    """``FaultPlan(drop_device=True)``: a named sharded compile is refused
    with the loss as its reason, and a sharded server's waves fall one rung
    to the device loop, logged as a ``DegradationEvent``, with every
    verdict the device server's."""
    from repro_torch import api
    from repro_torch.api.backends import BackoffPolicy
    from repro_torch.serving.engine import QWYCServer
    from repro_torch.testing import FaultPlan

    F = gate_matrix()
    with FaultPlan(seed=7, drop_device=True):
        with pytest.raises(ValueError, match="unavailable here: injected device loss"):
            api.fit(F, alpha=0.01).compile("sharded", shards=4, device=CPU)
    sc, m = ensembles["tree"]
    x = ensembles["x"]
    kw = dict(scorer=sc, batch_size=16, chunk_t=4, audit_full_scores=False, device=CPU,
              backoff=BackoffPolicy(retries=1), sleep=lambda s: None)
    want = _serve_rows(QWYCServer(m, exec_backend="device", **kw), x)
    srv = QWYCServer(m, exec_backend="sharded", backend_opts={"shards": 4, "rebalance": True},
                     **kw)
    with FaultPlan(seed=7, drop_device=True, wave_failures=10_000, wave_fail_backend="sharded"):
        got = _serve_rows(srv, x)
    assert srv.exec.name == "device" and not srv.rebalance
    assert [(e.kind, e.from_backend, e.to_backend) for e in srv.stats.degradation_events] == [
        ("wave", "sharded", "device")
    ]
    assert _verdicts(got) == _verdicts(want)


# -- on the card (marked cuda: they skip without one) --------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _runs(make, run, device):
    """``run`` three times on one executor (eager, captured, replayed), and
    once on ``capture=False`` -> (results, the executor, the launches of
    the replay)."""
    from repro_torch.kernels import _build

    ex = make(device, True)
    out = [run(ex), run(ex)]
    _build.LAUNCHES.clear()
    out.append(run(ex))
    torch.cuda.synchronize()
    launched = dict(_build.LAUNCHES)
    out.append(run(make(device, False)))
    return out, ex, launched


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("reb", [False, True])
@pytest.mark.parametrize("shards", (2, 4))
def test_batch_on_card_equals_cpu(card, ensembles, shards, reb, fused):
    """The batch loop on the card, eager, captured and replayed and with
    ``capture=False``, equals the CPU bit for bit; a replay launches the
    stage kernel once a shard and a stage."""
    sc, m = ensembles["tree"]
    x = ensembles["x"]
    n = x.shape[0]
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    order = np.argsort(x[:, 0], kind="stable")

    def make(device, capture):
        return ShardedDeviceExecutor(
            dplan, sc.bind(dplan, device=device), make_serving_mesh(shards, device=device),
            block_n=32, megakernel=fused, rebalance=reb, capture=capture,
        )

    runs, ex, launched = _runs(make, lambda e: e.run(x, n, row_order=order), card)
    cpu_ex = make("cpu", False)
    want = cpu_ex.run(x, n, row_order=order)
    for r in runs:
        _same(r, want)
        assert r.chunk_stats == want.chunk_stats
    assert ex.last_run_info["rebalanced_stages"] == cpu_ex.last_run_info["rebalanced_stages"]
    assert ex.traces == 1 and len(ex._graphs) == 1
    stage = "mega_stage_tree" if fused else "cascade_chunk_step"
    assert launched[stage] == shards * dplan.S


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shards", (2, 4))
def test_stream_on_card_equals_cpu(card, ensembles, shards, fused):
    """The streaming loop on the card (B7, or the lanes and B6) equals the
    CPU bit for bit, timeline included, captured and not."""
    sc, m = ensembles["tree"]
    x = ensembles["x"]
    n = x.shape[0]
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(m, chunk_t=4))
    arr = np.sort(np.random.default_rng(2028).integers(0, 12, size=n))

    def make(device, capture):
        return ShardedDeviceExecutor(
            dplan, sc.bind(dplan, device=device), make_serving_mesh(shards, device=device),
            block_n=32, megakernel=fused, capture=capture,
        )

    def run(e):
        return e.run_stream(x, n, arrivals=arr, capacity=64)

    runs, ex, launched = _runs(make, run, card)
    want = run(make("cpu", False))
    for r in runs:
        _same(r, want)
        for name in ("admit_step", "done_step", "occupancy"):
            np.testing.assert_array_equal(getattr(r, name), getattr(want, name))
        assert (r.steps_run, r.scores_computed) == (want.steps_run, want.scores_computed)
    assert launched == {("mega_lane_tree" if fused else "cascade_lane"):
                        shards * runs[2].steps_enqueued}


@pytest.mark.cuda
@pytest.mark.parametrize("shards", (2, 4))
def test_grouped_on_card_equals_cpu(card, shards):
    """The grouped loop on the card (B8 once a shard a stage and for the
    epilogue) equals the CPU bit for bit, captured and not."""
    Fr, sizes = ranking_fixture()
    gp = fit_grouped(Fr, sizes, 3, alpha=0.05, chunk_t=6)
    gdplan = DevicePlan.from_plan(gp.plan)
    Ford = np.ascontiguousarray(Fr.astype(np.float32)[:, gp.plan.order])
    goff = group_offsets(sizes)
    b, gidx = max(pack_by_bucket(sizes, gp.buckets).items())
    rows_b, valid_b = bucket_layout(sizes[gidx], b, offsets=goff[gidx])

    def make(device, capture):
        return ShardedDeviceExecutor(
            gdplan, matrix_stage_scorer(gdplan, device=device),
            make_serving_mesh(shards, device=device), block_n=32, capture=capture,
        )

    def run(e):
        return e.run_grouped(Ford, rows_b, valid_b, len(gidx), gp.eps_g, gp.k)

    runs, ex, launched = _runs(make, run, card)
    want = run(make("cpu", False))
    for r in runs:
        np.testing.assert_array_equal(r.verdicts, want.verdicts)
        np.testing.assert_array_equal(r.exit_stage, want.exit_stage)
        np.testing.assert_array_equal(r.margin.view(np.int32), want.margin.view(np.int32))
        assert r.scores_computed == want.scores_computed
    assert launched == {"cascade_group": shards * (gdplan.S + 1)}
