"""The port's 2-D ``("data", "model")`` sharded executor against the JAX
package's (``tests/test_mesh2d.py``, case for case).

The reference's 2-D executor needs D x M XLA devices, so this file is its
own oracle script, as ``tests/test_torch_sharded.py`` is: a module-scoped
fixture runs it as ``python tests/test_torch_mesh2d.py out.npz`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``; the ``__main__`` block (the JAX package, JAX and
numpy only) runs the reference's executor with the matrix scorer at 1x4,
2x2 and 4x1 (``both`` and ``neg_only``) and the splits that do not divide
(W 3 over 2, W 8 over 3).  The reference's tree and lattice score kernels
do not run on the CPU, so the port's tree and lattice scorers are held to
the reference's 2-D matrix executor fed with the cascade-ordered matrix of
``apply_gbt_scores`` / ``apply_lattice_scores`` (same ``block_n``), and to
the port's own data-axis executor.  The port runs on the CPU (``device="cpu"``, every
kernel's plain version): decisions and exits equal, ``g_final`` bit for
bit, and ``scores_computed``, stages, psums and traces equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = ((1, 4), (2, 2), (4, 1))
MATRIX_CASES = [(mode, d, m) for mode in ("both", "neg_only") for d, m in MESH_SHAPES]
SCORER_CASES = [(family, d, m) for family in ("tree", "lattice") for d, m in ((2, 2), (1, 4))]
# (name, T, chunk_t, data shards, model shards): W 3 over 2 (w_local 2,
# w_global 4) and W 8 over 3 (w_local 3, w_global 9)
NONDIV_CASES = [("w3m2", 21, 3, 2, 2), ("w8m3", 24, 8, 1, 3)]
BLOCK = 32


# -- fixtures, shared by the oracle and the tests (numpy only) ---------------------


def score_matrix(seed: int, n: int = 400, t: int = 24) -> np.ndarray:
    """``tests/conftest.py``'s ``make_scores``: a random additive-ensemble
    score matrix with a shared per-example signal."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 1))
    return (rng.normal(size=(n, t)) * 0.7 + 0.4 * z).astype(np.float64)


def scorer_fixture(family: str):
    """Seeded params and inputs: 16 oblivious trees of depth 3 over 8
    features, or 16 lattices over 3 of 6 features; 192 rows."""
    rng = np.random.default_rng(42 if family == "tree" else 51)
    t, n = 16, 192
    if family == "tree":
        params = {
            "feats": rng.integers(0, 8, size=(t, 3)).astype(np.int32),
            "thrs": rng.uniform(size=(t, 3)).astype(np.float32),
            "leaves": rng.normal(size=(t, 8)).astype(np.float32),
        }
        x = rng.uniform(size=(n, 8)).astype(np.float32)
    else:
        params = {
            "theta": rng.normal(size=(t, 8)).astype(np.float32),
            "feats": np.stack([rng.choice(6, size=3, replace=False) for _ in range(t)])
            .astype(np.int32),
        }
        x = rng.uniform(size=(n, 6)).astype(np.float32)
    return params, x


def _record(out, prefix, res, sx):
    """One run's results and accounting under ``prefix``."""
    info = sx.last_run_info
    out[f"{prefix}/decisions"] = np.asarray(res.decisions)
    out[f"{prefix}/exit_step"] = np.asarray(res.exit_step)
    out[f"{prefix}/g_bits"] = np.asarray(res.g_final, np.float32).view(np.int32)
    out[f"{prefix}/chunk_stats"] = np.array(
        [dataclasses.astuple(c) for c in res.chunk_stats], np.int64
    ).reshape(-1, 5)
    out[f"{prefix}/scores"] = np.int64(res.scores_computed)
    out[f"{prefix}/stages"] = np.int64(info["stages_run"])
    out[f"{prefix}/per_shard_n_in"] = np.asarray(info["per_shard_n_in"])
    out[f"{prefix}/per_shard_scores"] = np.asarray(info["per_shard_scores"])
    for name in ("per_coord_scores", "per_coord_psums", "per_coord_stages"):
        if name in info:
            out[f"{prefix}/{name}"] = np.asarray(info[name])


def oracle(path):
    """The reference's 2-D executor on every fixture -> ``path`` (npz)."""
    import jax
    import jax.numpy as jnp

    from repro.core import CascadePlan, fit_qwyc
    from repro.ensembles.gbt import apply_gbt_scores
    from repro.ensembles.lattice import apply_lattice_scores
    from repro.kernels.device_executor import DevicePlan, matrix_stage_scorer
    from repro.kernels.sharded_executor import ShardedDeviceExecutor
    from repro.launch.mesh import make_serving_mesh

    if len(jax.devices()) < 4:
        raise SystemExit(f"the oracle needs 4 XLA devices, got {jax.devices()}")

    def executor(dplan, d, m):
        return ShardedDeviceExecutor(
            dplan, matrix_stage_scorer(dplan), make_serving_mesh(d, m), block_n=BLOCK,
            megakernel=False,
        )

    out = {}
    for mode, d, m in MATRIX_CASES:
        F = score_matrix(41)
        qm = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
        dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=8))
        Fo = F[:, qm.order].astype(np.float32)
        sx = executor(dplan, d, m)
        res = sx.run(Fo, 400)
        p = f"matrix/{mode}/{d}x{m}"
        _record(out, p, res, sx)
        # repeats, a permuted order and a partial flush at the pinned
        # capacity run the same program
        sx.run(Fo, 400)
        perm = np.random.default_rng(7).permutation(400)
        out[f"{p}/perm_exit_step"] = np.asarray(sx.run(Fo, 400, row_order=perm).exit_step)
        out[f"{p}/small_exit_step"] = np.asarray(sx.run(Fo[:100], 100, capacity=400).exit_step)
        out[f"{p}/traces"] = np.int64(sx.traces)
        out[f"matrix/{mode}/order"] = np.asarray(qm.order)
    for name, t, chunk_t, d, m in NONDIV_CASES:
        F = score_matrix(43, t=t)
        qm = fit_qwyc(F, beta=0.0, alpha=0.01)
        dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=chunk_t))
        sx = executor(dplan, d, m)
        _record(out, f"nondiv/{name}", sx.run(F[:, qm.order].astype(np.float32), 400), sx)
        out[f"nondiv/{name}/w"] = np.array([sx._w_local, sx._w_global])
    for family, d, m in SCORER_CASES:
        params, x = scorer_fixture(family)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        apply = apply_gbt_scores if family == "tree" else apply_lattice_scores
        F = np.asarray(apply(jp, jnp.asarray(x)))
        qm = fit_qwyc(F.astype(np.float64), beta=0.0, alpha=0.02)
        dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=4))
        sx = executor(dplan, d, m)
        p = f"{family}/{d}x{m}"
        _record(out, p, sx.run(np.ascontiguousarray(F[:, qm.order]), x.shape[0]), sx)
        out[f"{family}/F_bits"] = F.view(np.int32)
        out[f"{family}/order"] = np.asarray(qm.order)
    np.savez(path, **out)


if __name__ == "__main__":
    oracle(sys.argv[1])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------------

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import CascadePlan, evaluate_cascade, fit_qwyc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.device_executor import (  # noqa: E402
    DeviceExecutor,
    DevicePlan,
    lattice_stage_scorer,
    matrix_stage_scorer,
    tree_stage_scorer,
)
from repro_torch.kernels.sharded_executor import ShardedDeviceExecutor  # noqa: E402
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh  # noqa: E402
from repro_torch.launch.shardings import (  # noqa: E402
    model_stacked_shards,
    split_columns,
    stage_column_slices,
)

CPU = "cpu"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, from this file run as a script on 4 forced
    XLA host devices."""
    path = tmp_path_factory.mktemp("mesh2d_oracle") / "ref.npz"
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


def _executor(dplan, d, m, scorer=None, **kw):
    scorer = matrix_stage_scorer(dplan, device=CPU) if scorer is None else scorer
    return ShardedDeviceExecutor(
        dplan, scorer, make_serving_mesh(d, m, device=CPU), block_n=kw.pop("block_n", BLOCK),
        **kw,
    )


def _assert_recorded(ref, prefix, res, sx):
    got = {}
    _record(got, prefix, res, sx)
    keys = [k for k in ref if k.startswith(prefix + "/") and k in got]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _fit(mode="both", seed=41, t=24, chunk_t=8):
    F = score_matrix(seed, t=t)
    qm = fit_qwyc(F, beta=0.0, alpha=0.01, mode=mode)
    return F, qm, DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=chunk_t))


# -- slab partitioning (launch/shardings.py) ----------------------------------------


def test_split_columns_equals_reference():
    from repro.launch import shardings as j_sh

    for w, m in ((8, 1), (8, 2), (8, 3), (3, 2), (8, 8), (1, 1), (13, 4)):
        assert split_columns(w, m) == j_sh.split_columns(w, m)
    assert split_columns(8, 3) == (3, 9)
    with pytest.raises(ValueError, match="model_shards"):
        split_columns(8, 0)
    with pytest.raises(ValueError, match="width"):
        split_columns(0, 2)


@pytest.mark.parametrize("width,m", [(3, 2), (8, 3), (8, 4), (4, 1)])
def test_stage_column_slices_equal_reference(width, m):
    """out[j, s, c] == param[t0[s] + j * w_local + c], zeros past T, as the
    reference's, from numpy and from a tensor, dtypes kept."""
    from repro.launch import shardings as j_sh

    rng = np.random.default_rng(0)
    t0 = np.arange(0, 10, width)
    w_l, w_g = split_columns(width, m)
    for param in (rng.normal(size=(10, 3)).astype(np.float32),
                  rng.integers(0, 9, size=(10, 2)).astype(np.int32)):
        want = np.asarray(j_sh.stage_column_slices(param, t0, w_l, w_g))
        got = stage_column_slices(param, t0, w_l, w_g)
        assert got.dtype == torch.from_numpy(param).dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            stage_column_slices(torch.from_numpy(param), t0, w_l, w_g).numpy(), want
        )
    mesh = make_serving_mesh(1, m, device=CPU)
    sl = {"p": stage_column_slices(param, t0, w_l, w_g)}
    parts = model_stacked_shards(sl, mesh)
    assert len(parts) == m and all(p["p"].is_contiguous() for p in parts)
    for j, p in enumerate(parts):
        assert torch.equal(p["p"], sl["p"][j])
    if m > 1:
        with pytest.raises(ValueError, match="'model' axis"):
            model_stacked_shards(sl, make_serving_mesh(1, m + 1, device=CPU))


# -- parity across the mesh shapes ---------------------------------------------------


@pytest.mark.parametrize("mode,d,m", MATRIX_CASES)
def test_mesh2d_matrix_parity(ref, mode, d, m):
    """Every factorization of 4: the reference's decisions, exits,
    ``g_final`` bits, chunk stats, bill, stages, per-shard and
    per-coordinate counters; ``evaluate_cascade``'s verdicts and the 1-D
    f32 ``DeviceExecutor``'s ``g_final`` bits."""
    F, qm, dplan = _fit(mode)
    np.testing.assert_array_equal(np.asarray(qm.order), ref[f"matrix/{mode}/order"])
    Fo = F[:, qm.order].astype(np.float32)
    sx = _executor(dplan, d, m)
    res = sx.run(Fo, 400)
    _assert_recorded(ref, f"matrix/{mode}/{d}x{m}", res, sx)
    ev = evaluate_cascade(qm, F)
    np.testing.assert_array_equal(res.decisions, ev["decisions"])
    np.testing.assert_array_equal(res.exit_step, ev["exit_step"])
    one = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=CPU), block_n=BLOCK,
                         device=CPU).run(Fo, 400)
    np.testing.assert_array_equal(_bits(res.g_final), _bits(one.g_final))
    assert sx.model_shards == m and sx.last_run_info["model_shards"] == m


@pytest.mark.parametrize("family,d,m", SCORER_CASES)
def test_mesh2d_tree_and_lattice_parity(ref, family, d, m):
    """B3 / B5 over each model shard's slab slice: the reference's 2-D
    matrix executor on ``apply_*_scores``'s ordered matrix (results, bits,
    bill), and the port's data-axis executor unfused (results, bits)."""
    params, x = scorer_fixture(family)
    n = x.shape[0]
    if family == "tree":
        F = ops.gbt_scores(*(torch.from_numpy(params[k]) for k in ("feats", "thrs", "leaves")),
                           torch.from_numpy(x))
    else:
        F = ops.lattice_scores(torch.from_numpy(params["theta"]),
                               torch.from_numpy(params["feats"]), torch.from_numpy(x))
    F = F.numpy()
    np.testing.assert_array_equal(F.view(np.int32), ref[f"{family}/F_bits"])
    qm = fit_qwyc(F.astype(np.float64), beta=0.0, alpha=0.02)
    np.testing.assert_array_equal(np.asarray(qm.order), ref[f"{family}/order"])
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=4))
    o = qm.order
    if family == "tree":
        bound = tree_stage_scorer(dplan, params["feats"][o], params["thrs"][o],
                                  params["leaves"][o], block_n=BLOCK, device=CPU)
    else:
        bound = lattice_stage_scorer(dplan, params["theta"][o], params["feats"][o],
                                     block_n=BLOCK, device=CPU)
    sx = _executor(dplan, d, m, scorer=bound)
    res = sx.run(x, n)
    _assert_recorded(ref, f"{family}/{d}x{m}", res, sx)
    ev = evaluate_cascade(qm, F)
    np.testing.assert_array_equal(res.exit_step, ev["exit_step"])
    one = _executor(dplan, d, 1, scorer=bound, megakernel=False).run(x, n)
    np.testing.assert_array_equal(res.decisions, one.decisions)
    np.testing.assert_array_equal(res.exit_step, one.exit_step)
    np.testing.assert_array_equal(_bits(res.g_final), _bits(one.g_final))
    assert sx.traces == 1 and not sx.megakernel


@pytest.mark.parametrize("name,t,chunk_t,d,m", NONDIV_CASES)
def test_mesh2d_nonaligned_column_split(ref, name, t, chunk_t, d, m):
    """A split that does not divide W: the padded columns (the next
    stage's models, zeros past T) are scored and dropped, so the verdicts
    and ``g_final`` stay the 1-D loop's and the bill counts w_global."""
    F, qm, dplan = _fit(seed=43, t=t, chunk_t=chunk_t)
    Fo = F[:, qm.order].astype(np.float32)
    sx = _executor(dplan, d, m)
    np.testing.assert_array_equal([sx._w_local, sx._w_global], ref[f"nondiv/{name}/w"])
    res = sx.run(Fo, 400)
    _assert_recorded(ref, f"nondiv/{name}", res, sx)
    one = DeviceExecutor(dplan, matrix_stage_scorer(dplan, device=CPU), block_n=BLOCK,
                         device=CPU).run(Fo, 400)
    np.testing.assert_array_equal(res.exit_step, one.exit_step)
    np.testing.assert_array_equal(_bits(res.g_final), _bits(one.g_final))
    info = sx.last_run_info
    blocks = -(-info["per_shard_n_in"] // BLOCK) * BLOCK
    assert res.scores_computed == int(blocks.sum()) * sx._w_global > one.scores_computed


def test_nonaligned_tree_split_scores_next_stage_models():
    """W 8 over 3 model shards with the tree scorer: the last shard's slice
    of a stage reaches one model into the next stage (and past T in the
    last), and the results are the data axis's all the same."""
    params, x = scorer_fixture("tree")
    F = ops.gbt_scores(*(torch.from_numpy(params[k]) for k in ("feats", "thrs", "leaves")),
                       torch.from_numpy(x)).numpy()
    qm = fit_qwyc(F.astype(np.float64), beta=0.0, alpha=0.02)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=8))
    o = qm.order
    bound = tree_stage_scorer(dplan, params["feats"][o], params["thrs"][o],
                              params["leaves"][o], block_n=BLOCK, device=CPU)
    sx = _executor(dplan, 2, 3, scorer=bound)
    assert (sx._w_local, sx._w_global) == (3, 9)
    last = sx._mparams[2]["leaves"]
    np.testing.assert_array_equal(last[0, 2].numpy(), params["leaves"][o][8])
    assert not last[-1, 2].any()  # past T: zero params
    res = sx.run(x, x.shape[0])
    one = _executor(dplan, 2, 1, scorer=bound, megakernel=False).run(x, x.shape[0])
    np.testing.assert_array_equal(res.exit_step, one.exit_step)
    np.testing.assert_array_equal(_bits(res.g_final), _bits(one.g_final))


# -- model_shards=1, traces, billing -------------------------------------------------


def test_model_shards_one_is_the_1d_program():
    """``make_serving_mesh(4, 1)`` is the 1-D mesh and runs the data axis's
    program: results, bill, stages, occupancy and traces equal, and no
    per-coordinate counter."""
    F, qm, dplan = _fit()
    Fo = F[:, qm.order].astype(np.float32)
    mesh_m1 = make_serving_mesh(4, 1, device=CPU)
    assert mesh_m1.axis_names == ("data",)
    a = _executor(dplan, 4, 1)
    b = ShardedDeviceExecutor(dplan, matrix_stage_scorer(dplan, device=CPU),
                              make_serving_mesh(4, device=CPU), block_n=BLOCK)
    ra, rb = a.run(Fo, 400), b.run(Fo, 400)
    np.testing.assert_array_equal(ra.decisions, rb.decisions)
    np.testing.assert_array_equal(ra.exit_step, rb.exit_step)
    np.testing.assert_array_equal(_bits(ra.g_final), _bits(rb.g_final))
    assert ra.chunk_stats == rb.chunk_stats and ra.scores_computed == rb.scores_computed
    assert a.traces == b.traces == 1 and a._keys == b._keys
    ia, ib = a.last_run_info, b.last_run_info
    assert ia["stages_run"] == ib["stages_run"] and ia["model_shards"] == 1
    np.testing.assert_array_equal(ia["per_shard_n_in"], ib["per_shard_n_in"])
    assert "per_coord_scores" not in ia and a.megakernel


@pytest.mark.parametrize("d,m", [(2, 2), (1, 4)])
def test_mesh2d_single_trace(ref, d, m):
    """One program a mesh shape: repeats, a permuted order and a partial
    flush at the pinned capacity reuse it, with the reference's exits and
    trace count; the key carries (D, M)."""
    F, qm, dplan = _fit()
    Fo = F[:, qm.order].astype(np.float32)
    ev = evaluate_cascade(qm, F)
    sx = _executor(dplan, d, m)
    p = f"matrix/both/{d}x{m}"
    for _ in range(2):
        np.testing.assert_array_equal(sx.run(Fo, 400).exit_step, ev["exit_step"])
    perm = np.random.default_rng(7).permutation(400)
    np.testing.assert_array_equal(sx.run(Fo, 400, row_order=perm).exit_step,
                                  ref[f"{p}/perm_exit_step"])
    small = sx.run(Fo[:100], 100, capacity=400)
    np.testing.assert_array_equal(small.exit_step, ref[f"{p}/small_exit_step"])
    np.testing.assert_array_equal(small.exit_step, ev["exit_step"][:100])
    assert sx.traces == ref[f"{p}/traces"] == 1
    assert all(key[-2:] == (d, m) for key in sx._keys)


@pytest.mark.parametrize("d,m", [(2, 2), (1, 4)])
def test_mesh2d_per_coord_billing(d, m):
    """Per-(data, model) counters: a model shard bills its data shard's
    live blocks at ``w_local`` columns, one psum and one stage step a
    stage, and the coordinates add up to the padded global bill."""
    F, qm, dplan = _fit()
    sx = _executor(dplan, d, m)
    res = sx.run(F[:, qm.order].astype(np.float32), 400)
    info = sx.last_run_info
    s_f = int(info["stages_run"])
    assert info["mesh_shape"] == (d, m)
    for key in ("per_coord_scores", "per_coord_psums", "per_coord_stages"):
        assert info[key].shape[:2] == (d, m)
    np.testing.assert_array_equal(info["per_coord_psums"], np.full((d, m), s_f))
    np.testing.assert_array_equal(info["per_coord_stages"], np.full((d, m), s_f))
    coord = info["per_coord_scores"]
    for j in range(1, m):
        np.testing.assert_array_equal(coord[:, j, :], coord[:, 0, :])
    blocks = -(-info["per_shard_n_in"][:, :s_f] // BLOCK) * BLOCK
    assert res.scores_computed == int(blocks.sum()) * sx._w_global
    assert int(coord.sum()) == int(blocks.sum()) * sx._w_local * m
    assert info["per_shard_scores"].sum() == res.scores_computed


# -- refusals ------------------------------------------------------------------------


def test_mesh2d_grouped_and_streaming_raise():
    """Grouped and streaming runs stay data-parallel only."""
    F, qm, dplan = _fit()
    sx = _executor(dplan, 2, 2)
    Fo = F[:, qm.order].astype(np.float32)
    grouped = r"run_grouped is unavailable on a 2x2 \('data', 'model'\)"
    with pytest.raises(ValueError, match=grouped):
        sx.run_grouped(Fo, np.zeros((1, 4), np.int64), np.ones((1, 4), bool), 1,
                       np.zeros(dplan.S), 1)
    with pytest.raises(ValueError, match="run_stream is unavailable"):
        sx.run_stream(Fo, 400, arrivals=np.zeros(400, np.int64))


def test_mesh2d_validation_errors():
    """The fused step, a scorer without the hook, a stateful scorer and M >
    W are refused, naming the mesh's shape; run-time checks name it too."""
    F, qm, dplan = _fit()
    mesh = make_serving_mesh(2, 2, device=CPU)
    scorer = matrix_stage_scorer(dplan, device=CPU)
    with pytest.raises(ValueError, match=r"megakernel=True is unavailable on a 2x2"):
        ShardedDeviceExecutor(dplan, scorer, mesh, megakernel=True)
    bare = dataclasses.replace(scorer, model_partition=None)
    with pytest.raises(ValueError, match="model_partition"):
        ShardedDeviceExecutor(dplan, bare, mesh)
    stateful = dataclasses.replace(scorer, state_spec={"h": ((2,), torch.float32)}, slabs=None)
    with pytest.raises(ValueError, match="cannot carry a stateful scorer"):
        ShardedDeviceExecutor(dplan, stateful, mesh)
    wide = ServingMesh(("data", "model"), {"data": 1, "model": dplan.W + 1}, torch.device(CPU))
    with pytest.raises(ValueError, match="more model shards than the plan's stage width W=8"):
        ShardedDeviceExecutor(dplan, scorer, wide)
    sx = ShardedDeviceExecutor(dplan, scorer, mesh, block_n=BLOCK)
    Fo = F[:, qm.order].astype(np.float32)
    with pytest.raises(ValueError, match=r"on a 2x2 \('data', 'model'\) mesh"):
        sx.run(Fo, 400, capacity=200)
    with pytest.raises(ValueError, match="row_order"):
        sx.run(Fo, 400, row_order=np.arange(3))


# -- the front door ------------------------------------------------------------------


def test_compile_model_shards():
    """``compile("sharded", shards=, model_shards=)`` builds the 2-D
    executor and equals the device rung; rungs without the capability
    refuse it; the billing key names the whole mesh shape."""
    from repro_torch import api

    F = score_matrix(49)
    fitted = api.fit(F, beta=0.0, alpha=0.01)
    want = fitted.compile("device", device=CPU).evaluate(scores=F)
    c = fitted.compile("sharded", shards=2, model_shards=2, device=CPU)
    assert (c._executor.shards, c._executor.model_shards) == (2, 2)
    r = c.evaluate(scores=F)
    np.testing.assert_array_equal(r.decisions, want.decisions)
    np.testing.assert_array_equal(r.exit_step, want.exit_step)
    np.testing.assert_array_equal(_bits(r.g_final), _bits(want.g_final))
    srv = c.serve(score_fn=lambda x: x, batch_size=32)
    assert (srv.mesh.shape, srv.n_shards, srv.flush_size) == ({"data": 2, "model": 2}, 2, 64)
    for backend in ("host", "device"):
        with pytest.raises(ValueError, match="model-parallel backend"):
            fitted.compile(backend, model_shards=2, device=CPU)
    sb = api.get_backend("sharded")
    assert sb.capabilities.model_parallel
    assert not api.get_backend("device").capabilities.model_parallel
    assert sb.billing_key(shards=2, model_shards=2) == "sharded2x2"
    assert sb.billing_key(shards=1, model_shards=4, rebalance=True) == "sharded1x4r"
    assert sb.billing_key(shards=4) == sb.billing_key(shards=4, model_shards=1) == "sharded4"
    mesh = sb.resolve_mesh(shards=3, model_shards=2, device=CPU)
    assert mesh.shape == {"data": 3, "model": 2}
    assert sb.resolve_mesh(mesh, model_shards=2) is mesh
    with pytest.raises(ValueError, match="conflicts with the explicit mesh"):
        sb.resolve_mesh(make_serving_mesh(2, device=CPU), model_shards=2)


def test_serving_mesh_carries_model_axis():
    """``QWYCServer(backend_opts={"shards": 2, "model_shards": 2})``: a 2-D
    mesh, a flush of the data axis's rows, the reference's verdicts; a rung
    without the capability refuses the option."""
    from repro_torch.serving.engine import QWYCServer

    rng = np.random.default_rng(50)
    Wm = rng.normal(size=(16, 6))
    X = rng.normal(size=(220, 6)).astype(np.float32)
    F = (X @ Wm.T).astype(np.float64)
    qm = fit_qwyc(F, beta=0.0, alpha=0.01)
    ev = evaluate_cascade(qm, F)
    kw = dict(batch_size=64, backend="kernel", chunk_t=4, device=CPU)
    srv = QWYCServer(qm, lambda x: x.numpy() @ Wm.T, exec_backend="sharded",
                     backend_opts={"shards": 2, "model_shards": 2}, **kw)
    assert srv.mesh.shape == {"data": 2, "model": 2} and srv.n_shards == 2
    for row in X:
        srv.submit(row)
    res = srv.drain()
    np.testing.assert_array_equal([r["decision"] for r in res], ev["decisions"])
    np.testing.assert_array_equal([r["models_evaluated"] for r in res], ev["exit_step"])
    assert srv._dev[0].model_shards == 2 and srv.flush_size == 128
    with pytest.raises(ValueError, match="model-parallel"):
        QWYCServer(qm, lambda x: x.numpy() @ Wm.T, exec_backend="device",
                   backend_opts={"model_shards": 2}, **kw)
    with pytest.raises(ValueError, match="conflicts with the explicit mesh"):
        QWYCServer(qm, lambda x: x.numpy() @ Wm.T, exec_backend="sharded",
                   backend_opts={"mesh": make_serving_mesh(2, device=CPU), "model_shards": 2},
                   **kw)


def test_serve_cli_model_shards(capsys):
    """``--model-shards 2`` serves through the 2x2 mesh; on a backend
    without the capability the parser refuses it."""
    from repro_torch.launch import serve as serve_cli

    base = ["--device", "cpu", "--T", "30", "--scale", "0.05", "--alpha", "0.01",
            "--batch-size", "16"]
    serve_cli.main(base + ["--backend", "sharded", "--backend-shards", "2", "--model-shards", "2"])
    out = capsys.readouterr().out
    assert "2 x 2 (data x model) logical shards" in out
    assert "(sharded backend, 2x2 shards, sorted-kernel policy" in out
    with pytest.raises(SystemExit):
        serve_cli.main(base + ["--backend", "device", "--model-shards", "2"])
    assert "--model-shards requires a model-parallel backend" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["both", "neg_only"])
def test_fit_qwyc_sharded_mesh(mode):
    """``fit_qwyc_sharded(mesh=)`` sweeps on the mesh's device: the
    one-device sweep's model bit for bit, and the reference's sweep.  The reference's own ``mesh=`` path fails under the installed
    JAX (its sharded gather names an axis the gather's mesh lacks), so its
    one-device sweep, which computes the same model, is the oracle."""
    from repro.core import qwyc_distributed as j_dist

    from repro_torch.core.qwyc_distributed import fit_qwyc_sharded

    F = score_matrix(68, n=240, t=16)
    m = fit_qwyc_sharded(F, beta=0.0, alpha=0.02, mode=mode,
                         mesh=make_serving_mesh(2, 2, device=CPU))
    one = fit_qwyc_sharded(F, beta=0.0, alpha=0.02, mode=mode, device=CPU)
    jm = j_dist.fit_qwyc_sharded(F, beta=0.0, alpha=0.02, mode=mode)
    for other in (one, jm):
        np.testing.assert_array_equal(m.order, other.order)
        np.testing.assert_array_equal(np.stack([m.eps_pos, m.eps_neg]),
                                      np.stack([other.eps_pos, other.eps_neg]))


# -- on the card (marked cuda: they skip without one) --------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family,d,m", SCORER_CASES)
def test_mesh2d_on_card_equals_cpu(card, family, d, m):
    """The 2-D batch loop on the card, eager, captured, replayed and with
    ``capture=False``, equals the CPU bit for bit; a replay launches B3 (or
    B5) D x M x S times and B2's step form D x S times."""
    from repro_torch.kernels import _build

    params, x = scorer_fixture(family)
    n = x.shape[0]
    F = (ops.gbt_scores(*(torch.from_numpy(params[k]) for k in ("feats", "thrs", "leaves")),
                        torch.from_numpy(x)) if family == "tree" else
         ops.lattice_scores(torch.from_numpy(params["theta"]), torch.from_numpy(params["feats"]),
                            torch.from_numpy(x))).numpy()
    qm = fit_qwyc(F.astype(np.float64), beta=0.0, alpha=0.02)
    dplan = DevicePlan.from_plan(CascadePlan.from_qwyc(qm, chunk_t=4))
    o = qm.order

    def make(device, capture):
        if family == "tree":
            bound = tree_stage_scorer(dplan, params["feats"][o], params["thrs"][o],
                                      params["leaves"][o], block_n=BLOCK, device=device)
        else:
            bound = lattice_stage_scorer(dplan, params["theta"][o], params["feats"][o],
                                         block_n=BLOCK, device=device)
        return ShardedDeviceExecutor(dplan, bound, make_serving_mesh(d, m, device=device),
                                     block_n=BLOCK, capture=capture)

    order = np.argsort(x[:, 0], kind="stable")
    ex = make(card, True)
    runs = [ex.run(x, n, row_order=order), ex.run(x, n, row_order=order)]
    _build.LAUNCHES.clear()
    runs.append(ex.run(x, n, row_order=order))
    torch.cuda.synchronize()
    launched = dict(_build.LAUNCHES)
    runs.append(make(card, False).run(x, n, row_order=order))
    want = make(CPU, False).run(x, n, row_order=order)
    for r in runs:
        np.testing.assert_array_equal(r.decisions, want.decisions)
        np.testing.assert_array_equal(r.exit_step, want.exit_step)
        np.testing.assert_array_equal(_bits(r.g_final), _bits(want.g_final))
        assert r.chunk_stats == want.chunk_stats
    assert ex.traces == 1 and len(ex._graphs) == 1
    score = "gbt_scores" if family == "tree" else "lattice_scores"
    assert launched == {score: d * m * dplan.S, "cascade_chunk_step": d * dplan.S}
