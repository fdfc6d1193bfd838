"""The training path of the PyTorch port against the JAX package on the CPU:
``loss_fn``, ``make_train_step`` (with ``remat``, ``microbatch`` and
``compute_dtype``), AdamW with its clipping and schedule, the token
stream, the checkpoints (read and written both ways) and
``repro_torch.launch.train``.

The reference draws the weights; ``convert.transformer_params_from_numpy``
carries them across, and batches come from the reference's token stream
or a numpy seed.

Rules (torch and XLA sum f32 products in different orders):

* loss and ``grad_norm`` within 1e-5 relative;
* gradients, leaf by leaf: ``max|dg| <= 1e-5 * max|g_ref| + 1e-7``;
* updated params within 1e-6, except in the band where
  ``|g_ref| < BAND * max|g_ref|`` of the leaf.  At step 1 AdamW moves a
  weight by ``lr * g / (|g| + eps)``, and after clipping a gradient in the
  band is within a few ``eps`` of 0, where a last-bit gap in ``g`` moves
  the update by up to ``2 * lr``.  In the band the params are held within
  ``2 * lr + 1e-6``, and the elements there that moved by more than 1e-6
  are counted and held under ``MOVED_SHARE`` of the tree's elements (at
  most 17 of 398,528 seen).  (At a band of
  1e-5, clipped gradients just above it still sat within 3 eps of 0 and
  moved 1.3e-6.)
* ``compute_dtype=bfloat16``: the forward and backward run in bf16 in
  both packages, which round partial sums at different places, so the
  loss is held within 1e-4 relative, ``grad_norm`` (a bf16 value) within
  one bf16 ulp, and the params within ``2 * lr + 1e-6`` everywhere, the
  elements past 1e-6 counted and held under ``BF16_MOVED_SHARE``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.data.tokens import TokenStream as JTokenStream
from repro.data.tokens import make_batches as j_make_batches
from repro.models import init_params as j_init_params
from repro.models import init_train_state as j_init_train_state
from repro.models import loss_fn as j_loss_fn
from repro.models import make_train_step as j_make_train_step
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as JA
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.msgpack_ckpt import pack, unpack
from repro_torch.convert import adamw_state_from_numpy, transformer_params_from_numpy
from repro_torch.data.tokens import TokenStream, make_batches
from repro_torch.models import ModelConfig, loss_fn, make_train_step
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.tree import flatten

DEV = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 3e-4
BAND = 1e-4
MOVED_SHARE = 1e-4
BF16_MOVED_SHARE = 0.02
# the reference's tests/test_steps.py CFG
CFG = JModelConfig(
    name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
)
NAMES = sorted(J_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the shapes are small, and under a parallel
    run every worker's threads would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    a = torch.as_tensor(a).detach().cpu()
    return (a.float() if a.dtype == torch.bfloat16 else a).numpy()


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _carry(jtree):
    return transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), device=DEV)


def _jleaves(tree) -> list[np.ndarray]:
    return [np.asarray(a, dtype=np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _batch(cfg, seed: int, b: int, s: int) -> dict:
    rng = np.random.default_rng(seed)
    sf = cfg.n_frontend_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - sf)).astype(np.int32)}
    if sf:
        batch["frontend"] = rng.normal(size=(b, sf, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(params, cfg, batch) -> tuple[torch.Tensor, list]:
    """(loss, gradients of ``loss_fn`` in flatten order), the port's own
    autograd on its params' leaves."""
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    loss = loss_fn(params, cfg, batch)
    return loss, list(torch.autograd.grad(loss, leaves))


def _grads_close(grads: list, jgrads) -> None:
    """``grads`` in flatten order against the reference's gradient tree."""
    for i, (g, jg) in enumerate(zip(grads, _jleaves(jgrads), strict=True)):
        bound = 1e-5 * float(np.abs(jg).max()) + 1e-7
        assert float(np.abs(_np(g) - jg).max()) <= bound, i


def _params_close(params, jparams, jgrads, lr: float = LR) -> int:
    """The updated-params rule of the module docstring -> the count of
    elements in the band that moved by more than 1e-6 (held under
    ``MOVED_SHARE`` of the tree's elements)."""
    moved = total = 0
    for (path, p), jp, jg in zip(flatten(params), _jleaves(jparams), _jleaves(jgrads)):
        d = np.abs(_np(p) - jp)
        band = np.abs(jg) < BAND * float(np.abs(jg).max())
        assert not (d[~band] > 1e-6).any(), (path, float(d[~band].max()))
        assert float(d.max()) <= 2 * lr + 1e-6, path
        moved += int((d[band] > 1e-6).sum())
        total += d.size
    assert moved <= MOVED_SHARE * total, (moved, total)
    return moved


def _step_both(jcfg, kw: dict, seed: int, b: int, s: int):
    """One train step of each package from the same weights and batch ->
    (port params, port metrics, reference params, reference metrics,
    reference gradients of the whole-batch loss)."""
    cfg = _port_cfg(jcfg)
    jparams, jopt = j_init_train_state(jcfg, jax.random.PRNGKey(seed))
    params = _carry(jparams)
    batch = _batch(cfg, seed, b, s)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("compute_dtype"):
        jkw["compute_dtype"], tkw["compute_dtype"] = jnp.bfloat16, torch.bfloat16
    jp2, _, jm = jax.jit(j_make_train_step(jcfg, lr=LR, **jkw))(jparams, jopt, jbatch)
    p2, opt2, m = make_train_step(cfg, lr=LR, **tkw)(params, adamw_init(params), tbatch)
    assert int(opt2.step) == 1
    jg = jax.jit(jax.grad(lambda q: j_loss_fn(q, jcfg, jbatch)))(jparams)
    return p2, m, jp2, jm, jg, (params, tbatch)


# -- loss, gradients and one step ------------------------------------------------


def test_loss_and_gradients_match_jax():
    """``loss_fn`` and its gradients on test_steps.py's CFG."""
    cfg = _port_cfg(CFG)
    jparams = j_init_params(CFG, jax.random.PRNGKey(7))
    params = _carry(jparams)
    batch = _batch(cfg, 7, 8, 32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda q: j_loss_fn(q, CFG, jbatch)))(jparams)
    loss, grads = _port_grads(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _grads_close(grads, jg)


@pytest.mark.parametrize("variant", ["plain", "remat", "microbatch"])
def test_train_step_matches_jax(variant):
    """One step on CFG, each variant against the reference's same variant:
    loss, grad_norm, the whole-batch gradients and the updated params."""
    kw = {"plain": {}, "remat": {"remat": True}, "microbatch": {"microbatch": 2}}[variant]
    p2, m, jp2, jm, jg, _ = _step_both(CFG, kw, 7, 8, 32)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _params_close(p2, jp2, jg)


def test_remat_and_microbatch_within_the_port():
    """Within the port, ``remat`` recomputes the same values (loss and
    params equal), and ``microbatch=2`` stays within the reference's own
    test_steps bounds of the whole batch (loss 1e-5, params 1e-4)."""
    cfg = _port_cfg(CFG)
    params = _carry(j_init_params(CFG, jax.random.PRNGKey(7)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 7, 8, 32).items()}
    runs = {name: make_train_step(cfg, lr=LR, **kw)(params, adamw_init(params), batch)
            for name, kw in (("plain", {}), ("remat", {"remat": True}),
                             ("micro", {"microbatch": 2}))}
    p0, _, m0 = runs["plain"]
    p1, _, m1 = runs["remat"]
    assert float(m1["loss"]) == float(m0["loss"])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(p1), flatten(p0)))
    p2, _, m2 = runs["micro"]
    assert abs(float(m2["loss"]) - float(m0["loss"])) < 1e-5
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(flatten(p2), flatten(p0))) < 1e-4


def test_train_step_bf16_compute_matches_jax():
    """``compute_dtype=bfloat16`` on CFG: the masters stay f32, the
    gradients are taken in bf16, clipped (a bf16 global norm: each leaf's
    sum of squares in f32 rounded to bf16, the leaves added in bf16, as
    XLA's CPU reduces ``jnp.sum`` and Python's ``sum``) and cast back."""
    p2, m, jp2, jm, _, _ = _step_both(CFG, {"compute_dtype": True}, 7, 8, 32)
    assert m["grad_norm"].dtype == torch.bfloat16 and jm["grad_norm"].dtype == jnp.bfloat16
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=2.0**-7)
    moved = 0
    for (path, p), jp in zip(flatten(p2), _jleaves(jp2)):
        assert p.dtype == torch.float32, path
        d = np.abs(_np(p) - jp)
        assert float(d.max()) <= 2 * LR + 1e-6, path
        moved += int((d > 1e-6).sum())
    n = sum(a.size for a in _jleaves(jp2))
    assert moved <= BF16_MOVED_SHARE * n, (moved, n)


@pytest.mark.parametrize("name", NAMES)
def test_arch_train_step_matches_jax(name):
    """The reference's test_arch_smoke training half: one step on each of
    the ten smoke configs (frontend embeddings where the arch has them),
    loss, grad_norm, gradients and params under the module's rules."""
    jcfg = J_ARCHS[name].smoke()
    p2, m, jp2, jm, jg, (params, tbatch) = _step_both(jcfg, {}, NAMES.index(name), 2, 32)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _grads_close(_port_grads(params, _port_cfg(jcfg), tbatch)[1], jg)
    _params_close(p2, jp2, jg)
    assert [path for path, _ in flatten(p2)] == [path for path, _ in flatten(params)]


def test_loss_falls_short_run():
    """test_steps.py's 30-step run (lr 3e-3, the reference's token stream)
    from the reference's weights: the port's loss falls by more than 0.1,
    and each step's loss stays within 1e-3 of the reference's."""
    jparams, jopt = j_init_train_state(CFG, jax.random.PRNGKey(0))
    params = _carry(jparams)
    opt = adamw_init(params)
    jstep = jax.jit(j_make_train_step(CFG, lr=3e-3))
    step = make_train_step(_port_cfg(CFG), lr=3e-3)
    jb, tb = j_make_batches(CFG.vocab_size, 8, 32), make_batches(CFG.vocab_size, 8, 32)
    losses, jlosses = [], []
    for _ in range(30):
        a, b = next(jb), next(tb)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(a["tokens"])})
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    np.testing.assert_allclose(losses, jlosses, atol=1e-3, rtol=0)


# -- AdamW, clipping, schedule ------------------------------------------------------


def _tree(rng, dtype=np.float32):
    return {"b": [rng.normal(size=(3, 4)).astype(dtype), rng.normal(size=(5,)).astype(dtype)],
            "a": rng.normal(size=(2, 2, 3)).astype(dtype)}


def _to_torch(tree, dtype=None):
    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(dtype) if dtype is not None else t
    return {"b": [leaf(a) for a in tree["b"]], "a": leaf(tree["a"])}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_by_global_norm_matches_jax(dtype):
    """The global norm and the clipped leaves, f32 (within 1e-6) and bf16
    (the reference's dtype flow: equal bits)."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jdt, tdt = (jnp.float32, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    for max_norm in (0.5, 100.0):
        jg, jn = JA.clip_by_global_norm(jtree, max_norm)
        g, n = clip_by_global_norm(_to_torch(tree, tdt), max_norm)
        assert (n.dtype == torch.bfloat16) == (dtype == "bf16")
        if dtype == "f32":
            np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
            for (_, a), b in zip(flatten(g), _jleaves(jg)):
                np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-7)
        else:
            assert float(n) == float(jn)
            for (_, a), b in zip(flatten(g), _jleaves(jg)):
                np.testing.assert_array_equal(_np(a), b)


def test_cosine_schedule_matches_jax():
    """Warm-up, the turn, mid-run and the end (and past it)."""
    jlr, lr = JA.cosine_schedule(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(jlr(jnp.int32(step)))
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    assert float(lr(0)) == 0.0 and float(lr(10)) == pytest.approx(1e-3)
    assert float(lr(100)) == pytest.approx(0.0, abs=1e-12)


def test_adamw_init_moment_dtype():
    """``moment_dtype`` applies to the floating leaves; the step is int32."""
    params = {"w": torch.zeros(2, 3, dtype=torch.bfloat16), "n": torch.zeros(4, dtype=torch.int32)}
    st = adamw_init(params, moment_dtype=torch.float32)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.mu["w"].dtype == torch.float32 and st.nu["n"].dtype == torch.int32
    assert adamw_init(params).mu["w"].dtype == torch.bfloat16
    assert AdamWConfig() == AdamWConfig(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)


def test_adamw_bf16_weights_f32_moments_match_jax():
    """bf16 weights, f32 moments, bf16 gradients, weight decay 0.01: four
    steps of the reference's dtype flow (f32 bias corrections, the update
    in f32, the result cast back to bf16) give the reference's bits, the
    moments within 1e-6 relative; the reference's state carries across."""
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p0)
    p = _to_torch(p0, torch.bfloat16)
    jst, st = JA.adamw_init(jp, moment_dtype=jnp.float32), adamw_init(p, torch.float32)
    for i in range(4):
        g0 = _tree(np.random.default_rng(10 + i))
        jgr = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g0)
        jp, jst = JA.adamw_update(jp, jgr, jst, lr=1e-2, weight_decay=0.01)
        p, st = adamw_update(p, _to_torch(g0, torch.bfloat16), st, lr=1e-2, weight_decay=0.01)
    for (path, a), b in zip(flatten(p), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32), err_msg=str(path))
    for (path, a), b in zip(flatten(st.mu), _jleaves(jst.mu)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-9)
    # carried state: the next step from the reference's state equals its own
    carried = adamw_state_from_numpy(np.asarray(jst.step),
                                     jax.tree_util.tree_map(np.asarray, jst.mu),
                                     jax.tree_util.tree_map(np.asarray, jst.nu), device=DEV)
    assert int(carried.step) == 4 and carried.mu["a"].dtype == torch.float32


# -- the token stream -----------------------------------------------------------------


@pytest.mark.parametrize("front", [0, 8], ids=["tokens", "frontend"])
def test_make_batches_match_jax(front):
    """The same seeds give the same arrays, host slices and frontend
    embeddings included."""
    for seed, host, hosts in ((0, 0, 1), (3, 1, 2)):
        jb = j_make_batches(97, 4, 24, n_frontend_tokens=front, d_model=16, seed=seed,
                            host_id=host, num_hosts=hosts)
        tb = make_batches(97, 4, 24, n_frontend_tokens=front, d_model=16, seed=seed,
                          host_id=host, num_hosts=hosts)
        for _ in range(3):
            a, b = next(jb), next(tb)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(JTokenStream(50, seed=2).sample(3, 9),
                                  TokenStream(50, seed=2).sample(3, 9))


# -- checkpoints -----------------------------------------------------------------------


def _ckpt_tree(seed: int):
    """The reference's test_checkpoint_roundtrip params, a bf16 leaf and an
    int32 scalar -> (jax tree, port tree)."""
    cfg = JModelConfig(name="c", arch_type="dense", n_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)
    jt = {"params": j_init_params(cfg, jax.random.PRNGKey(seed)),
          "half": jax.random.normal(jax.random.PRNGKey(seed + 1), (3, 5)).astype(jnp.bfloat16),
          "step": jnp.int32(seed)}
    t = {"params": _carry(jt["params"]),
         "half": torch.from_numpy(np.asarray(jt["half"]).view(np.uint16).astype(np.int32))
         .to(torch.int16).view(torch.bfloat16),
         "step": torch.tensor(seed, dtype=torch.int32)}
    return jt, t


def _bits(a) -> np.ndarray:
    """The leaf's values as numpy, a bf16 leaf as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16).astype(np.int16) if a.dtype.name == "bfloat16" else a


def test_checkpoint_reference_saves_port_restores(tmp_path):
    from repro.checkpoint import save_checkpoint as j_save

    jt, t = _ckpt_tree(3)
    j_save(tmp_path, 42, jt)
    assert latest_step(tmp_path) == 42
    target = {"params": t["params"], "half": torch.zeros(1), "step": torch.zeros(1)}
    got = restore_checkpoint(tmp_path, 42, target, device=DEV)
    assert got["half"].dtype == torch.bfloat16 and got["step"].dtype == torch.int32
    for (path, a), b in zip(flatten(got), jax.tree_util.tree_leaves(jt)):
        assert tuple(a.shape) == np.shape(b), path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(path))


def test_checkpoint_port_saves_reference_restores(tmp_path):
    from repro.checkpoint import restore_checkpoint as j_restore

    jt, t = _ckpt_tree(4)
    d = save_checkpoint(tmp_path, 7, t)
    assert d == tmp_path / "step_00000007"
    got = j_restore(tmp_path, 7, jt)
    for a, b in zip(jax.tree_util.tree_leaves(got), [x for _, x in flatten(t)]):
        assert a.dtype.name == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # and back through the port, bit for bit
    back = restore_checkpoint(tmp_path, 7, t, device=DEV)
    for (_, a), (_, b) in zip(flatten(back), flatten(t)):
        assert torch.equal(a, b)


def test_checkpoint_manifest_bytes_equal_msgpack(tmp_path):
    """The port's manifest is ``msgpack.packb``'s bytes, and equal to the
    reference's manifest of the same tree; ``unpack`` reads both."""
    msgpack = pytest.importorskip("msgpack")
    from repro.checkpoint import save_checkpoint as j_save

    jt, t = _ckpt_tree(5)
    mine = (save_checkpoint(tmp_path / "port", 1, t) / "manifest.msgpack").read_bytes()
    ref = (j_save(tmp_path / "ref", 1, jt) / "manifest.msgpack").read_bytes()
    assert mine == ref
    manifest = unpack(mine)
    assert manifest["half"] == {"index": 0, "shape": [3, 5], "dtype": "bfloat16"}
    assert pack(manifest) == msgpack.packb(manifest)
    wide = {"k" * 40: {"index": 70000, "shape": [1 << 33, 300, 0], "dtype": "x" * 300},
            **{f"m{i}": i for i in range(20)}}
    assert pack(wide) == msgpack.packb(wide) and unpack(msgpack.packb(wide)) == wide


def test_checkpoint_refusals_and_latest_step(tmp_path):
    assert latest_step(tmp_path / "none") is None
    for step in (3, 12, 5):
        save_checkpoint(tmp_path, step, {"w": torch.ones(2)})
    assert latest_step(tmp_path) == 12
    for bad in (-1, 1.5, None, b"x", True):
        with pytest.raises(TypeError):
            pack({"k": bad})
    with pytest.raises(ValueError, match="ROADMAP A15"):
        restore_checkpoint(tmp_path, 12, {"w": torch.ones(2)}, shardings={}, device=DEV)


# -- the launcher ----------------------------------------------------------------------


def test_launch_train_cpu_prints_ok(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` at a tiny size
    prints the reference's lines and ``OK``; the reference restores its
    checkpoint into its own param structure."""
    from repro.checkpoint import restore_checkpoint as j_restore

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--steps", "30", "--layers", "2", "--d-model", "64", "--heads", "4",
           "--kv-heads", "2", "--d-ff", "128", "--vocab", "256", "--batch", "4",
           "--seq", "32", "--log-every", "10", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[train] qwen3-1.7b reduced: ~")
    assert sum(line.startswith("[train] step ") for line in lines) == 3
    assert "(OK)" in lines[-2] and lines[-1].startswith("[train] checkpoint -> ")
    cfg = J_ARCHS["qwen3-1.7b"].scaled(n_layers=2, d_model=64, d_ff=128, n_heads=4,
                                       n_kv_heads=2, head_dim=16, vocab_size=256)
    want = j_init_params(cfg, jax.random.PRNGKey(0))
    got = j_restore(tmp_path, 30, want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(got),
                                                  jax.tree_util.tree_leaves(want)))


def test_launch_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])
