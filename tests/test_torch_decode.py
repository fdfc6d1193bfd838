"""The decode path of the PyTorch port against the JAX package on the CPU:
``init_cache``, ``forward(cache=)``, ``make_prefill_step`` and
``make_decode_step`` over every cache kind (the GQA ring, the MLA latent
with and without ``mla_absorb``, the RWKV6 and RG-LRU recurrent states).

The reference draws the weights; ``convert.transformer_params_from_numpy``
carries them across.  Each package builds its own cache with its own
``init_cache``, and the port's must equal the reference's in layout,
shapes and dtypes.  Tokens and frontend embeddings come from a numpy seed.

Tolerances (torch and XLA sum f32 products in different orders):

* logits within rtol 1e-4 / atol 2e-5 with an f32 cache, rtol 1e-3 /
  atol 5e-4 with a bf16 cache (a K/V element rounded the other way moves
  the later layers; the largest gap seen is 2.2e-4 on logits of 0.72);
* every returned cache leaf, leaf by leaf in the reference's flatten
  order, with the reference's dtype and shape: int32 positions equal;
  f32 leaves within ``1e-4 * max|ref| + 1e-6`` of the leaf; bf16 leaves
  (K/V and latents written by a bf16 cache, both packages rounding to
  nearest even) within ``2**-7 * |ref| + 1e-5 * max|ref|`` an element,
  which holds one bf16 ulp: an f32 sum that lands on the other side of a
  rounding boundary moves the rounded value.  The elements that differ
  are counted and held under ``ULP_SHARE`` of the leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import make_decode_step as j_make_decode_step
from repro.models import make_prefill_step as j_make_prefill_step
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import cache_from_numpy, transformer_params_from_numpy
from repro_torch.models import (
    ModelConfig,
    forward,
    init_cache,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.tree import flatten, path_key

DEV = "cpu"
ULP_SHARE = 0.01
BASE = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128)
# the reference's tests/test_decode_consistency.py CASES
CASES = {
    "dense": JModelConfig(name="d", arch_type="dense", **BASE),
    "windowed": JModelConfig(name="w", arch_type="dense", layer_pattern="LG",
                             sliding_window=8, **BASE),
    "mla": JModelConfig(name="m", arch_type="dense", kv_lora_rank=32,
                        rope_head_dim=8, nope_head_dim=16, v_head_dim=16, **BASE),
    "rwkv": JModelConfig(name="r", arch_type="ssm", layer_pattern="W",
                         rnn_heads=4, **BASE),
    "hybrid": JModelConfig(name="h", arch_type="hybrid", layer_pattern="RRL",
                           sliding_window=8,
                           n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                           head_dim=16, d_ff=128, vocab_size=128),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = sorted(J_ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the shapes are small, and under a parallel
    run every worker's threads would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    a = a.detach().cpu()
    return (a.float() if a.dtype == torch.bfloat16 else a).numpy()


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _model(jcfg, seed: int):
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device=DEV)


TOL = {"f32": dict(rtol=1e-4, atol=2e-5), "bf16": dict(rtol=1e-3, atol=5e-4)}


def _close(got, want, rtol=1e-4, atol=2e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol)


def _ordered(a: torch.Tensor) -> torch.Tensor:
    """bf16 bits as integers in the order of the values they encode."""
    b = a.view(torch.int16).int()
    return torch.where(b >= 0, b, -(b & 0x7FFF))


def _jax_key(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)


def _cache_equal(cache, jcache) -> int:
    """Every leaf of the port's cache against the reference's (the rule in
    the module docstring) -> the count of bf16 elements that differ."""
    mine = [(path_key(p), leaf) for p, leaf in flatten(cache)]
    ref = [(_jax_key(p), np.asarray(leaf))
           for p, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    assert [k for k, _ in mine] == [k for k, _ in ref]
    n_ulp = 0
    for (key, a), (_, b) in zip(mine, ref):
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name, key
        assert tuple(a.shape) == b.shape, key
        if b.dtype.name == "bfloat16":
            jb = torch.from_numpy(b.view(np.uint16).astype(np.int32)).to(torch.int16)
            mag = np.abs(b.astype(np.float32))
            bound = 2.0**-7 * mag + 1e-5 * float(mag.max())
            assert np.all(np.abs(_np(a) - b.astype(np.float32)) <= bound), key
            n_ulp_leaf = int((_ordered(a) != _ordered(jb.view(torch.bfloat16))).sum())
            assert n_ulp_leaf <= ULP_SHARE * a.numel(), (key, n_ulp_leaf, a.numel())
            n_ulp += n_ulp_leaf
        elif np.issubdtype(b.dtype, np.floating):
            bound = 1e-4 * float(np.abs(b).max()) + 1e-6
            assert float(np.abs(_np(a) - b).max()) <= bound, key
        else:
            np.testing.assert_array_equal(_np(a), b, err_msg=key)
    return n_ulp


def _caches(jcfg, cfg, b, s, dt):
    """Each package's own empty cache; the port's must mirror the
    reference's leaf for leaf, and is returned with it."""
    jdt, tdt = DTYPES[dt]
    jc = j_init_cache(jcfg, b, s, jdt)
    c = init_cache(cfg, b, s, tdt, device=DEV)
    assert _cache_equal(c, jc) == 0
    return jc, c


# -- the five consistency cases -------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_then_decode_matches_jax(case, dt):
    """Prefill 23 tokens, decode the 24th: logits and the cache after each
    call equal the reference's, and (f32 cache) the decode step equals the
    last position of the cache-less serving forward."""
    jcfg = CASES[case]
    cfg = _port_cfg(jcfg)
    jp, p = _model(jcfg, 1)
    b, s = 2, 24
    toks = np.random.default_rng(sorted(CASES).index(case)).integers(0, cfg.vocab_size, (b, s))
    jc, c = _caches(jcfg, cfg, b, s, dt)
    jl, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, :-1]), jnp.arange(s - 1), cache=jc,
                          serve=True)
    lg, c2, _ = forward(p, cfg, _t(toks[:, :-1]), torch.arange(s - 1), cache=c, serve=True)
    assert c2 is c  # written in place, the same dict returned
    _close(lg, jl, **TOL[dt])
    _cache_equal(c, jc)
    jl, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, -1:]), jnp.arange(s - 1, s), cache=jc,
                          serve=True)
    lg, c, _ = forward(p, cfg, _t(toks[:, -1:]), torch.arange(s - 1, s), cache=c, serve=True)
    _close(lg, jl, **TOL[dt])
    _cache_equal(c, jc)
    if dt == "f32":
        full, _ = forward(p, cfg, _t(toks), torch.arange(s), serve=True)
        _close(lg[:, 0], full[:, -1], atol=2e-4, rtol=0)


@pytest.mark.parametrize("case", ["dense", "windowed", "rwkv", "hybrid"])
def test_token_by_token_decode_matches_jax(case):
    """Sixteen single-token steps from an empty f32 cache: every step's
    logits and the final cache equal the reference's."""
    jcfg = CASES[case]
    cfg = _port_cfg(jcfg)
    jp, p = _model(jcfg, 2)
    b, s = 1, 16
    toks = np.random.default_rng(10 + sorted(CASES).index(case)).integers(0, cfg.vocab_size,
                                                                          (b, s))
    jc, c = _caches(jcfg, cfg, b, s, "f32")
    jstep = jax.jit(lambda q, cc, tk, t: j_forward(q, jcfg, tk, t[None], cache=cc,
                                                   serve=True)[:2])
    for t in range(s):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        lg, c, _ = forward(p, cfg, _t(toks[:, t:t + 1]), torch.arange(t, t + 1), cache=c,
                           serve=True)
        _close(lg, jl)
    _cache_equal(c, jc)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_decode_matches_jax(absorb):
    """MLA decoded token by token with and without weight absorption: each
    equals the same variant of the reference, and the two variants agree
    with each other as the reference's do (atol 2e-4)."""
    jcfg = CASES["mla"].scaled(mla_absorb=absorb)
    cfg = _port_cfg(jcfg)
    jp, p = _model(jcfg, 3)
    b, s = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    jc, c = _caches(jcfg, cfg, b, s, "f32")
    outs = []
    for t in range(s):
        jl, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jnp.arange(t, t + 1),
                              cache=jc, serve=True)
        lg, c, _ = forward(p, cfg, _t(toks[:, t:t + 1]), torch.arange(t, t + 1), cache=c,
                           serve=True)
        _close(lg, jl)
        outs.append(lg[:, 0])
    _cache_equal(c, jc)
    other = _port_cfg(jcfg.scaled(mla_absorb=not absorb))
    c = init_cache(other, b, s, torch.float32, device=DEV)
    for t in range(s):
        lg, c, _ = forward(p, other, _t(toks[:, t:t + 1]), torch.arange(t, t + 1), cache=c,
                           serve=True)
        _close(lg[:, 0], outs[t], atol=2e-4, rtol=0)


def test_ring_length_windowed_against_all_local():
    """A stacked cache is as long as its longest ring: the windowed stack's
    global layers need the whole sequence, an all-local stack only the
    window; both shapes equal the reference's."""
    jcfg = CASES["windowed"]
    for jc in (jcfg, jcfg.scaled(layer_pattern="L")):
        cfg = _port_cfg(jc)
        c = init_cache(cfg, 2, 1000, torch.float32, device=DEV)
        _cache_equal(c, j_init_cache(jc, 2, 1000, jnp.float32))
    c = init_cache(_port_cfg(jcfg), 2, 1000, torch.float32, device=DEV)
    assert c["stack"]["k"].shape[2] == 1000
    c = init_cache(_port_cfg(jcfg.scaled(layer_pattern="L")), 2, 1000, torch.float32, device=DEV)
    assert c["stack"]["k"].shape[2] == jcfg.sliding_window
    # the hybrid loop's local layer gets its own window-long ring
    c = init_cache(_port_cfg(CASES["hybrid"]), 2, 1000, torch.float32, device=DEV)
    assert c["loop"][2]["k"].shape[1] == CASES["hybrid"].sliding_window


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prompt_longer_than_ring_matches_jax(dt):
    """ROADMAP C14: a 23-token prefill into 8-slot rings (all-local, window
    8) keeps only the last write of each slot, so the earlier queries lose
    keys they need and the prefill differs from the cache-less forward.
    The port keeps the reference's result: logits and caches equal."""
    jcfg = CASES["windowed"].scaled(layer_pattern="L")
    cfg = _port_cfg(jcfg)
    jp, p = _model(jcfg, 4)
    b, s = 2, 24
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s))
    jc, c = _caches(jcfg, cfg, b, s, dt)
    assert c["stack"]["k"].shape[2] == 8
    jl, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, :-1]), jnp.arange(s - 1), cache=jc,
                          serve=True)
    lg, c, _ = forward(p, cfg, _t(toks[:, :-1]), torch.arange(s - 1), cache=c, serve=True)
    _close(lg, jl, **TOL[dt])
    _cache_equal(c, jc)
    assert c["stack"]["pos"][0, 0].tolist() == [16, 17, 18, 19, 20, 21, 22, 15]
    jn, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, -1:]), jnp.arange(s - 1, s), cache=jc,
                          serve=True)
    ln, c, _ = forward(p, cfg, _t(toks[:, -1:]), torch.arange(s - 1, s), cache=c, serve=True)
    _close(ln, jn, **TOL[dt])
    _cache_equal(c, jc)
    full, _ = forward(p, cfg, _t(toks), torch.arange(s), serve=True)
    assert float((lg - full[:, :-1]).abs().max()) > 0.1


# -- the ten architectures at smoke size ----------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_arch_prefill_decode_matches_jax(name, dt):
    """The reference's test_arch_smoke serving half: make_prefill_step over
    a 32-position batch (frontend embeddings first where the arch has
    them) into a 64-position cache, then one make_decode_step at position
    32; logits and the cache after each equal the reference's."""
    jcfg = J_ARCHS[name].smoke()
    cfg = _port_cfg(jcfg)
    jp, p = _model(jcfg, 0)
    rng = np.random.default_rng(NAMES.index(name))
    b, s = 2, 32
    sf = cfg.n_frontend_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - sf)).astype(np.int32)}
    if sf:
        batch["frontend"] = rng.normal(size=(b, sf, cfg.d_model)).astype(np.float32)
    jc, c = _caches(jcfg, cfg, b, 64, dt)
    jl, jc = jax.jit(j_make_prefill_step(jcfg))(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, c = make_prefill_step(cfg)(p, c, {k: _t(v) for k, v in batch.items()})
    assert lg.shape == (b, 1, cfg.vocab_size)
    _close(lg, jl, **TOL[dt])
    _cache_equal(c, jc)
    jl, jc = jax.jit(j_make_decode_step(jcfg))(jp, jc, jnp.asarray(batch["tokens"][:, :1]),
                                               jnp.int32(s))
    lg, c = make_decode_step(cfg)(p, c, _t(batch["tokens"][:, :1]), s)
    assert lg.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(lg).all())
    _close(lg, jl, **TOL[dt])
    _cache_equal(c, jc)


def test_cache_from_numpy_keeps_dtypes():
    """The reference's bf16 cache crosses with its dtypes: int32 positions,
    f32 recurrent state, bf16 K/V bit for bit."""
    jcfg = CASES["hybrid"]
    jp, p = _model(jcfg, 5)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 6))
    _, jc, _ = j_forward(jp, jcfg, jnp.asarray(toks), jnp.arange(6),
                         cache=j_init_cache(jcfg, 2, 16), serve=True)
    c = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), device=DEV)
    assert _cache_equal(c, jc) == 0
    assert c["loop"][2]["k"].dtype == torch.bfloat16
    assert c["loop"][0]["h"].dtype == torch.float32 and c["loop"][2]["pos"].dtype == torch.int32
