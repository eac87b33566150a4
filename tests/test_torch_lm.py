"""The port's dense LM serving path against the reference, on the CPU, in f32.

Same weights (the reference's ``init_params``, through ``from_jax_params``)
and the same numpy inputs go through both packages. Tolerances: layers and
logits atol 1e-5 (f32; the two frameworks sum in other orders), caches
atol 1e-5. The reference's prefill is run both through its ``chunked_sdpa``
(``attn_chunk=16``) and its dense ``sdpa`` (the default threshold); the
port has one path, the flash kernel's plain version. Decode runs
teacher-forced: both packages get the same tokens at every step.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.configs import internlm2_1_8b as jil
from repro.configs import starcoder2_3b as jsc
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import param as jparam

from repro_torch.configs import internlm2_1_8b, starcoder2_3b
from repro_torch.models import layers as L
from repro_torch.models import lm, param

ATOL = 1e-5
CONFIGS = {"starcoder2-3b": (jsc, starcoder2_3b), "internlm2-1.8b": (jil, internlm2_1_8b)}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _params(name, seed=0):
    jmod, _ = CONFIGS[name]
    jp = jparam.init_params(jlm.specs(jmod.SMOKE), jax.random.key(seed))
    return jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_copy_the_reference_numbers(name, which):
    jmod, tmod = CONFIGS[name]
    jc, tc = getattr(jmod, which), getattr(tmod, which)
    for f in dataclasses.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "dtype":
            assert str(jnp.dtype(jv)) == str(tv).removeprefix("torch.")
        else:
            assert jv == tv, f.name
    assert jc.hd == tc.hd


@pytest.mark.parametrize("field,value", [
    ("moe", object()), ("cache_quant_scale", 0.05), ("cache_layout", "per_layer"),
])
def test_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataclasses.replace(starcoder2_3b.SMOKE, **{field: value})


# -------------------------------------------------------------------- specs

def _spec_leaves(tree):
    return {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
            for k, s in param.flatten(tree).items()}


@pytest.mark.parametrize("name,which", [
    ("starcoder2-3b", "SMOKE"), ("internlm2-1.8b", "SMOKE"), ("starcoder2-3b", "CONFIG"),
    ("internlm2-1.8b", "CONFIG"),
])
def test_specs_match_reference_leaf_for_leaf(name, which):
    jmod, tmod = CONFIGS[name]
    jspecs = _spec_leaves(jlm.specs(getattr(jmod, which)))
    tspecs = _spec_leaves(lm.specs(getattr(tmod, which)))
    assert jspecs == tspecs
    if which == "CONFIG":
        n = sum(math.prod(s[0]) for s in tspecs.values())
        lo, hi = {"starcoder2-3b": (2.5e9, 3.6e9), "internlm2-1.8b": (1.5e9, 2.3e9)}[name]
        assert lo <= n <= hi  # tests/test_archs.py::test_full_config_param_counts' band
        assert n == jparam.param_count(jlm.specs(jmod.CONFIG))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_bridge_carries_an_lm_tree(name):
    """Nested and flat (arrays.npz) reference trees give the same tensors;
    the untied config brings its ``lm_head``."""
    jp, tp = _params(name)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jp).items()}
    assert {"embed/table", "norm_f/scale", "blocks/attn/wq"} <= set(flat)
    assert ("lm_head/w" in flat) == (name == "internlm2-1.8b")
    from_flat = param.flatten(param.from_jax_params(flat, "cpu"))
    nested = param.flatten(tp)
    assert from_flat.keys() == nested.keys() == flat.keys()
    for k, v in nested.items():
        assert torch.equal(v, from_flat[k]) and np.array_equal(v.numpy(), flat[k])


# ------------------------------------------------------------------- layers

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    scale = (1.0 + rng.normal(size=(64,)) * 0.1).astype(np.float32)
    out = L.rmsnorm({"scale": _t(scale)}, _t(x)).numpy()
    exp = np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    np.testing.assert_allclose(out, exp, atol=ATOL)
    assert torch.equal(L.norm("rms", {"scale": _t(scale)}, _t(x)), _t(out))


@pytest.mark.parametrize("theta,offset", [(1e4, 0), (1e5, 1000), (1e6, 37)])
def test_apply_rope_matches_reference(theta, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(offset + np.arange(9, dtype=np.int32), (2, 9))
    out = L.apply_rope(_t(x), _t(pos.copy()), theta).numpy()
    exp = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(out, exp, atol=ATOL)
    np.testing.assert_allclose(L.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)), rtol=1e-6)


def test_swiglu_embed_unembed_match_reference():
    rng = np.random.default_rng(2)
    p = {n: {"w": rng.normal(size=sh).astype(np.float32) * 0.1}
         for n, sh in (("gate", (16, 32)), ("up", (16, 32)), ("down", (32, 16)))}
    x = rng.normal(size=(3, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = param.tree_map(_t, p)
    np.testing.assert_allclose(L.swiglu(tp, _t(x)).numpy(),
                               np.asarray(JL.swiglu(jp, jnp.asarray(x))), atol=ATOL)
    table = {"table": rng.normal(size=(11, 16)).astype(np.float32)}
    ids = np.asarray([[3, 0, 10], [7, 7, 1]], np.int32)
    emb = L.embed(param.tree_map(_t, table), _t(ids))
    assert torch.equal(emb, _t(np.asarray(JL.embed(jax.tree.map(jnp.asarray, table),
                                                   jnp.asarray(ids)))))
    np.testing.assert_allclose(
        L.unembed(param.tree_map(_t, table), emb).numpy(),
        np.asarray(JL.unembed(jax.tree.map(jnp.asarray, table), jnp.asarray(emb.numpy()))),
        atol=ATOL)


def _attn_params(seed, qk_norm, bias):
    specs = JL.attention_specs(32, 6, 2, 8, bias=bias, qk_norm=qk_norm)
    jp = jparam.init_params(specs, jax.random.key(seed))
    if bias:  # zeros at init: make them count
        jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    tspecs = L.attention_specs(32, 6, 2, 8, bias=bias, qk_norm=qk_norm)
    assert _spec_leaves(specs) == _spec_leaves(tspecs)
    return jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


ATTN_KW = dict(n_heads=6, n_kv=2, head_dim=8, causal=True, rope=True, rope_theta=1e5)


@pytest.mark.parametrize("qk_norm,bias", [(False, True), (True, False)])
def test_gqa_attention_prefill_matches_reference(qk_norm, bias):
    jp, tp = _attn_params(3, qk_norm, bias)
    x = np.random.default_rng(3).normal(size=(2, 24, 32)).astype(np.float32)
    jy, (jk, jv) = JL.attention(jp, jnp.asarray(x), **ATTN_KW, return_kv=True)
    ty, (tk, tv) = L.attention(tp, _t(x), **ATTN_KW, return_kv=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    assert tk.shape == (2, 24, 2, 8)


@pytest.mark.parametrize("qk_norm,bias", [(False, True), (True, False)])
@pytest.mark.parametrize("index", [0, 13, 39])
def test_gqa_attention_cached_decode_matches_reference(qk_norm, bias, index):
    jp, tp = _attn_params(4, qk_norm, bias)
    rng = np.random.default_rng(index)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 40, 2, 8)).astype(np.float32) for _ in "kv")
    jy, (jk, jv) = JL.attention(jp, jnp.asarray(x), **ATTN_KW,
                                kv_cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                cache_index=jnp.int32(index))
    tkc, tvc = _t(kc.copy()), _t(vc.copy())
    ty, (tk, tv) = L.attention(tp, _t(x), **ATTN_KW, kv_cache=(tkc, tvc), cache_index=index)
    assert tk is tkc and tv is tvc  # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("index", [0, 17, 63])
def test_masked_causal_sdpa_at_decode_is_decode_attention_ref(index):
    """The ground of the port's routing, on the reference alone: at one
    query, the reference's masked causal ``layers.sdpa`` (what its decode
    step runs) computes ``decode_attention_ref(q, k, v, index + 1)``."""
    rng = np.random.default_rng(index + 5)
    q = jnp.asarray(rng.normal(size=(2, 1, 12, 16)).astype(np.float32))
    k, v = (jnp.asarray(rng.normal(size=(2, 64, 2, 16)).astype(np.float32)) for _ in "kv")
    mask = (jnp.arange(64) < index + 1)[None, None, None, None, :]
    out = JL.sdpa(q, k, v, causal=True, mask=mask, q_offset=index)
    exp = jref.decode_attention_ref(q[:, 0], k, v, jnp.int32(index + 1))
    np.testing.assert_allclose(np.asarray(out[:, 0]), np.asarray(exp), atol=2e-6)


# ---------------------------------------------------------------- the path

@functools.lru_cache(maxsize=None)
def _jax_prefill(name, attn_chunk):
    jmod, _ = CONFIGS[name]
    cfg = dataclasses.replace(jmod.SMOKE, attn_chunk=attn_chunk)
    return jax.jit(functools.partial(jlm.prefill, cfg=cfg, max_len=48))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("attn_chunk", [16, 512])
def test_prefill_matches_reference(name, attn_chunk):
    """attn_chunk=16 sends the reference through ``chunked_sdpa`` (S=32 > 16),
    the default 512 through ``sdpa``."""
    jmod, tmod = CONFIGS[name]
    jp, tp = _params(name)
    toks = _tokens(tmod.SMOKE, (2, 32), seed=1)
    jlogits, jcache = _jax_prefill(name, attn_chunk)(jp, tokens=jnp.asarray(toks))
    logits, cache = lm.prefill(tp, tmod.SMOKE, _t(toks), max_len=48)
    assert logits.shape == (2, 1, tmod.SMOKE.vocab) and cache["k"].shape == (2, 2, 48, 2, 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    for n in "kv":
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_forced_decode_matches_reference(name):
    """Prefill 24 tokens, then 8 decode steps fed the same tokens in both
    packages: logits at every step and the caches at the end."""
    jmod, tmod = CONFIGS[name]
    jcfg, cfg = jmod.SMOKE, tmod.SMOKE
    jp, tp = _params(name)
    toks = _tokens(cfg, (2, 32), seed=2)
    jlogits, jcache = jax.jit(functools.partial(jlm.prefill, cfg=jcfg, max_len=40))(
        jp, tokens=jnp.asarray(toks[:, :24]))
    logits, cache = lm.prefill(tp, cfg, _t(toks[:, :24]), max_len=40)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    jstep = jax.jit(jlm.decode_step, static_argnums=1)
    for i in range(8):
        idx = 24 + i
        tok = toks[:, idx:idx + 1]
        jlogits, jcache = jstep(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(idx))
        logits, cache = lm.decode_step(tp, cfg, _t(tok), cache, idx)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"step {i}")
    for n in "kv":
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), atol=ATOL)


def test_decode_step_writes_the_cache_in_place_and_checks_the_index():
    _, tp = _params("starcoder2-3b")
    cfg = starcoder2_3b.SMOKE
    _, cache = lm.prefill(tp, cfg, _t(_tokens(cfg, (2, 5), seed=3)), max_len=8)
    k_before = cache["k"].clone()
    _, out = lm.decode_step(tp, cfg, _t(_tokens(cfg, (2, 1), seed=4)), cache, 5)
    assert out is cache
    assert torch.equal(cache["k"][:, :, :5], k_before[:, :, :5])
    assert not torch.equal(cache["k"][:, :, 5], k_before[:, :, 5])
    assert torch.all(cache["k"][:, :, 6:] == 0)
    with pytest.raises(ValueError, match="capacity"):
        lm.decode_step(tp, cfg, _t(_tokens(cfg, (2, 1), seed=4)), cache, 8)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = starcoder2_3b.SMOKE
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        param.init_params(lm.specs(cfg), torch.Generator())
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == (2, 2, 8, 2, 16) and cache["k"].dtype == torch.bfloat16
    tp = param.init_params(lm.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    on_meta = param.tree_map(lambda a: a.to("meta"), tp)
    with pytest.raises(ValueError, match="meta"):
        lm.prefill(on_meta, cfg, torch.zeros((2, 4), dtype=torch.int32))
