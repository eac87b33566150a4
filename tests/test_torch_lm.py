"""The port's LM (dense and MoE) against the reference, on the CPU, in f32.

Same weights (the reference's ``init_params``, through ``from_jax_params``)
and the same numpy inputs go through both packages. Tolerances: layers and
logits atol 1e-5 (f32; the two frameworks sum in other orders), caches
atol 1e-5. The reference's prefill is run both through its ``chunked_sdpa``
(``attn_chunk=16``) and its dense ``sdpa`` (the default threshold); the
port has one path, the flash kernel's plain version. Decode runs
teacher-forced: both packages get the same tokens at every step. The MoE
configs (qwen3-moe-30b-a3b, granite-moe-3b-a800m) must also route every
token to the same experts at every layer. The int8 cache may differ from
the reference's by one step only where the value lies within 1e-4 of a
rounding boundary (counted); logits read from such a cache are not held to
1e-5.
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
from repro.configs import granite_moe_3b_a800m as jgr
from repro.configs import internlm2_1_8b as jil
from repro.configs import qwen3_moe_30b_a3b as jqw
from repro.configs import starcoder2_3b as jsc
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import param as jparam

from repro_torch.configs import granite_moe_3b_a800m, internlm2_1_8b, qwen3_moe_30b_a3b
from repro_torch.configs import starcoder2_3b
from repro_torch.models import layers as L
from repro_torch.models import lm, moe, param

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ATOL = 1e-5
QUANT_SCALE = 0.05  # the reference hillclimb's int8 cache variants
CONFIGS = {"starcoder2-3b": (jsc, starcoder2_3b), "internlm2-1.8b": (jil, internlm2_1_8b),
           "qwen3-moe-30b-a3b": (jqw, qwen3_moe_30b_a3b),
           "granite-moe-3b-a800m": (jgr, granite_moe_3b_a800m)}
MOE_NAMES = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
# tests/test_archs.py::test_full_config_param_counts' bands
PARAM_BANDS = {"starcoder2-3b": (2.5e9, 3.6e9), "internlm2-1.8b": (1.5e9, 2.3e9),
               "qwen3-moe-30b-a3b": (25e9, 34e9), "granite-moe-3b-a800m": (2.5e9, 4.2e9)}


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
    _assert_same_fields(jc, tc)
    assert jc.hd == tc.hd and (jc.moe is None) == (name not in MOE_NAMES)
    if jc.moe is not None:
        _assert_same_fields(jc.moe, tc.moe)
        assert (jc.moe.e_pad, jc.moe.capacity()) == (tc.moe.e_pad, tc.moe.capacity())


def _assert_same_fields(jc, tc):
    for f in dataclasses.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if f.name in ("dtype", "router_dtype"):
            assert str(jnp.dtype(jv)) == str(tv).removeprefix("torch."), f.name
        elif f.name != "moe":
            assert jv == tv, f.name


@pytest.mark.parametrize("scale,layout", [(None, "stacked"), (0.05, "stacked"),
                                          (None, "per_layer"), (0.05, "per_layer")])
def test_cache_options_are_accepted(scale, layout):
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.SMOKE, cache_quant_scale=scale,
                              cache_layout=layout)
    jcfg = dataclasses.replace(jqw.SMOKE, cache_quant_scale=scale, cache_layout=layout)
    assert str(cfg.cache_dtype).removeprefix("torch.") == str(jnp.dtype(jcfg.cache_dtype))
    cache = lm.init_cache(cfg, 2, 8, dtype=cfg.cache_dtype, device="cpu")
    jcache = jlm.init_cache(jcfg, 2, 8, dtype=jcfg.cache_dtype)
    flat = param.flatten({"c": cache} if layout == "stacked" else {str(i): c for i, c in
                                                                   enumerate(cache)})
    jflat = param.flatten({"c": jcache} if layout == "stacked" else {str(i): c for i, c in
                                                                     enumerate(jcache)})
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in flat.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in jflat.items()}
    with pytest.raises(ValueError, match="cache_layout"):
        dataclasses.replace(cfg, cache_layout="paged")


# -------------------------------------------------------------------- specs

def _spec_leaves(tree):
    return {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
            for k, s in param.flatten(tree).items()}


@pytest.mark.parametrize("name,which", [
    ("starcoder2-3b", "SMOKE"), ("internlm2-1.8b", "SMOKE"), ("starcoder2-3b", "CONFIG"),
    ("internlm2-1.8b", "CONFIG"), ("qwen3-moe-30b-a3b", "SMOKE"),
    ("granite-moe-3b-a800m", "SMOKE"), ("qwen3-moe-30b-a3b", "CONFIG"),
    ("granite-moe-3b-a800m", "CONFIG"),
])
def test_specs_match_reference_leaf_for_leaf(name, which):
    jmod, tmod = CONFIGS[name]
    jspecs = _spec_leaves(jlm.specs(getattr(jmod, which)))
    tspecs = _spec_leaves(lm.specs(getattr(tmod, which)))
    assert jspecs == tspecs
    if which == "CONFIG":
        n = sum(math.prod(s[0]) for s in tspecs.values())
        lo, hi = PARAM_BANDS[name]
        assert lo <= n <= hi
        assert n == jparam.param_count(jlm.specs(jmod.CONFIG))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_bridge_carries_an_lm_tree(name):
    """Nested and flat (arrays.npz) reference trees give the same tensors;
    the untied config brings its ``lm_head``."""
    jp, tp = _params(name)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jp).items()}
    assert {"embed/table", "norm_f/scale", "blocks/attn/wq"} <= set(flat)
    assert ("lm_head/w" in flat) == (not CONFIGS[name][1].SMOKE.tie_embeddings)
    assert ("blocks/moe/w_gate" in flat) == (name in MOE_NAMES)
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


# ---------------------------------------------------------------------- MoE

def _recording_routes(monkeypatch, module):
    """Wrap ``module.route`` (the reference's or the port's) to record the
    experts of every call, as numpy, in call order."""
    record = []
    route = module.route

    def recording(cfg, logits):
        gates, experts = route(cfg, logits)
        record.append(np.asarray(experts).reshape(-1, cfg.top_k))
        return gates, experts

    monkeypatch.setattr(module, "route", recording)
    return record


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_routes_equal_reference_at_every_layer(name, monkeypatch):
    """Prefill 24 tokens, then 4 teacher-forced steps: every layer of every
    call sends every token to the same experts, in the same order, in both
    packages (the reference run eagerly, so that its routes are concrete)."""
    jmod, tmod = CONFIGS[name]
    jp, tp = _params(name)
    toks = _tokens(tmod.SMOKE, (2, 28), seed=6)
    jrec, trec = _recording_routes(monkeypatch, jmoe), _recording_routes(monkeypatch, moe)
    with jax.disable_jit():
        _, jcache = jlm.prefill(jp, jmod.SMOKE, jnp.asarray(toks[:, :24]), max_len=28)
        for idx in range(24, 28):
            _, jcache = jlm.decode_step(jp, jmod.SMOKE, jnp.asarray(toks[:, idx:idx + 1]),
                                        jcache, jnp.int32(idx))
    _, cache = lm.prefill(tp, tmod.SMOKE, _t(toks[:, :24]), max_len=28)
    for idx in range(24, 28):
        lm.decode_step(tp, tmod.SMOKE, _t(toks[:, idx:idx + 1]), cache, idx)
    n_layers = tmod.SMOKE.n_layers
    assert len(trec) == len(jrec) == 5 * n_layers
    for call, (a, b) in enumerate(zip(trec, jrec)):
        assert np.array_equal(a, b), f"call {call}"
    assert trec[0].shape == (48, tmod.SMOKE.moe.top_k) and trec[-1].shape[0] == 2


@pytest.mark.parametrize("name", ["starcoder2-3b", *MOE_NAMES])
def test_forward_and_lm_loss_match_reference(name):
    """The training forward: logits at every position, the summed MoE aux
    loss (0 for a dense model) and the next-token loss."""
    jmod, tmod = CONFIGS[name]
    jp, tp = _params(name)
    toks = _tokens(tmod.SMOKE, (2, 33), seed=7)
    inputs, labels = toks[:, :-1], toks[:, 1:]
    jlogits, jaux = jax.jit(jlm.forward, static_argnums=1)(jp, jmod.SMOKE, jnp.asarray(inputs))
    jloss = jlm.lm_loss(jlogits, jnp.asarray(labels))
    logits, aux = lm.forward(tp, tmod.SMOKE, _t(inputs))
    loss = lm.lm_loss(logits, _t(labels))
    assert logits.shape == (2, 32, tmod.SMOKE.vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert (aux.item() > 0) == (name in MOE_NAMES)
    # the prefill's last-position logits are the forward's
    last, _ = lm.prefill(tp, tmod.SMOKE, _t(inputs))
    np.testing.assert_allclose(last[:, 0].numpy(), logits[:, -1].numpy(), atol=ATOL)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_a2a_without_a_mesh_is_the_gspmd_path(name):
    """``moe_impl="a2a"`` with no mesh: the reference falls back to the gspmd
    path, and so does the port (bit-equal to its own gspmd forward)."""
    jmod, tmod = CONFIGS[name]
    jp, tp = _params(name)
    toks = _tokens(tmod.SMOKE, (2, 32), seed=8)
    jcfg = dataclasses.replace(jmod.SMOKE, moe_impl="a2a")
    cfg = dataclasses.replace(tmod.SMOKE, moe_impl="a2a")
    jlogits, jaux = jax.jit(jlm.forward, static_argnums=1)(jp, jcfg, jnp.asarray(toks))
    logits, aux = lm.forward(tp, cfg, _t(toks))
    glogits, gaux = lm.forward(tp, tmod.SMOKE, _t(toks))
    assert torch.equal(logits, glogits) and torch.equal(aux, gaux)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


# ------------------------------------------------------------ cache options

def _per_layer(cache):
    return [{"k": cache["k"][l], "v": cache["v"][l]} for l in range(cache["k"].shape[0])]


@pytest.mark.parametrize("name", ["starcoder2-3b", *MOE_NAMES])
def test_per_layer_cache_equals_stacked_and_reference(name):
    """The ``per_layer`` layout: logits bit-equal to the stacked layout's on
    the CPU at every step, the same cache contents, and logits equal to the
    reference's ``per_layer`` decode (its prefill returns the stacked
    layout; its decode takes the list)."""
    jmod, tmod = CONFIGS[name]
    jp, tp = _params(name)
    cfg = dataclasses.replace(tmod.SMOKE, cache_layout="per_layer")
    jcfg = dataclasses.replace(jmod.SMOKE, cache_layout="per_layer")
    toks = _tokens(cfg, (2, 30), seed=9)
    logits_s, cache_s = lm.prefill(tp, tmod.SMOKE, _t(toks[:, :24]), max_len=32)
    logits_p, cache_p = lm.prefill(tp, cfg, _t(toks[:, :24]), max_len=32)
    assert isinstance(cache_p, list) and len(cache_p) == cfg.n_layers
    assert cache_p[0]["k"].shape == (2, 32, cfg.n_kv, cfg.hd)
    assert torch.equal(logits_s, logits_p)
    _, jstacked = jax.jit(functools.partial(jlm.prefill, cfg=jmod.SMOKE, max_len=32))(
        jp, tokens=jnp.asarray(toks[:, :24]))
    jcache = _per_layer(jstacked)
    jstep = jax.jit(jlm.decode_step, static_argnums=1)
    for idx in range(24, 30):
        tok = toks[:, idx:idx + 1]
        logits_s, _ = lm.decode_step(tp, tmod.SMOKE, _t(tok), cache_s, idx)
        logits_p, out = lm.decode_step(tp, cfg, _t(tok), cache_p, idx)
        jlogits, jcache = jstep(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(idx))
        assert out is cache_p
        assert torch.equal(logits_s, logits_p), f"step {idx}"
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"step {idx}")
    for l, layer in enumerate(cache_p):
        for n in "kv":
            assert torch.equal(layer[n], cache_s[n][l])
            np.testing.assert_allclose(layer[n].numpy(), np.asarray(jcache[l][n]), atol=ATOL)
    with pytest.raises(ValueError, match="cache_layout"):
        lm.decode_step(tp, cfg, _t(toks[:, :1]), cache_s, 30)


def _shadow_cache(records, n_layers, prompt, steps):
    """The port's unrounded ``x / scale`` for every cache entry, from the
    recorded ``_quantize`` calls: the prefill's k then v per layer, then
    each step's k then v per layer."""
    it = iter(records)
    shadow = {}
    for l in range(n_layers):
        for n in "kv":
            x = next(it)
            shadow.setdefault(n, np.zeros((n_layers, x.shape[0], prompt + steps,
                                           *x.shape[2:]), np.float32))[l, :, :prompt] = x
    for i in range(steps):
        for l in range(n_layers):
            for n in "kv":
                shadow[n][l, :, prompt + i] = next(it)
    return shadow


def _judged_entries(differ_k, differ_v, prompt):
    """Which cache positions, per layer, are not downstream of a flip:
    ([L, S] bool, the first flipped position, or S). Prefill entries never
    are (the prefill attends over unquantized k/v). A decode step's entries
    are downstream of every flip at an earlier position, and of one at its
    own position in an earlier layer."""
    flip_at = (differ_k | differ_v).any(axis=(1, 3, 4))  # [L, S]
    n_layers, s = flip_at.shape
    positions = np.nonzero(flip_at.any(axis=0))[0]
    first = int(positions.min()) if len(positions) else s
    judged = np.zeros_like(flip_at)
    judged[:, :max(prompt, first)] = True
    if prompt <= first < s:
        judged[:np.nonzero(flip_at[:, first])[0].min() + 1, first] = True
    return judged, first


def test_judged_entries_marks_what_a_flip_reaches():
    differ = np.zeros((3, 1, 10, 1, 1), bool)
    judged, first = _judged_entries(differ, differ, prompt=6)
    assert first == 10 and judged.all()
    differ[1, 0, 7] = True  # a decode flip: layer 1 at position 7
    judged, first = _judged_entries(differ, differ.copy(), prompt=6)
    assert first == 7 and judged[:, :7].all() and judged[:2, 7].all()
    assert not judged[2, 7] and not judged[:, 8:].any()
    differ[0, 0, 2] = True  # a prefill flip: every decode entry reads it
    judged, first = _judged_entries(differ, differ.copy(), prompt=6)
    assert first == 2 and judged[:, :6].all() and not judged[:, 6:].any()


@pytest.mark.parametrize("name", ["starcoder2-3b", *MOE_NAMES])
@pytest.mark.parametrize("seed", [0, 7])  # qwen3 at seed 7: 5 flips from position 7
def test_int8_cache_matches_reference(name, seed, monkeypatch):
    """``cache_quant_scale=0.05``: the prefill attends over unquantized k/v
    and stores int8 steps; decode stores the step's and attends over the
    dequantized cache. Every int8 entry equals the reference's, except one
    step apart where the port's unrounded ``|x/scale|`` lies within 1e-4 of
    a rounding boundary (the frameworks' f32 sums differ by ~1e-6); such
    flips are counted. Entries written after a flip, and logits that read
    one, are downstream of it and not compared; every other logit within
    1e-5."""
    jmod, tmod = CONFIGS[name]
    jcfg = dataclasses.replace(jmod.SMOKE, cache_quant_scale=QUANT_SCALE)
    cfg = dataclasses.replace(tmod.SMOKE, cache_quant_scale=QUANT_SCALE)
    jp, tp = _params(name, seed)
    prompt, steps = 24, 8
    toks = _tokens(cfg, (2, prompt + steps), seed=10 + seed)
    records = []
    quantize = L._quantize

    def recording(t, scale, dtype):
        if scale is not None:
            records.append(t.float().numpy() / np.float32(scale))
        return quantize(t, scale, dtype)

    monkeypatch.setattr(L, "_quantize", recording)
    jlogits, jcache = jax.jit(functools.partial(jlm.prefill, cfg=jcfg, max_len=prompt + steps))(
        jp, tokens=jnp.asarray(toks[:, :prompt]))
    logits, cache = lm.prefill(tp, cfg, _t(toks[:, :prompt]), max_len=prompt + steps)
    assert cache["k"].dtype == torch.int8 and jcache["k"].dtype == jnp.int8
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)  # no cache read
    jstep = jax.jit(jlm.decode_step, static_argnums=1)
    step_logits = []
    for i in range(steps):
        idx = prompt + i
        tok = toks[:, idx:idx + 1]
        jlogits, jcache = jstep(jp, jcfg, jnp.asarray(tok), jcache, jnp.int32(idx))
        logits, cache = lm.decode_step(tp, cfg, _t(tok), cache, idx)
        step_logits.append((logits.numpy(), np.asarray(jlogits)))
    shadow = _shadow_cache(records, cfg.n_layers, prompt, steps)
    got = {n: cache[n].numpy().astype(np.int32) for n in "kv"}
    exp = {n: np.asarray(jcache[n]).astype(np.int32) for n in "kv"}
    for n in "kv":  # the recorder saw what was stored
        assert np.array_equal(np.clip(np.round(shadow[n]), -127, 127), got[n])
    judged, first_flip = _judged_entries(got["k"] != exp["k"], got["v"] != exp["v"], prompt)
    flips = sum(int((got[n] != exp[n]).sum()) for n in "kv")
    for n in "kv":
        differ = (got[n] != exp[n]) & judged[:, None, :, None, None]
        assert np.all(np.abs(got[n] - exp[n])[differ] == 1), n
        near = np.abs(np.abs(shadow[n]) % 1.0 - 0.5) < 1e-4
        assert np.all(near[differ]), f"{n}: a flip away from a rounding boundary"
    for i, (a, b) in enumerate(step_logits):
        if prompt + i < first_flip:  # every cache entry this step read is equal
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"step {i}")
    print(f"{name} seed {seed}: {flips} int8 entries one step apart of "
          f"{2 * cache['k'].numel()}, first at position {first_flip}")
    assert flips <= 1e-3 * 2 * cache["k"].numel()


@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
def test_int8_cache_decode_dequantizes_before_the_kernel(layout, monkeypatch):
    """Decode hands the decode kernel the cache dequantized in the
    activation dtype (``cache.float() * scale``), never raw int8 codes."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.SMOKE, cache_quant_scale=QUANT_SCALE,
                              cache_layout=layout)
    _, tp = _params("qwen3-moe-30b-a3b")
    toks = _tokens(cfg, (2, 9), seed=12)
    _, cache = lm.prefill(tp, cfg, _t(toks[:, :8]), max_len=12)
    seen = []
    decode = ops.decode_attention

    def recording(q, k, v, lengths):
        seen.append((k.dtype, v.dtype, k.clone()))
        return decode(q, k, v, lengths)

    monkeypatch.setattr(ops, "decode_attention", recording)
    lm.decode_step(tp, cfg, _t(toks[:, 8:]), cache, 8)
    assert len(seen) == cfg.n_layers
    k0 = cache["k"][0] if layout == "stacked" else cache[0]["k"]
    assert k0.dtype == torch.int8
    assert all(kd == vd == torch.float32 for kd, vd, _ in seen)
    assert torch.equal(seen[0][2], k0.float() * QUANT_SCALE)


# --------------------------------------------------------------------- init

@pytest.mark.parametrize("init,dtype", [("fan_in", torch.bfloat16), ("normal", torch.float32)])
def test_stacked_leaf_drawn_a_layer_at_a_time(init, dtype):
    """A leaf stacked over layers is drawn one layer at a time into a buffer
    of the target dtype: the whole leaf keeps the reference's std (fan_in
    of the whole stacked shape), the same seed repeats it, and each layer
    is a fresh draw."""
    spec = param.ParamSpec((6, 96, 40), ("layers", "embed", "mlp"), init=init)
    std = 1 / math.sqrt(6 * 96) if init == "fan_in" else 0.02
    p = param.init_params({"w": spec}, torch.Generator().manual_seed(3), "cpu", dtype=dtype)
    w = p["w"]
    assert w.dtype == dtype and w.shape == (6, 96, 40)
    assert abs(w.float().std().item() / std - 1) < 0.03
    assert abs(w.float().mean().item()) < 0.03 * std
    again = param.init_params({"w": spec}, torch.Generator().manual_seed(3), "cpu", dtype=dtype)
    assert torch.equal(w, again["w"])
    other = param.init_params({"w": spec}, torch.Generator().manual_seed(4), "cpu", dtype=dtype)
    assert not torch.equal(w, other["w"])
    assert not any(torch.equal(w[0], w[l]) for l in range(1, 6))
    jspec = jparam.ParamSpec((6, 96, 40), ("layers", "embed", "mlp"), init=init)
    jw = np.asarray(jparam.init_params({"w": jspec}, jax.random.key(0))["w"])
    assert abs(jw.std() / std - 1) < 0.03  # the reference's rule, the same std
