"""The port's ViT, layers, ToMe and weight bridge against the reference.

Same weights (the reference's ``init_params``, through ``from_jax_params``)
and the same numpy inputs go through both packages on the CPU, in f32.
Tolerances: logits atol 1e-5 (``forward_janus``, the 50-token geometry of
``tests/test_execute_bucketed.py``); ToMe merged values atol 1e-6 with
identical merge indices; padded vs unpadded cloud forward atol 2e-6
(``PAD_ATOL`` of the reference tests); layer outputs atol 1e-5. Each trap
listed in ROADMAP.md (GELU form, layernorm eps, stable sorts, deterministic
scatter-add, sizes dtype, index dtype) has a test here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.core import engine as jengine
from repro.core import pruning as jpruning
from repro.core import tome as jtome
from repro.models import layers as JL
from repro.models import param as jparam
from repro.models import vit as jvit

from repro_torch.core import engine, pruning, tome
from repro_torch.models import layers as L
from repro_torch.models import param, vit

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ALPHAS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
SPLIT = 4
PAD_ATOL = 2e-6


def _cfgs(fused_qkv=False):
    kw = dict(img_res=56, patch=8, n_layers=6, d_model=32, n_heads=2, d_ff=64,
              n_classes=8, fused_qkv=fused_qkv)
    return jvit.ViTConfig(**kw), vit.ViTConfig(**kw)


@functools.lru_cache(maxsize=None)
def _params(jcfg, seed=0):
    # the reference's eager init takes seconds; tests only read the params
    jp = jparam.init_params(jvit.specs(jcfg), jax.random.key(seed))
    return jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _images(cfg, seed=0, batch=1):
    rng = np.random.default_rng(100 + seed)
    return rng.normal(size=(batch, cfg.img_res, cfg.img_res, 3)).astype(np.float32)


_jmatch = jax.jit(jtome.bipartite_soft_matching, static_argnums=1)
_jmerge = jax.jit(jtome.tome_merge, static_argnums=3)
_jmerge_padded = jax.jit(jtome.tome_merge_padded, static_argnums=3)


def _jit_forward(jcfg, sched):
    # the reference's unrolled forward is far too slow op by op on the CPU
    return jax.jit(lambda p, img: jvit.forward_janus(p, jcfg, img, sched))


# ------------------------------------------------------------- weight bridge

@pytest.mark.parametrize("fused_qkv", [False, True])
def test_specs_tree_matches_reference(fused_qkv):
    jcfg, cfg = _cfgs(fused_qkv)
    jflat = {k: (s.shape, s.init) for k, s in jax_flatten(jvit.specs(jcfg)).items()}
    flat = {k: (s.shape, s.init) for k, s in param.flatten(vit.specs(cfg)).items()}
    assert flat == jflat


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_weight_bridge_round_trip(fused_qkv, tmp_path):
    """Nested numpy tree and the checkpointer's flat arrays.npz both load bit
    for bit, in the reference's [d_in, d_out] layout, stacked over layers."""
    jcfg, cfg = _cfgs(fused_qkv)
    jp, tp = _params(jcfg)
    jflat = {k: np.asarray(v) for k, v in jax_flatten(jp).items()}
    np.savez(tmp_path / "arrays.npz", **jflat)
    with np.load(tmp_path / "arrays.npz") as npz:
        from_npz = param.from_jax_params(npz, "cpu")
    for tree in (tp, from_npz):
        flat = param.flatten(tree)
        assert flat.keys() == jflat.keys()
        for key, arr in jflat.items():
            assert flat[key].dtype == torch.float32
            assert np.array_equal(flat[key].numpy(), arr), key
    w = "wqkv" if fused_qkv else "wq"
    assert tuple(tp["blocks"]["attn"][w].shape)[:2] == (cfg.n_layers, cfg.d_model)


def test_weight_bridge_bf16_leaves():
    jp = {"w": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)}
    tp = param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["w"].dtype == torch.bfloat16
    assert np.array_equal(tp["w"].float().numpy(), np.asarray(jp["w"], np.float32))


def test_init_params_distributions():
    """Same init rules as the reference (its numbers differ: another RNG):
    every leaf's mean and std agree, zeros and ones exactly."""
    jcfg, cfg = _cfgs()
    p = param.init_params(vit.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    jp, _ = _params(jcfg)
    flat = param.flatten(p)
    for key, ref in jax_flatten(jp).items():
        ref = np.asarray(ref)
        got = flat[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        if ref.std() == 0:
            assert np.array_equal(got, ref), key
        elif ref.size >= 1000:
            assert abs(got.std() / ref.std() - 1) < 0.1, key
            assert abs(got.mean() - ref.mean()) < 0.1 * ref.std(), key
    again = param.init_params(vit.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["pos"], again["pos"])


# ---------------------------------------------------------------------- traps

def test_gelu_is_the_tanh_form():
    rng = np.random.default_rng(0)
    p = {"fc1": {"w": rng.normal(size=(8, 16)).astype(np.float32),
                 "b": rng.normal(size=16).astype(np.float32)},
         "fc2": {"w": rng.normal(size=(16, 8)).astype(np.float32),
                 "b": np.zeros(8, np.float32)}}
    x = rng.normal(size=(2, 5, 8)).astype(np.float32) * 3
    tp = param.from_jax_params(p, "cpu")
    out = L.mlp(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(JL.mlp(jax.tree.map(jnp.asarray, p),
                                                      jnp.asarray(x))), atol=1e-5)
    h = torch.from_numpy(x) @ tp["fc1"]["w"] + tp["fc1"]["b"]
    erf = (torch.nn.functional.gelu(h) @ tp["fc2"]["w"]).numpy()
    assert np.abs(erf - out).max() > 1e-4  # the erf form would be a different model


def test_layernorm_eps_and_f32_math():
    rng = np.random.default_rng(1)
    x = (1e-3 * rng.normal(size=(3, 64))).astype(np.float32)  # var ~1e-6 ~ eps
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": np.zeros(64, np.float32)}
    tp = param.from_jax_params(p, "cpu")
    out = L.layernorm(tp, torch.from_numpy(x)).numpy()
    ref = np.asarray(JL.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    torch_default = torch.nn.functional.layer_norm(torch.from_numpy(x), (64,),
                                                   tp["scale"], tp["bias"]).numpy()
    assert np.abs(torch_default - ref).max() > 1e-2  # eps 1e-5 is another function
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert L.layernorm(tp, xb).dtype == torch.bfloat16


def test_stable_sort_on_exact_ties():
    """Duplicate tokens give exactly tied similarities: the merge order must
    follow the reference's stable argsort."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(1, 4, 16)).astype(np.float32)
    metric = np.concatenate([base] * 6, axis=1)  # 24 tokens, heavy ties
    x = rng.normal(size=(1, 24, 16)).astype(np.float32)
    sizes = np.ones((1, 24), np.float32)
    for r in (3, 7, 11):
        ji = _jmatch(jnp.asarray(metric), r)
        ti = tome.bipartite_soft_matching(torch.from_numpy(metric), r)
        for a, b in zip(ti, ji):
            assert np.array_equal(a.numpy(), np.asarray(b))
        jx, js = _jmerge(jnp.asarray(x), jnp.asarray(metric), jnp.asarray(sizes), r)
        tx, ts = tome.tome_merge(torch.from_numpy(x), torch.from_numpy(metric),
                                 torch.from_numpy(sizes), r)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
        assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_is_sequential_and_deterministic(dtype):
    """``.at[dst].add`` sums colliding sources in source order, rounding to
    the array's dtype after each add: bf16 sizes above 256 round exactly as
    in the reference."""
    rng = np.random.default_rng(3)
    base = rng.integers(1, 300, size=(2, 9)).astype(np.float32)
    idx = rng.integers(0, 3, size=(2, 14))  # many collisions
    vals = rng.integers(1, 120, size=(2, 14)).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = jax.vmap(lambda b, i, v: b.at[i].add(v))(jnp.asarray(base, jd),
                                                    jnp.asarray(idx), jnp.asarray(vals, jd))
    td = getattr(torch, dtype)
    out = tome._scatter_add(torch.from_numpy(base).to(td), torch.from_numpy(idx),
                            torch.from_numpy(vals).to(td))
    assert out.dtype == td
    assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    if dtype == "bfloat16":
        assert float(out.float().max()) > 256  # the rounding regime is exercised


def test_sizes_carry_the_activation_dtype_and_indices_cast():
    _, cfg = _cfgs()
    cfg = vit.ViTConfig(**{**cfg.__dict__, "dtype": torch.bfloat16})
    p = param.init_params(vit.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    img = torch.from_numpy(_images(cfg))
    sched = tuple(pruning.make_schedule("exponential", 0.5, cfg.n_layers, cfg.num_tokens))
    x, sizes = engine.device_forward(p, cfg, img, sched, 3)
    assert x.dtype == sizes.dtype == torch.bfloat16
    idx = tome.bipartite_soft_matching(x.float(), 3)
    assert all(t.dtype == torch.int64 for t in idx)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("fused_qkv", [False, True])
def test_attention_and_metric_match_reference(fused_qkv):
    jcfg, cfg = _cfgs(fused_qkv)
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 50, cfg.d_model)).astype(np.float32)
    sizes = (1.0 + rng.integers(0, 4, size=(2, 50))).astype(np.float32)
    bias = np.log(sizes)
    jbp = jvit.layer_params(jp, 0)
    ja, _, jm = JL.attention(jbp["attn"], jnp.asarray(x), n_heads=2, n_kv=2, head_dim=16,
                             bias=jnp.asarray(bias), return_metric=True)
    ta, _, tm = L.attention(vit.layer_params(tp, 0)["attn"], torch.from_numpy(x), n_heads=2,
                            n_kv=2, head_dim=16, bias=torch.from_numpy(bias),
                            return_metric=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    assert tm.shape == (2, 50, 16)


# ----------------------------------------------------------------------- ToMe

def _merge_inputs(seed, b=2, t=21, d=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    metric = rng.normal(size=(b, t, d)).astype(np.float32)
    sizes = (1.0 + rng.uniform(size=(b, t))).astype(np.float32)
    return x, metric, sizes


@pytest.mark.parametrize("r", [1, 5, 9])
def test_tome_merge_matches_reference(r):
    x, metric, sizes = _merge_inputs(r)
    ji = _jmatch(jnp.asarray(metric), r)
    ti = tome.bipartite_soft_matching(torch.from_numpy(metric), r)
    for a, b in zip(ti, ji):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jx, js = _jmerge(jnp.asarray(x), jnp.asarray(metric), jnp.asarray(sizes), r)
    tx, ts = tome.tome_merge(torch.from_numpy(x), torch.from_numpy(metric),
                             torch.from_numpy(sizes), r)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("pad", [1, 4, 9])
def test_tome_merge_padded_matches_reference(pad):
    x, metric, sizes = _merge_inputs(7)
    r = 5
    xp, mp, sp = (np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
                  for a in (x, metric, sizes))
    jx, js = _jmerge_padded(
        jnp.asarray(xp), jnp.asarray(mp), jnp.asarray(sp), r)
    tx, ts = tome.tome_merge_padded(torch.from_numpy(xp), torch.from_numpy(mp),
                                    torch.from_numpy(sp), r)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # the real tokens' merge is the unpadded merge
    ux, us = tome.tome_merge(torch.from_numpy(x), torch.from_numpy(metric),
                             torch.from_numpy(sizes), r)
    nr = x.shape[1] - r
    assert torch.equal(tome.padded_matching(torch.from_numpy(mp), torch.from_numpy(sp),
                                            r).src_idx,
                       tome.bipartite_soft_matching(torch.from_numpy(metric), r).src_idx)
    np.testing.assert_allclose(tx[:, :nr].numpy(), ux.numpy(), atol=1e-6)
    assert torch.all(ts[:, nr:] == 0)


def test_tome_merge_padded_validates_r():
    x = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        tome.tome_merge_padded(x, x, torch.ones((1, 8)), 4)


# ------------------------------------------------------------ whole forward

@pytest.mark.parametrize("alpha", ALPHAS)
def test_forward_janus_matches_reference(alpha):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    img = _images(cfg, batch=2)
    sched = tuple(pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens))
    assert sched == tuple(jpruning.make_schedule("exponential", alpha, jcfg.n_layers,
                                                 jcfg.num_tokens))
    ref = _jit_forward(jcfg, sched)(jp, jnp.asarray(img))
    out = vit.forward_janus(tp, cfg, torch.from_numpy(img), sched)
    assert vit.token_counts(cfg, sched) == jvit.token_counts(jcfg, sched)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_fused_qkv_forward_matches_reference():
    jcfg, cfg = _cfgs(fused_qkv=True)
    jp, tp = _params(jcfg, seed=2)
    img = _images(cfg, seed=2)
    sched = tuple(pruning.make_schedule("exponential", 0.5, cfg.n_layers, cfg.num_tokens))
    np.testing.assert_allclose(
        vit.forward_janus(tp, cfg, torch.from_numpy(img), sched).numpy(),
        np.asarray(_jit_forward(jcfg, sched)(jp, jnp.asarray(img))), atol=1e-5)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_vanilla_forward_matches_reference(fused_qkv):
    """``vit.forward``: every block, no merging (the baseline Janus is
    measured against), on a batch of 2."""
    jcfg, cfg = _cfgs(fused_qkv=fused_qkv)
    jp, tp = _params(jcfg, seed=3)
    img = _images(cfg, seed=3, batch=2)
    ref = jax.jit(jvit.forward, static_argnums=1)(jp, jcfg, jnp.asarray(img))
    out = vit.forward(tp, cfg, torch.from_numpy(img))
    assert out.shape == (2, cfg.n_classes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # an all-zero schedule runs the same blocks
    zero = (0,) * cfg.n_layers
    assert torch.equal(out, vit.forward_janus(tp, cfg, torch.from_numpy(img), zero))


def _plan(tp, cfg, alpha, seed=0):
    sched = tuple(pruning.make_schedule("exponential", alpha, cfg.n_layers, cfg.num_tokens))
    x, sizes = engine.device_forward(tp, cfg, torch.from_numpy(_images(cfg, seed)),
                                     sched, SPLIT)
    return engine.ExecPlan(sched, SPLIT, x=x, sizes=sizes)


@pytest.mark.parametrize("alpha", (0.3, 0.6, 0.9))
def test_run_blocks_padded_matches_unpadded(alpha):
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg)
    plan = _plan(tp, cfg, alpha)
    ref = engine.cloud_forward(tp, cfg, plan.x, plan.sizes, plan.schedule, SPLIT)
    for pad in (0, 3, 8):
        xp, sp = engine._pad_tokens(plan.x, plan.sizes, plan.x.shape[1] + pad)
        x2, _ = vit.run_blocks_padded(tp, cfg, xp, sp, plan.schedule, SPLIT, cfg.n_layers)
        out = vit.head_apply(tp, cfg, x2)
        assert not torch.any(torch.isnan(out))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=PAD_ATOL, rtol=PAD_ATOL)


def test_padded_logits_bit_independent_of_pad_values():
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg)
    plan = _plan(tp, cfg, 0.5)
    pad = 6
    _, sp = engine._pad_tokens(plan.x, plan.sizes, plan.x.shape[1] + pad)
    xp0, _ = engine._pad_tokens(plan.x, plan.sizes, plan.x.shape[1] + pad)
    garbage = 1e3 * torch.from_numpy(
        np.random.default_rng(9).normal(size=(1, pad, cfg.d_model)).astype(np.float32))
    xp1 = torch.cat([plan.x, garbage], dim=1)
    fn = engine.CompiledPlanCache().cloud_padded_fn(cfg, plan.schedule[SPLIT:], SPLIT, xp0)
    assert torch.equal(fn(tp, xp0, sp), fn(tp, xp1, sp))


def test_device_partition_matches_reference():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    img = _images(cfg)
    sched = tuple(pruning.make_schedule("exponential", 0.7, cfg.n_layers, cfg.num_tokens))
    jx, js = jax.jit(lambda p, i: jengine.device_forward(p, jcfg, i, sched, SPLIT))(
        jp, jnp.asarray(img))
    tx, ts = engine.device_forward(tp, cfg, torch.from_numpy(img), sched, SPLIT)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
