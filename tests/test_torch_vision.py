"""The port's ResNet and Swin models and its architecture registry against
the reference, on the CPU in f32.

Weights: drawn in numpy by the reference's init rules, every
``init="zeros"`` leaf from N(0, 0.02^2), and (ResNet) every BatchNorm's
scale, mean and variance drawn too (at init mean 0 and var 1 make
eval-mode BatchNorm an affine no-op that would hide a wrong use of the
statistics), fed to both packages through ``from_jax_params``.

Tolerances: logits and stage features relative to their largest magnitude,
1e-5 (measured: ResNet eval 4.1e-7, train 5.8e-6 (batch statistics over
B=2 and 2x2 maps at the last stage amplify the summation order), stage
features 1.1e-6, Swin 3.5e-7; both packages run f32 convolutions and
matmuls, summed in another order); bf16 Swin on bf16 weights 5e-2
(measured 9.8e-3); the SAME convolution and max pool atol 1e-5 against
``lax.conv_general_dilated`` and ``lax.reduce_window``; the registry field
by field, torch dtypes mapped to the reference's jnp ones by name.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.configs import resnet_152 as jresnet_152
from repro.configs import swin_b as jswin_b
from repro.models import resnet as jresnet
from repro.models import swin as jswin

from repro_torch import configs
from repro_torch.configs import resnet_152, swin_b
from repro_torch.models import param, resnet, swin

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

REL = 1e-5
BF16_REL = 5e-2


def _draw(jspecs, seed: int = 0):
    """(reference tree, port tree) of the same numpy weights: the
    reference's init rules, zeros redrawn and BatchNorm scale, mean and
    variance drawn (var > 0)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, spec in jax_flatten(jspecs).items():
        bn_leaf = k.split("/")[-2].startswith("bn") and k.rsplit("/", 1)[-1]
        if bn_leaf in ("scale", "var"):
            flat[k] = rng.uniform(0.5, 1.5, spec.shape)
        elif bn_leaf == "mean":
            flat[k] = 0.2 * rng.standard_normal(spec.shape)
        elif spec.init == "ones":
            flat[k] = np.ones(spec.shape)
        else:
            std = 0.02 if spec.init == "zeros" else param._std(spec)
            flat[k] = std * rng.standard_normal(spec.shape)
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    return param.unflatten(flat), param.from_jax_params(flat, "cpu")


def _images(res, batch=2, seed=3):
    return np.random.default_rng(seed).standard_normal((batch, res, res, 3)).astype(np.float32)


def _close(got, exp, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype
    scale = np.abs(exp).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, atol=rel * scale, rtol=0)


# ------------------------------------------------------------------ ResNet

def _resnet_cfgs(**kw):
    return (dataclasses.replace(jresnet_152.SMOKE, **kw),
            dataclasses.replace(resnet_152.SMOKE, **kw))


@functools.lru_cache(maxsize=None)
def _resnet_params():
    return _draw(jresnet.specs(jresnet_152.SMOKE))


def test_resnet_specs_tree_matches_reference():
    jflat = {k: (s.shape, s.init, s.scale)
             for k, s in jax_flatten(jresnet.specs(jresnet_152.CONFIG)).items()}
    flat = {k: (s.shape, s.init, s.scale)
            for k, s in param.flatten(resnet.specs(resnet_152.CONFIG)).items()}
    assert flat == jflat


@pytest.mark.parametrize("size", [16, 15, 17, 38])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (3, 1), (1, 2), (1, 1)])
def test_same_conv_matches_xla(size, k, stride):
    """XLA's SAME padding, asymmetric where the total is odd."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    exp = jresnet.conv({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride)
    got = resnet.conv({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [16, 15, 112])
def test_max_pool_matches_reduce_window(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 4)).astype(np.float32) - 3
    exp = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                (1, 2, 2, 1), "SAME")
    np.testing.assert_array_equal(resnet._max_pool(torch.from_numpy(x)).numpy(),
                                  np.asarray(exp))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_matches_reference(train):
    jp, tp = _resnet_params()
    jcfg, cfg = _resnet_cfgs()
    x = _images(cfg.img_res)
    exp = jax.jit(lambda p, im: jresnet.forward(p, jcfg, im, train))(jp, x)
    _close(resnet.forward(tp, cfg, torch.from_numpy(x), train), exp)


@pytest.mark.parametrize("res", [64, 45], ids=["smoke", "odd"])
def test_resnet_stage_features_match_reference(res):
    jp, tp = _resnet_params()
    jcfg, cfg = _resnet_cfgs(img_res=res)
    x = _images(res, seed=res)
    exp = jax.jit(lambda p, im: jresnet.stage_features(p, jcfg, im))(jp, x)
    got = resnet.stage_features(tp, cfg, torch.from_numpy(x))
    assert len(got) == len(exp) == len(cfg.depths) + 1
    for g, e in zip(got, exp):
        _close(g, e)
    _close(resnet.forward(tp, cfg, torch.from_numpy(x)),
           jax.jit(lambda p, im: jresnet.forward(p, jcfg, im))(jp, x))


def test_resnet_bf16_runs_in_bf16():
    _, tp = _resnet_params()
    cfg = dataclasses.replace(resnet_152.SMOKE, dtype=torch.bfloat16)
    out = resnet.forward(tp, cfg, torch.from_numpy(_images(cfg.img_res)))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


# -------------------------------------------------------------------- Swin

SWIN_W12 = dict(img_res=96, patch=4, window=12, depths=(2, 2), dims=(32, 64),
                heads=(2, 4), n_classes=10)  # CONFIG_384's window, small


@functools.lru_cache(maxsize=None)
def _swin(kw=None):
    kw = dict(kw or ())
    jcfg = dataclasses.replace(jswin_b.SMOKE, **kw)
    cfg = dataclasses.replace(swin_b.SMOKE, **kw)
    return jcfg, cfg, *_draw(jswin.specs(jcfg))


def test_swin_specs_tree_matches_reference():
    for jcfg, cfg in ((jswin_b.CONFIG, swin_b.CONFIG), (jswin_b.CONFIG_384, swin_b.CONFIG_384)):
        jflat = {k: (s.shape, s.init) for k, s in jax_flatten(jswin.specs(jcfg)).items()}
        flat = {k: (s.shape, s.init) for k, s in param.flatten(swin.specs(cfg)).items()}
        assert flat == jflat


@pytest.mark.parametrize("ws,hw,shift", [(7, 14, 3), (7, 7, 3), (12, 24, 6), (12, 12, 6)])
def test_swin_tables_match_reference(ws, hw, shift):
    np.testing.assert_array_equal(swin._rel_pos_index(ws), jswin._rel_pos_index(ws))
    np.testing.assert_array_equal(swin._shift_mask(hw, hw, ws, shift),
                                  jswin._shift_mask(hw, hw, ws, shift))


@pytest.mark.parametrize("shift", [False, True], ids=["regular", "shifted"])
def test_swin_block_matches_reference(shift):
    jcfg, cfg, jp, tp = _swin()
    hw, heads = cfg.img_res // cfg.patch, cfg.heads[0]
    x = np.random.default_rng(4).standard_normal((2, hw, hw, cfg.dims[0])).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[0], jp["stage0"])["shift" if shift else "reg"]
    bp = param.tree_map(lambda a: a[0], tp["stage0"])["shift" if shift else "reg"]
    mask = jnp.asarray(jswin._shift_mask(hw, hw, cfg.window, cfg.window // 2)) if shift else None
    exp = jswin._block(jbp, jcfg, jnp.asarray(x), heads, shift, hw, mask)
    got = swin._block(bp, cfg, torch.from_numpy(x), heads, shift, hw)
    _close(got, exp)


@pytest.mark.parametrize("kw", [None, tuple(SWIN_W12.items())], ids=["smoke", "window12"])
def test_swin_forward_matches_reference(kw):
    jcfg, cfg, jp, tp = _swin(kw)
    x = _images(cfg.img_res)
    exp = jax.jit(lambda p, im: jswin.forward(p, jcfg, im))(jp, x)
    _close(swin.forward(tp, cfg, torch.from_numpy(x)), exp)


def test_swin_bf16_on_bf16_weights_matches_reference():
    """bf16 Swin on bf16 weights (the reference's scan refuses a bf16 Swin
    on f32 masters: its output projection promotes the carry to f32; the
    port casts ``wo`` as every projection, so it runs bf16 on either)."""
    jcfg, cfg, jp, tp = _swin()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp16 = param.tree_map(lambda a: a.to(torch.bfloat16), tp)
    x = _images(cfg.img_res)
    exp = jax.jit(lambda p, im: jswin.forward(p, jcfg, im))(jp16, x)
    got = swin.forward(tp16, cfg, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert swin.forward(tp, cfg, torch.from_numpy(x)).dtype == torch.bfloat16
    _close(got.float(), np.asarray(exp, np.float32), rel=BF16_REL)


# ---------------------------------------------------------------- registry

def _same_value(a, b, path):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            _same_value(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(b, torch.dtype):
        assert str(b) == f"torch.{np.dtype(a).name}", path
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def test_registry_lists_the_reference_archs():
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert len(configs.list_archs()) == 11
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_arch_equals_the_reference_field_by_field(name):
    _same_value(jconfigs.get_arch(name), configs.get_arch(name), name)


@pytest.mark.parametrize("name", jconfigs.list_archs())
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_for_shape_equals_the_reference(name, smoke):
    jarch, arch = jconfigs.get_arch(name), configs.get_arch(name)
    for jshape, shape in zip(jarch.shapes, arch.shapes):
        _same_value(jconfigs.config_for_shape(jarch, jshape, smoke),
                    configs.config_for_shape(arch, shape, smoke), f"{name}/{shape.name}")
    if arch.family == "swin" and not smoke:
        assert configs.config_for_shape(arch, arch.shape("cls_384")) is swin_b.CONFIG_384
