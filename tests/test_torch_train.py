"""The port's training path against the reference, on the CPU in f32.

Covers the synthetic data, the checkpointer (within the port and across the
packages), the loss and gradient of every family at its smoke config
against ``jax.value_and_grad`` of the reference's own loss functions (called
directly: the reference's ``build_bundle`` steps need a mesh, which raises
under JAX 0.9), microbatch accumulation against the reference's scan body,
``remat``, a 3-step trajectory against the reference's loop, the flops
functions and ``pick_accum`` for every architecture and shape, the flash
kernel's backward, and the CLI's train and ``--resume``.

Weights: drawn in numpy by the reference's init rules, every ``zeros`` leaf
drawn from N(0, 0.02^2) instead (adaLN-zero would gate the diffusion blocks
to the identity, and zero biases leave paths unexercised), fed to both
packages.

Tolerances, f32: the loss rel 1e-5; every gradient leaf max|diff| <= 1e-4 of
the largest |g| of any leaf, and <= 2e-4 of its own max|g| unless that is
below 1e-6 of the largest (the two packages sum in other orders; the
reference's jnp attention and the port's plain flash version differ in
rounding only). Measured: at most 5.1e-5 of a leaf's own max, but flux's
guidance embedding at 1.07e-4 (the f32 cos of ~3500 rad differs by a few
ulps between torch and XLA); the attention key biases' gradient is zero up
to rounding (softmax is invariant to a shift per row), <= 3.3e-8.
Diffusion losses are fed the reference's own ``jax.random`` draws. The
trajectory: losses rel 1e-5, params within 2e-4 of the leaf's max|p| plus
2 lr per step (where ``v`` is near 0 an Adam step is +-lr whatever the
grad's size, so an element whose grad is ~1e-7 of the leaf's can step the
other way).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.configs import get_arch as jget_arch, list_archs
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh
from repro.models import dit as jdit, flux as jflux, lm as jlm, resnet as jresnet
from repro.models import swin as jswin, vit as jvit
from repro.optim import adamw as jadamw
from repro.training import diffusion as jdiffusion

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps, train
from repro_torch.models import lm, param, resnet, swin, vit
from repro_torch.optim import adamw
from repro_torch.training import diffusion

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_OF_MAX = 1e-4       # of the largest |g| of any leaf
GRAD_OF_LEAF = 2e-4      # of the leaf's own max|g|
ROUNDING_ONLY = 1e-6     # a leaf below this share of the largest |g| is zero but for rounding
FAMILIES = ("vit-b16", "swin-b", "resnet-152", "starcoder2-3b", "granite-moe-3b-a800m",
            "dit-s2", "flux-dev")


def _draw(jspecs, seed: int = 0):
    """(reference tree, port tree) of the same numpy weights."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, spec in jax_flatten(jspecs).items():
        if spec.init == "ones":
            flat[k] = np.ones(spec.shape, np.float32)
        else:
            std = 0.02 if spec.init == "zeros" else param._std(spec)
            flat[k] = (std * rng.standard_normal(spec.shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, param.unflatten(flat)), param.from_jax_params(flat, "cpu")


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat_np(tree) -> dict:
    return {k: v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for k, v in param.flatten(tree).items()}


# ------------------------------------------------------------ the families' losses

def _case(name: str):
    """(reference loss(p, batch), port loss(p, batch), reference params, port
    params, host batch): the reference's and the port's loss functions of
    the family, as their train steps define them, on the smoke config."""
    jarch, arch = jget_arch(name), get_arch(name)
    jcfg, cfg = jarch.smoke_config, arch.smoke_config
    fam = arch.family
    specs_fn = {"vit": jvit.specs, "swin": jswin.specs, "resnet": jresnet.specs,
                "lm": jlm.specs, "dit": jdit.specs, "flux": jflux.specs}[fam]
    jp, tp = _draw(specs_fn(jcfg))
    data = pipeline.SyntheticData(pipeline.DataConfig())
    if fam in ("vit", "swin", "resnet"):
        hb = data.images(0, 2, cfg.img_res)
        hb["labels"] = hb["labels"] % cfg.n_classes
        jfwd = {"vit": lambda p, im: jvit.forward(p, jcfg, im),
                "swin": lambda p, im: jswin.forward(p, jcfg, im),
                "resnet": lambda p, im: jresnet.forward(p, jcfg, im, train=True)}[fam]
        tfwd = {"vit": lambda p, im: vit.forward(p, cfg, im),
                "swin": lambda p, im: swin.forward(p, cfg, im),
                "resnet": lambda p, im: resnet.forward(p, cfg, im, train=True)}[fam]

        def jloss(p, b):
            return jsteps._ce_loss(jfwd(p, b["images"]), b["labels"])

        def tloss(p, b):
            return steps._ce_loss(tfwd(p, b["images"]), b["labels"])
    elif fam == "lm":
        hb = data.tokens(0, 4, 64, cfg.vocab)

        def jloss(p, b):
            logits, aux = jlm.forward(p, jcfg, b["tokens"])
            return jlm.lm_loss(logits[:, :-1], b["tokens"][:, 1:]) + jcfg.aux_loss_coef * aux

        def tloss(p, b):
            logits, aux = lm.forward(p, cfg, b["tokens"])
            return lm.lm_loss(logits[:, :-1], b["tokens"][:, 1:]) + cfg.aux_loss_coef * aux
    elif fam == "dit":
        hb = data.latents(0, 2, cfg.latent_res, cfg.latent_channels)
        hb["labels"] = hb["labels"] % cfg.n_classes
        rng = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(rng)  # the reference's own draws, as dit_loss makes them
        t = jax.random.uniform(k1, (2,)) * 999.0
        eps = jax.random.normal(k2, hb["latents"].shape, jnp.float32)
        tt, teps = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))

        def jloss(p, b):
            return jdiffusion.dit_loss(p, jcfg, b["latents"], b["labels"], rng)

        def tloss(p, b):
            return diffusion.dit_loss_given(p, cfg, b["latents"], b["labels"], tt, teps)
    else:
        hb = data.flux_batch(0, 2, cfg.latent_res, cfg.txt_len, cfg.t5_dim, cfg.clip_dim,
                             cfg.latent_channels)
        rng = jax.random.PRNGKey(4)
        k1, k2 = jax.random.split(rng)
        t = jax.nn.sigmoid(jax.random.normal(k1, (2,)))
        noise = jax.random.normal(k2, hb["latents"].shape, jnp.float32)
        tt, tnoise = torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))

        def jloss(p, b):
            return jdiffusion.flux_loss(p, jcfg, b["latents"], b["txt"], b["vec"], rng)

        def tloss(p, b):
            return diffusion.flux_loss_given(p, cfg, b["latents"], b["txt"], b["vec"], tt,
                                             tnoise)
    return jloss, tloss, jp, tp, hb


def _check_grads(grads, jgrads) -> list[str]:
    """Asserts the tolerances above; returns the leaves with a gradient
    above rounding."""
    got, exp = _flat_np(grads), _flat_np(jgrads)
    assert got.keys() == exp.keys()
    top = max(float(np.abs(e).max()) for e in exp.values())
    real = []
    for k, e in exp.items():
        assert got[k].shape == e.shape, k
        err, own = float(np.abs(got[k] - e).max()), float(np.abs(e).max())
        assert err <= GRAD_OF_MAX * top, (k, err, top)
        if own >= ROUNDING_ONLY * top:
            assert err <= GRAD_OF_LEAF * own, (k, err, own)
            real.append(k)
    return real


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_leaf_match_reference(name):
    jloss, tloss, jp, tp, hb = _case(name)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    tl, tg = steps.value_and_grad(tloss, tp, _t(hb))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    real = _check_grads(tg, jg)
    flat = _flat_np(tg)
    # zero but for rounding: the key biases (a shift per softmax row) and the
    # BatchNorm statistics (train mode normalizes by the batch's own)
    assert all(k.endswith(("/bk", "/mean", "/var")) for k in set(flat) - set(real))
    for k in real:  # every leaf the loss reaches has a gradient in the port too
        assert float(np.abs(flat[k]).max()) > 0, k


def test_every_leaf_gets_a_gradient_through_the_flash_wrapper():
    """A ViT loss on the CPU reaches every param leaf through
    ``ops.flash_attention``, the wrapper the card runs (its autograd
    Function), not only through the plain version."""
    _, tloss, _, tp, hb = _case("vit-b16")
    calls = []
    fwd = flash_mod._FlashAttention.forward

    def counting(ctx, *args):
        calls.append(1)
        return fwd(ctx, *args)

    flash_mod._FlashAttention.forward = staticmethod(counting)
    try:
        _, grads = steps.value_and_grad(tloss, tp, _t(hb))
    finally:
        flash_mod._FlashAttention.forward = staticmethod(fwd)
    assert len(calls) == get_arch("vit-b16").smoke_config.n_layers
    for k, g in param.flatten(grads).items():
        assert float(g.abs().max()) > 0, k


# ------------------------------------------------------------------ flash backward

def _flash_inputs(b, h, sq, sk, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen) for s in (sq, sk, sk))
    bias = torch.log(torch.rand((b, sk), generator=gen) + 0.5)
    bias[:, -2:] = -torch.inf
    return q, k, v, bias, torch.randn((b, h, sq, d), generator=gen)


@pytest.mark.parametrize("kw", [{}, {"causal": True}, {"kv_len": [5, 0]}, {"bias": True},
                                {"bias": True, "causal": True, "kv_len": [9, 3]}],
                         ids=["plain", "causal", "kv_len", "bias", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_matches_autograd_of_the_plain_version(kw, dtype):
    """dq/dk/dv (and dbias) against autograd of ``ref.flash_attention_ref``
    in f32 on the same (rounded) inputs: f32 atol 1e-5 of max|g| (measured
    ~4e-7), bf16 1e-2 of max|g| (P, dS and the outputs rounded to bf16
    once, as the card's backward; measured 2.7e-3 to 3.5e-3). A member with
    kv_len 0 has every row fully masked: output and gradient 0."""
    q, k, v, bias, dout = _flash_inputs(2, 3, 7, 9, 16)
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32)
    if kw.get("bias"):
        kw["bias"] = bias.clone().requires_grad_()
    q, k, v = (t.to(dtype).requires_grad_() for t in (q, k, v))
    out = flash_mod.flash_attention(q, k, v, **kw)
    leaves = [q, k, v] + ([kw["bias"]] if "bias" in kw else [])
    got = torch.autograd.grad(out, leaves, dout.to(dtype))
    pf = [t.detach().float().requires_grad_() for t in leaves]
    kwf = dict(kw, **({"bias": pf[3]} if "bias" in kw else {}))
    exp = torch.autograd.grad(ref.flash_attention_ref(*pf[:3], **kwf), pf, dout.to(dtype).float())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, g, e in zip("qkvb", got, exp):
        assert g.dtype == (torch.float32 if name == "b" else dtype)
        torch.testing.assert_close(g.float(), e, rtol=0, atol=tol * float(e.abs().max()))
    if "kv_len" in kw and int(kw["kv_len"][-1]) == 0:
        assert float(out.detach()[1].abs().max()) == 0 and float(got[0][1].abs().max()) == 0


def test_flash_backward_skips_the_bias_gradient_unless_asked():
    q, k, v, bias, dout = _flash_inputs(1, 2, 5, 5, 16)
    q.requires_grad_()
    out = flash_mod.flash_attention(q, k, v, bias=bias)
    (dq,) = torch.autograd.grad(out, [q], dout)
    assert dq.shape == q.shape and not bias.requires_grad
    with torch.no_grad():  # no grad wanted: no autograd Function, the same output
        torch.testing.assert_close(flash_mod.flash_attention(q, k, v, bias=bias), out.detach())


def test_decode_attention_raises_under_grad():
    q = torch.randn(2, 4, 64, requires_grad=True)
    kv = torch.randn(2, 8, 2, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kv, kv, 8)
    with torch.no_grad():
        assert ops.decode_attention(q, kv, kv, 8).shape == (2, 4, 64)


# ---------------------------------------------------------------------------- data

@pytest.mark.parametrize("kind", ["images", "tokens", "latents", "flux_batch"])
def test_synthetic_data_bit_for_bit(kind):
    args = {"images": (3, 4, 16), "tokens": (3, 4, 32, 1000), "latents": (3, 2, 8),
            "flux_batch": (3, 2, 8, 5, 12, 7)}[kind]
    for seed in (0, 7):
        exp = getattr(jpipeline.SyntheticData(jpipeline.DataConfig(seed=seed)), kind)(*args)
        got = getattr(pipeline.SyntheticData(pipeline.DataConfig(seed=seed)), kind)(*args)
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            np.testing.assert_array_equal(got[k], exp[k])
    placed = pipeline.place(got, "cpu")
    assert all(placed[k].dtype == torch.from_numpy(got[k]).dtype for k in got)


# ---------------------------------------------------------------------- checkpoint

def _ttree(seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return ({"w": {"a": torch.randn((8, 16), generator=gen).to(dtype),
                   "b": torch.arange(10, dtype=torch.int32)}},
            {"m": {"w": {"a": torch.randn((8, 16), generator=gen)}},
             "step": torch.tensor(7, dtype=torch.int32)})


def _equal_trees(a, b):
    fa, fb = (param.flatten({"0": t[0], "1": t[1]}) for t in (a, b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_round_trip(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _ttree()
    ck.save(1, t, blocking=True)
    restored, step = ck.restore(t, device="cpu")
    assert step == 1 and isinstance(restored, tuple)
    _equal_trees(restored, t)
    meta = param.tree_map(lambda x: x.to("meta"), {"0": t[0], "1": t[1]})
    again, _ = ck.restore((meta["0"], meta["1"]), device="cpu")  # into abstract targets
    _equal_trees(again, t)


def test_checkpoint_async_save_and_keep(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _ttree(s))
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    _equal_trees(ck.restore(_ttree(), device="cpu")[0], _ttree(4))


def test_checkpoint_partial_ignored(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _ttree(), blocking=True)
    broken = tmp_path / "step_00000002"  # a torn write: no COMMIT
    broken.mkdir()
    (broken / "index.json").write_text("{}")
    assert ck.latest_step() == 1


def test_checkpoint_restore_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _ttree(), blocking=True)
    bad = _ttree()
    bad[0]["w"]["a"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad, device="cpu")
    extra = _ttree()
    extra[0]["w"]["c"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        ck.restore(extra, device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(_ttree(), device="cpu")


def test_checkpoint_crosses_packages_f32(tmp_path):
    """The reference writes, the port restores; the port writes, the
    reference restores: f32 and int32 leaves bit for bit, the same keys."""
    t = _ttree(3)
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), ({"w": t[0]["w"]}, t[1]))
    JCheckpointer(tmp_path / "ref").save(5, jt, blocking=True)
    got, step = Checkpointer(tmp_path / "ref").restore(t, device="cpu")
    assert step == 5
    _equal_trees(got, t)
    Checkpointer(tmp_path / "port").save(6, t, blocking=True)
    jgot, jstep = JCheckpointer(tmp_path / "port").restore(jt)
    assert jstep == 6
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    keys = json.loads((tmp_path / "port" / "step_00000006" / "index.json").read_text())["keys"]
    jkeys = json.loads((tmp_path / "ref" / "step_00000005" / "index.json").read_text())["keys"]
    assert keys == jkeys


def test_checkpoint_bf16_keeps_its_dtype(tmp_path):
    """bf16 round trip through the port: dtype and bits kept (stored as
    uint16, the index says bfloat16). The reference's own bf16 checkpoint
    comes back to it as void ``|V2`` (not copied); the port restores that
    file as bf16, bit for bit."""
    t = _ttree(5, torch.bfloat16)
    ck = Checkpointer(tmp_path / "port")
    ck.save(1, t, blocking=True)
    got, _ = ck.restore(t, device="cpu")
    assert got[0]["w"]["a"].dtype == torch.bfloat16
    _equal_trees(got, t)
    index = json.loads((tmp_path / "port" / "step_00000001" / "index.json").read_text())
    assert index["keys"]["0/w/a"]["dtype"] == "bfloat16"

    jt = ({"w": {"a": jnp.asarray(t[0]["w"]["a"].float().numpy()).astype(jnp.bfloat16),
                 "b": jnp.asarray(t[0]["w"]["b"].numpy())}},
          jax.tree.map(lambda x: jnp.asarray(x.numpy()), t[1]))
    JCheckpointer(tmp_path / "ref").save(2, jt, blocking=True)
    jgot, _ = JCheckpointer(tmp_path / "ref").restore(jt)
    assert jgot[0]["w"]["a"].dtype.kind == "V"  # the reference's fault: void, not bfloat16
    with pytest.raises(TypeError):
        jnp.asarray(jgot[0]["w"]["a"])
    got, _ = Checkpointer(tmp_path / "ref").restore(t, device="cpu")
    _equal_trees(got, t)


def test_checkpoint_bf16_port_to_reference_is_f32_only(tmp_path):
    """A bf16 checkpoint of the port does not restore as bf16 in the
    reference: its restore ignores ``index.json`` and returns the stored
    ``uint16`` bits as integers. Only f32 (and integer) trees cross from
    the port to the reference."""
    t = _ttree(6, torch.bfloat16)
    Checkpointer(tmp_path).save(1, t, blocking=True)
    jt = ({"w": {"a": jnp.zeros((8, 16), jnp.bfloat16), "b": jnp.zeros(10, jnp.int32)}},
          {"m": {"w": {"a": jnp.zeros((8, 16))}}, "step": jnp.zeros((), jnp.int32)})
    jgot, _ = JCheckpointer(tmp_path).restore(jt)
    bits = jgot[0]["w"]["a"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, t[0]["w"]["a"].view(torch.int16).numpy().view(np.uint16))


# -------------------------------------------------------------- accumulation, remat

def _vit_step_case(batch: int):
    _, tloss, jp, tp, _ = _case("vit-b16")
    cfg = get_arch("vit-b16").smoke_config
    jcfg = jget_arch("vit-b16").smoke_config
    hb = pipeline.SyntheticData().images(0, batch, cfg.img_res)
    hb["labels"] = hb["labels"] % cfg.n_classes

    def jloss(p, b, step):
        return jsteps._ce_loss(jvit.forward(p, jcfg, b["images"]), b["labels"])

    def loss_fn(p, b, step):
        return tloss(p, b)
    return jloss, loss_fn, jp, tp, hb


def test_accumulation_matches_the_reference_scan_body():
    """accum=2 over a batch of 4: the reference's ``_train_wrap`` (its
    ``lax.scan`` over microbatches, no rules) against the port's loop, from
    the same params; grads are compared through the updated params and the
    optimizer state."""
    jloss, loss_fn, jp, tp, hb = _vit_step_case(4)
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    jstep = jax.jit(jsteps._train_wrap(jloss, jadamw.AdamWConfig(**vars(ocfg)), None, 2))
    jp2, jopt, jm = jstep(jp, jadamw.init_state(jp), {k: jnp.asarray(v) for k, v in hb.items()})
    step = steps._train_wrap(loss_fn, ocfg, 2)
    tp2, topt, tm = step(tp, adamw.init_state(tp), _t(hb))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    # m after one step is (1 - b1) * clip * grad: the accumulated grads themselves
    _check_grads(topt["m"], jopt["m"])
    one = steps._train_wrap(loss_fn, ocfg, 1)(_case("vit-b16")[3], adamw.init_state(tp), _t(hb))
    assert abs(float(one[2]["loss"]) - float(tm["loss"])) < 1e-5  # same mean either way


@pytest.mark.parametrize("name", ["vit-b16", "starcoder2-3b", "dit-s2", "flux-dev"])
def test_remat_gives_identical_loss_and_gradients(name):
    """``cfg.remat`` recomputes each block in the backward: the same loss and
    gradients, bit for bit on the CPU."""
    _, _, _, tp, hb = _case(name)
    arch = get_arch(name)
    orig = arch.smoke_config
    outs = []
    for remat in (False, True):  # the arch spec is frozen: swap its smoke config
        object.__setattr__(arch, "smoke_config", dataclasses.replace(orig, remat=remat))
        try:
            tloss = _case(name)[1]
            outs.append(steps.value_and_grad(tloss, tp, _t(hb)))
        finally:
            object.__setattr__(arch, "smoke_config", orig)
    (l0, g0), (l1, g1) = outs
    assert float(l0) == float(l1)
    for k, a in param.flatten(g0).items():
        assert torch.equal(a, param.flatten(g1)[k]), k


def test_remat_recomputes_the_attention_forward():
    """Under remat each block's flash forward runs twice per step (forward
    and recompute): what the card's launch count shows."""
    _, _, _, tp, hb = _case("vit-b16")
    cfg = dataclasses.replace(get_arch("vit-b16").smoke_config, remat=True)
    calls = []
    fwd = flash_mod._forward

    def counting(*args):
        calls.append(1)
        return fwd(*args)

    flash_mod._forward = counting
    try:
        steps.value_and_grad(lambda p, b: steps._ce_loss(vit.forward(p, cfg, b["images"]),
                                                         b["labels"]), tp, _t(hb))
    finally:
        flash_mod._forward = fwd
    assert len(calls) == 2 * cfg.n_layers


def test_remat_recompute_keeps_plain_versions_on_another_thread():
    """On the card autograd runs the backward, and so the recompute, on its
    own thread, which starts with default context variables. A forward under
    ``ops.plain_versions()`` must recompute on the plain versions too (else
    the recompute saves other tensors and checkpoint raises), and give the
    gradients of the same-thread backward."""
    import threading

    _, _, _, tp, hb = _case("vit-b16")
    cfg = dataclasses.replace(get_arch("vit-b16").smoke_config, remat=True)
    live = [t.detach().requires_grad_() for t in param.flatten(tp).values()]
    tree = param.unflatten(dict(zip(param.flatten(tp), live)))

    def loss():
        return steps._ce_loss(vit.forward(tree, cfg, _t(hb)["images"]), _t(hb)["labels"])

    with ops.plain_versions():
        same_thread = torch.autograd.grad(loss(), live)
        out = loss()
    result = {}

    def backward():
        try:
            result["grads"] = torch.autograd.grad(out, live)
        except Exception as e:  # reported below, on the test's thread
            result["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and "error" not in result, result.get("error")
    for a, b in zip(result["grads"], same_thread):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ trajectory, CLI

def test_three_step_trajectory_matches_the_reference_loop():
    """Three train steps of the port's bundle on the port's data against the
    reference's ``_train_wrap`` on the reference's data, from the same
    params."""
    jloss, _, jp, tp, _ = _vit_step_case(2)
    jarch, arch = jget_arch("vit-b16"), get_arch("vit-b16")
    bundle = steps.build_bundle("vit-b16", "cls_224", None, smoke=True)
    _, aopt, abatch = bundle.abstract_inputs
    ocfg = jadamw.AdamWConfig()
    jstep = jax.jit(jsteps._train_wrap(jloss, ocfg, None, 1))
    jopt, topt = jadamw.init_state(jp), adamw.init_state(tp)
    jdata, tdata = jpipeline.SyntheticData(), pipeline.SyntheticData()
    jab = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32) for k, v in abatch.items()}
    for s in range(3):
        jb = jtrain.host_batch(jarch, jarch.smoke_config, jdata, s, jab)
        tb = train.host_batch(arch, arch.smoke_config, tdata, s, abatch)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in jb.items()})
        tp, topt, tm = bundle.step_fn(tp, topt, pipeline.place(tb, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    lr_sum = sum(float(adamw.lr_at(adamw.AdamWConfig(), s + 1)) for s in range(3))
    exp = _flat_np(jp)
    for k, a in _flat_np(tp).items():
        np.testing.assert_allclose(a, exp[k], rtol=0,
                                   atol=2e-4 * np.abs(exp[k]).max() + 2 * lr_sum, err_msg=k)
    assert int(topt["step"]) == int(jopt["step"]) == 3


def test_flops_and_accum_equal_the_reference_for_every_arch_and_shape():
    mesh = make_host_mesh()
    n = 0
    for name in list_archs():
        for s in jget_arch(name).shapes:
            try:
                jb = jsteps.build_bundle(name, s.name, mesh)
            except jsteps.SkipShape:
                with pytest.raises(steps.SkipShape):
                    steps.build_bundle(name, s.name, None)
                continue
            b = steps.build_bundle(name, s.name, None)
            assert b.model_flops == jb.model_flops, (name, s.name)
            if s.kind == "train":
                assert b.accum == jb.hlo_scale and b.notes == jb.notes, (name, s.name)
            n += 1
    assert n == 38  # 11 archs' shapes, less the 4 LMs' skipped long_500k


def test_param_count_and_bytes_equal_the_reference():
    from repro.models import param as jparam

    for name in list_archs():
        jarch, arch = jget_arch(name), get_arch(name)
        for jcfg, cfg in ((jarch.config, arch.config), (jarch.smoke_config, arch.smoke_config)):
            jspecs = steps._specs_for(arch.family, cfg)
            rspecs = jsteps._specs_for(jarch.family, jcfg)
            assert param.param_count(jspecs) == jparam.param_count(rspecs), name
            assert param.param_bytes(jspecs) == jparam.param_bytes(rspecs), name
            assert param.param_bytes(jspecs, torch.bfloat16) == jparam.param_bytes(
                rspecs, jnp.bfloat16), name


def test_pick_accum_equals_the_reference():
    for gb in (1, 4, 32, 64, 256):
        for act in (1e3, 1e6, 2.4e6, 5e7):
            for dp in (1, 2, 8):
                assert steps.pick_accum(gb, act, dp) == jsteps.pick_accum(gb, act, dp)


def _tree_specs(tree):
    """A shardings tree as {path: spec tuple} (the reference's
    NamedSharding by its PartitionSpec)."""
    flat = jax_flatten(tree) if isinstance(tree, dict) else {"": tree}
    return {k: tuple(getattr(v, "spec", v)) for k, v in flat.items()}


@pytest.mark.parametrize("mesh", [(1, 1), (2, 4), (16, 16)], ids=["1x1", "2x4", "16x16"])
def test_train_bundles_shard_by_the_train_profile(mesh):
    """Every train bundle on a mesh (given as its shape) against the
    reference's on an AbstractMesh of that shape: the train profile's
    (params, opt, batch) in_shardings and (params, opt, metrics)
    out_shardings spec for spec, and the accumulation ``pick_accum`` chooses
    from the mesh's data-parallel extent."""
    amesh = jax.sharding.AbstractMesh(mesh, ("data", "model"))
    shape = {"data": mesh[0], "model": mesh[1]}
    for name in list_archs():
        for sh in get_arch(name).shapes:
            if sh.kind != "train" or sh.skip_reason:
                continue
            jb = jsteps.build_bundle(name, sh.name, amesh)
            b = steps.build_bundle(name, sh.name, shape)
            assert b.rules.mapping == jsteps.rules_lib.PROFILES[get_arch(name).train_profile]
            for got, exp in zip(b.in_shardings + b.out_shardings,
                                jb.in_shardings + jb.out_shardings):
                assert _tree_specs(got) == _tree_specs(exp), (name, sh.name, mesh)
            assert (b.notes, b.accum, b.model_flops) == (jb.notes, jb.hlo_scale,
                                                         jb.model_flops), (name, sh.name)


def test_serving_bundles_run_the_ported_paths():
    """The serving bundles are thin wrappers: a smoke forward, prefill,
    decode step and sampler each run on the CPU at the abstract shapes."""
    gen = torch.Generator().manual_seed(0)
    for name, shape in (("vit-b16", "serve_b1"), ("starcoder2-3b", "prefill_32k"),
                        ("starcoder2-3b", "decode_32k"), ("dit-s2", "gen_fast"),
                        ("flux-dev", "gen_fast")):
        b = steps.build_bundle(name, shape, None, smoke=True)
        arch = get_arch(name)
        params = param.init_params(steps._specs_for(arch.family, arch.smoke_config), gen, "cpu")
        args = []
        for a in b.abstract_inputs[1:]:
            if isinstance(a, dict):
                a = {k: (torch.zeros(v.shape, dtype=v.dtype) if isinstance(v, torch.Tensor)
                         else v) for k, v in a.items()}
            args.append(a)
        out = b.step_fn(params, *args)
        first = out[0] if isinstance(out, tuple) else out
        assert torch.isfinite(first.float()).all(), (name, shape)


def test_cli_train_and_resume_continue_the_uninterrupted_run(tmp_path, capsys):
    """Two steps, a checkpoint, ``--resume`` for two more: the same params,
    bit for bit, as four steps without a stop (the stream is stateless in
    the step index and the checkpoint holds the whole state)."""
    common = ["--arch", "vit-b16", "--device", "cpu", "--log-every", "1"]
    full = train.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    first = train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                                 "--ckpt-every", "1"])
    assert Checkpointer(tmp_path / "b").all_steps() == [1, 2]
    second = train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                                  "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "[train] step     3 loss" in out
    assert "images/s" in out and "TFLOP/s" in out
    assert second.start_step == 2 and len(second.losses) == 2
    assert first.losses + second.losses == full.losses
    for k, a in param.flatten(full.params).items():
        assert torch.equal(a, param.flatten(second.params)[k]), k
    assert int(second.opt["step"]) == 4


def test_cli_refuses_a_serving_shape():
    with pytest.raises(ValueError, match="not train"):
        train.main(["--arch", "vit-b16", "--shape", "serve_b1", "--device", "cpu"])
