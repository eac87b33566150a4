"""The port's diffusion generation path (DiT, flux, their samplers) against
the reference, on the CPU in f32.

Weights: drawn in numpy by the reference's init rules, with every
``init="zeros"`` leaf drawn from N(0, 0.02^2) instead, fed to both packages
through ``from_jax_params``. adaLN-zero initialises the modulations and the
final projections to zero, which gates every block to the identity and
makes the output exactly 0: parity on such weights would hold whatever the
attention or the merge computed.

Tolerances: DiT ``forward``/``forward_janus`` and flux ``forward`` atol 1e-5
(measured: 1.8e-7, 1.5e-7, 3.0e-7 at outputs of magnitude 0.5-0.6), with
identical merge indices at every merge layer; ``timestep_embedding`` atol
5e-5 (measured 2.8e-5: torch's and XLA's f32 ``cos`` of arguments up to
999 rad differ by a few ulps); the time grid bit for bit; the DDIM sampler
relative to ``max|x|``: 1.5e-4 (measured 7.6e-5; its first step divides by
``a0 = cos(0.5 pi 0.999) = 1.6e-3``, so an ulp of ``a0``'s argument is
7.5e-5 of the result, and the reference's own scanned and eager samplers
differ by 1.5e-4 in ``a0``); flux's Euler sampler atol 1e-5 (measured
4.8e-7 at magnitude 3.8).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.configs import dit_s2 as jdit_s2
from repro.configs import flux_dev as jflux_dev
from repro.core import tome as jtome
from repro.models import dit as jdit
from repro.models import flux as jflux
from repro.models import layers as JL
from repro.training import diffusion as jdiffusion

from repro_torch.configs import dit_s2, flux_dev
from repro_torch.core import tome
from repro_torch.models import dit, flux, param
from repro_torch.models import layers as L
from repro_torch.training import diffusion

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

ATOL = 1e-5
TEMB_ATOL = 5e-5
SAMPLER_REL = 1.5e-4
SCHEDULE = (5, 3)  # SMOKE DiT: 16 tokens -> 11 -> 8


def _draw(jspecs, seed: int = 0):
    """(reference tree, port tree) of the same numpy weights: the
    reference's init rules, every zeros-initialised leaf redrawn from
    N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, spec in jax_flatten(jspecs).items():
        if spec.init == "ones":
            flat[k] = np.ones(spec.shape, np.float32)
        else:
            std = 0.02 if spec.init == "zeros" else param._std(spec)
            flat[k] = (std * rng.standard_normal(spec.shape)).astype(np.float32)
    return param.unflatten(flat), param.from_jax_params(flat, "cpu")


@functools.lru_cache(maxsize=None)
def _dit_params():
    return _draw(jdit.specs(jdit_s2.SMOKE))


@functools.lru_cache(maxsize=None)
def _flux_params():
    return _draw(jflux.specs(jflux_dev.SMOKE))


def _dit_inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((3, cfg.latent_res, cfg.latent_res, cfg.latent_channels))
    t = np.array([0.0, 500.3, 999.0], np.float32)
    y = np.array([1, 5, cfg.n_classes], np.int32)  # n_classes: the null class
    return lat.astype(np.float32), t, y


def _flux_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, cfg.latent_res, cfg.latent_res, cfg.latent_channels))
    txt = rng.standard_normal((2, cfg.txt_len, cfg.t5_dim))
    vec = rng.standard_normal((2, cfg.clip_dim))
    t = np.array([0.3, 1.0], np.float32)
    guidance = np.array([3.5, 1.0], np.float32)
    return tuple(a.astype(np.float32) for a in (lat, txt, vec, t, guidance))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# ------------------------------------------------------------------- layers

def test_layernorm_noparam_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    exp = np.asarray(JL.layernorm_noparam(jnp.asarray(x)))
    np.testing.assert_allclose(L.layernorm_noparam(torch.from_numpy(x)).numpy(), exp,
                               atol=1e-6, rtol=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert L.layernorm_noparam(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("dim", [256, 64])
def test_timestep_embedding_matches_reference(dim):
    t = np.array([0.0, 1.5, 42.0, 500.3, 979.02, 999.0], np.float32)
    exp = np.asarray(jax.jit(lambda v: JL.timestep_embedding(v, dim))(jnp.asarray(t)))
    got = L.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (6, dim)
    np.testing.assert_allclose(got.numpy(), exp, atol=TEMB_ATOL, rtol=0)


# ---------------------------------------------------------------------- DiT

def test_dit_specs_tree_matches_reference():
    jflat = {k: (s.shape, s.init) for k, s in jax_flatten(jdit.specs(jdit_s2.CONFIG)).items()}
    flat = {k: (s.shape, s.init) for k, s in param.flatten(dit.specs(dit_s2.CONFIG)).items()}
    assert flat == jflat


def test_patchify_round_trip_matches_reference():
    cfg = dit_s2.SMOKE
    lat, _, _ = _dit_inputs(cfg)
    exp = np.asarray(jdit.patchify(jdit_s2.SMOKE, jnp.asarray(lat)))
    got = dit.patchify(cfg, torch.from_numpy(lat))
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(dit.unpatchify(cfg, got).numpy(), lat)


def test_adaln_zero_init_gates_the_output_to_zero():
    """Why the tests redraw the zero leaves: at init the model outputs 0."""
    cfg = dit_s2.SMOKE
    tp = param.init_params(dit.specs(cfg), torch.Generator().manual_seed(0), "cpu")
    out = dit.forward(tp, cfg, *_t(*_dit_inputs(cfg)))
    assert float(out.abs().max()) == 0.0


def test_dit_forward_matches_reference():
    jp, tp = _dit_params()
    inputs = _dit_inputs(dit_s2.SMOKE)
    exp = np.asarray(jax.jit(lambda p, *a: jdit.forward(p, jdit_s2.SMOKE, *a))(jp, *inputs))
    got = dit.forward(tp, dit_s2.SMOKE, *_t(*inputs))
    assert got.shape == exp.shape and np.abs(exp).max() > 0.1
    np.testing.assert_allclose(got.numpy(), exp, atol=ATOL, rtol=0)


def _recorded(module, fn, jit=False):
    """Run ``fn()`` with ``module.bipartite_soft_matching`` recording each
    merge layer's (src, unm, dst) indices; returns them as numpy beside the
    output. ``jit``: trace ``fn`` under ``jax.jit``, the indices leaving as
    outputs of the traced function."""
    matching = module.bipartite_soft_matching
    record = []

    def recording(*args, **kw):
        idx = matching(*args, **kw)
        record.append(tuple(idx))
        return idx

    def run():
        record.clear()
        return fn(), list(record)

    module.bipartite_soft_matching = recording
    try:
        out, idx = jax.jit(run)() if jit else run()
    finally:
        module.bipartite_soft_matching = matching
    return np.asarray(out), [tuple(np.asarray(a) for a in layer) for layer in idx]


def test_dit_forward_janus_matches_reference_with_identical_merges():
    jp, tp = _dit_params()
    inputs = _dit_inputs(dit_s2.SMOKE)
    exp, jrec = _recorded(jtome, lambda: jdit.forward_janus(
        jp, jdit_s2.SMOKE, *(jnp.asarray(a) for a in inputs), SCHEDULE), jit=True)
    got, rec = _recorded(tome, lambda: dit.forward_janus(
        tp, dit_s2.SMOKE, *_t(*inputs), SCHEDULE))
    assert len(rec) == len(jrec) == 2
    for layer, (mine, ref) in enumerate(zip(rec, jrec)):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"merge layer {layer}")
    assert got.shape == exp.shape == inputs[0].shape
    np.testing.assert_allclose(got, exp, atol=ATOL, rtol=0)
    dense = dit.forward(tp, dit_s2.SMOKE, *_t(*inputs)).numpy()
    assert np.abs(got - dense).max() > 1e-3  # the merges changed the output


@pytest.mark.parametrize("n_before,r", [(16, 5), (11, 3), (64, 20), (9, 4)])
def test_unmerge_map_matches_reference(n_before, r):
    rng = np.random.default_rng(n_before)
    metric = rng.standard_normal((3, n_before, 8)).astype(np.float32)
    jidx = jtome.bipartite_soft_matching(jnp.asarray(metric), r, protect_first=False)
    idx = tome.bipartite_soft_matching(torch.from_numpy(metric), r, protect_first=False)
    exp = np.asarray(jdit._unmerge_map(n_before, jidx))
    got = dit._unmerge_map(n_before, idx)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), exp)
    # every position lands inside the merged sequence
    assert got.min() >= 0 and got.max() < n_before - r


# ------------------------------------------------------------------ samplers

@pytest.mark.parametrize("start,stop,steps", [(999.0, 0.0, 50), (1.0, 0.0, 50),
                                              (999.0, 0.0, 2), (1.0, 0.0, 4)])
def test_time_grid_equals_jnp_linspace_bit_for_bit(start, stop, steps):
    exp = np.asarray(jnp.linspace(start, stop, steps + 1))
    got = diffusion.time_grid(start, stop, steps, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("schedule", [None, SCHEDULE], ids=["dense", "janus"])
def test_dit_sample_from_the_reference_noise(schedule):
    jp, tp = _dit_params()
    cfg, jcfg = dit_s2.SMOKE, jdit_s2.SMOKE
    y = np.array([0, 3, cfg.n_classes], np.int32)
    key = jax.random.key(7)
    steps = 4
    exp = np.asarray(jax.jit(lambda p, k, yy: jdiffusion.dit_sample(
        p, jcfg, k, yy, steps, schedule))(jp, key, y))
    x0 = np.asarray(jax.random.normal(key, exp.shape, jnp.float32))  # the reference's draw
    got = diffusion.dit_denoise(tp, cfg, *_t(x0, y), steps, schedule).numpy()
    scale = np.abs(exp).max()
    assert got.shape == exp.shape and np.isfinite(got).all()
    assert np.abs(got - exp).max() <= SAMPLER_REL * scale


def test_dit_sample_draws_on_the_generator():
    _, tp = _dit_params()
    cfg = dit_s2.SMOKE
    y = torch.tensor([1, 2])
    a = diffusion.dit_sample(tp, cfg, torch.Generator().manual_seed(3), y, 2, device="cpu")
    b = diffusion.dit_sample(tp, cfg, torch.Generator().manual_seed(3), y, 2, device="cpu")
    x0 = diffusion.initial_latents(cfg, 2, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a, b)
    assert torch.equal(a, diffusion.dit_denoise(tp, cfg, x0, y, 2))


# ---------------------------------------------------------------------- flux

def test_flux_specs_tree_matches_reference():
    jflat = {k: (s.shape, s.init)
             for k, s in jax_flatten(jflux.specs(jflux_dev.CONFIG)).items()}
    flat = {k: (s.shape, s.init) for k, s in param.flatten(flux.specs(flux_dev.CONFIG)).items()}
    assert flat == jflat
    n = sum(int(np.prod(s[0])) for s in flat.values())
    assert n == 11_901_414_464  # 23.80 GB in bf16


def test_flux_forward_matches_reference():
    jp, tp = _flux_params()
    inputs = _flux_inputs(flux_dev.SMOKE)
    exp = np.asarray(jax.jit(lambda p, *a: jflux.forward(p, jflux_dev.SMOKE, *a))(jp, *inputs))
    got = flux.forward(tp, flux_dev.SMOKE, *_t(*inputs))
    assert got.shape == exp.shape and np.abs(exp).max() > 0.1
    np.testing.assert_allclose(got.numpy(), exp, atol=ATOL, rtol=0)


def test_flux_sample_from_the_reference_noise():
    jp, tp = _flux_params()
    cfg, jcfg = flux_dev.SMOKE, jflux_dev.SMOKE
    lat, txt, vec, _, _ = _flux_inputs(cfg)
    key = jax.random.key(11)
    exp = np.asarray(jax.jit(lambda p, k, a, b: jdiffusion.flux_sample(
        p, jcfg, k, a, b, 3))(jp, key, txt, vec))
    x0 = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    got = diffusion.flux_denoise(tp, cfg, *_t(x0, txt, vec), 3).numpy()
    assert np.isfinite(got).all() and np.abs(got - x0).max() > 0.1
    np.testing.assert_allclose(got, exp, atol=ATOL, rtol=0)


def test_flux_rope_2d_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 9, (2, 6, 2)).astype(np.int32)
    exp = np.asarray(jflux._rope_2d(jnp.asarray(x), jnp.asarray(pos)))
    got = flux._rope_2d(*_t(x, pos))
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-6, rtol=0)
