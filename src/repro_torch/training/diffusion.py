"""Diffusion training losses and samplers, PyTorch port of
``repro.training.diffusion``: DiT's noise-prediction loss and DDIM-style
sampler (with Janus ToMe inside every denoise forward when a merge schedule
is given), flux's rectified-flow loss and Euler sampler.

Each loss is two steps too: draw (t, noise) from a ``torch.Generator``,
then ``dit_loss_given`` / ``flux_loss_given`` from any given draws, so that
a test can feed the reference's own ``jax.random`` draws (the port cannot
reproduce those bits and does not try).

Each sampler is two steps: draw the initial latents from a
``torch.Generator`` (``initial_latents``), then run the loop
(``dit_denoise``, ``flux_denoise``) from any given latents, so that a test
can feed the reference's own initial noise into the same loop.

Numerics kept from the reference:
- ``time_grid`` equals ``jnp.linspace(start, stop, steps + 1)`` bit for bit
  in f32 (XLA turns its division by ``steps`` into a product with the f32
  reciprocal; ``torch.linspace`` differs from it by up to 6.1e-5 at 51
  points).
- The step's coefficients are f32 0-d tensors, and JAX promotes a bf16
  array times an f32 0-d array to f32, so each update is computed in f32
  and cast back to the latents' dtype once (torch would keep bf16).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.models import dit as dit_lib
from repro_torch.models import flux as flux_lib
from repro_torch.runtime.device import resolve_device


def time_grid(start: float, stop: float, steps: int, device=None) -> torch.Tensor:
    """``steps + 1`` f32 points from ``start`` to ``stop``, equal to
    ``jnp.linspace(start, stop, steps + 1)`` bit for bit."""
    f32 = np.float32
    frac = np.arange(steps, dtype=f32) * (f32(1) / f32(steps))
    grid = f32(start) * (f32(1) - frac) + f32(stop) * frac
    grid = np.append(grid, f32(stop)).astype(f32)
    return torch.from_numpy(grid).to(resolve_device(device))


def initial_latents(cfg, batch: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard normal latents [batch, latent_res, latent_res, C] in
    ``cfg.dtype``, drawn on ``device`` (``cuda`` unless told ``cpu``) from
    ``generator`` (which must live there)."""
    device = resolve_device(device)
    shape = (batch, cfg.latent_res, cfg.latent_res, cfg.latent_channels)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).to(cfg.dtype)


def dit_loss_given(params: dict, cfg: dit_lib.DiTConfig, latents: torch.Tensor,
                   y: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The eps-prediction loss at timesteps ``t`` [B] (f32, in [0, 999]) and
    noise ``eps`` (latents' shape): mean squared error, f32 0-d."""
    a = torch.cos(0.5 * math.pi * t / 1000.0)[:, None, None, None]
    s = torch.sin(0.5 * math.pi * t / 1000.0)[:, None, None, None]
    x_t = a * latents + s * eps
    pred = dit_lib.forward(params, cfg, x_t, t, y)
    return torch.mean(torch.square(pred.float() - eps.float()))


def dit_loss(params: dict, cfg: dit_lib.DiTConfig, latents: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
    """``dit_loss_given`` at t ~ U[0, 999) and eps ~ N(0, 1) in the
    latents' dtype, drawn from ``generator`` (on the latents' device)."""
    b = latents.shape[0]
    t = torch.rand((b,), generator=generator, dtype=torch.float32, device=latents.device) * 999.0
    eps = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                      device=latents.device).to(latents.dtype)
    return dit_loss_given(params, cfg, latents, y, t, eps)


def dit_denoise(params: dict, cfg: dit_lib.DiTConfig, x: torch.Tensor, y: torch.Tensor,
                steps: int, schedule: Sequence[int] | None = None) -> torch.Tensor:
    """``steps`` deterministic DDIM updates of latents ``x`` from t = 999 to
    0 (cosine signal/noise mix); ``schedule`` runs Janus ToMe
    (``dit.forward_janus``) inside every denoise forward."""
    b = y.shape[0]
    ts = time_grid(999.0, 0.0, steps, x.device)
    for i in range(steps):
        t0, t1 = ts[i], ts[i + 1]
        tv = t0.expand(b)
        if schedule is not None:
            eps = dit_lib.forward_janus(params, cfg, x, tv, y, schedule)
        else:
            eps = dit_lib.forward(params, cfg, x, tv, y)
        a0 = torch.cos(0.5 * math.pi * t0 / 1000.0)
        s0 = torch.sin(0.5 * math.pi * t0 / 1000.0)
        a1 = torch.cos(0.5 * math.pi * t1 / 1000.0)
        s1 = torch.sin(0.5 * math.pi * t1 / 1000.0)
        x0 = (x.float() - s0 * eps.float()) / torch.clamp_min(a0, 1e-4)
        x = (a1 * x0 + s1 * eps.float()).to(x.dtype)
    return x


def dit_sample(params: dict, cfg: dit_lib.DiTConfig, generator: torch.Generator,
               y: torch.Tensor, steps: int, schedule: Sequence[int] | None = None,
               device=None) -> torch.Tensor:
    """DDIM sampling of ``y.shape[0]`` latents for class ids ``y`` from
    noise drawn with ``generator``; ``schedule`` enables Janus ToMe.
    Runs on ``cuda`` unless the caller passes ``device="cpu"``."""
    x = initial_latents(cfg, y.shape[0], generator, device)
    return dit_denoise(params, cfg, x, y, steps, schedule)


def flux_loss_given(params: dict, cfg: flux_lib.FluxConfig, latents: torch.Tensor,
                    txt: torch.Tensor, vec: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """The rectified-flow loss at times ``t`` [B] (f32, in (0, 1)) and
    ``noise`` (latents' shape): the velocity's mean squared error against
    ``noise - latents``, at guidance 3.5, f32 0-d."""
    b = latents.shape[0]
    tb = t[:, None, None, None].to(latents.dtype)
    x_t = (1 - tb) * latents + tb * noise
    target = noise - latents
    guidance = torch.full((b,), 3.5, dtype=torch.float32, device=latents.device)
    v = flux_lib.forward(params, cfg, x_t, txt, vec, t, guidance)
    return torch.mean(torch.square(v.float() - target.float()))


def flux_loss(params: dict, cfg: flux_lib.FluxConfig, latents: torch.Tensor,
              txt: torch.Tensor, vec: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """``flux_loss_given`` at logit-normal t = sigmoid(N(0, 1)) (the BFL
    recipe) and noise ~ N(0, 1) in the latents' dtype, drawn from
    ``generator`` (on the latents' device)."""
    b = latents.shape[0]
    t = torch.sigmoid(torch.randn((b,), generator=generator, dtype=torch.float32,
                                  device=latents.device))
    noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                        device=latents.device).to(latents.dtype)
    return flux_loss_given(params, cfg, latents, txt, vec, t, noise)


def flux_denoise(params: dict, cfg: flux_lib.FluxConfig, x: torch.Tensor, txt: torch.Tensor,
                 vec: torch.Tensor, steps: int, guidance_scale: float = 3.5) -> torch.Tensor:
    """``steps`` Euler steps of the rectified flow from t = 1 to 0, starting
    at latents ``x``."""
    b = txt.shape[0]
    ts = time_grid(1.0, 0.0, steps, x.device)
    guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=x.device)
    for i in range(steps):
        t0, t1 = ts[i], ts[i + 1]
        v = flux_lib.forward(params, cfg, x, txt, vec, t0.expand(b), guidance)
        x = (x.float() + (t1 - t0) * v.float()).to(x.dtype)
    return x


def flux_sample(params: dict, cfg: flux_lib.FluxConfig, generator: torch.Generator,
                txt: torch.Tensor, vec: torch.Tensor, steps: int,
                guidance_scale: float = 3.5, device=None) -> torch.Tensor:
    """Euler rectified-flow sampling from noise drawn with ``generator``,
    conditioned on text embeddings ``txt`` [B, txt_len, t5_dim] and the
    pooled vector ``vec`` [B, clip_dim]. Runs on ``cuda`` unless the caller
    passes ``device="cpu"``."""
    x = initial_latents(cfg, txt.shape[0], generator, device)
    return flux_denoise(params, cfg, x, txt, vec, steps, guidance_scale)
