"""Flux-dev style MMDiT rectified-flow backbone, PyTorch port of
``repro.models.flux`` (BFL tech report; unverified).

19 double-stream blocks (separate img/txt streams, joint attention) then 38
single-stream blocks (one fused stream), d_model 3072, 24 heads of 128,
~12 B parameters. The text frontend (T5/CLIP) is a stub, as in the
reference: the caller passes text embeddings [B, txt_len, t5_dim] and a
pooled CLIP vector [B, clip_dim]. 2-axis RoPE over the latent grid (text
tokens at position 0); modulation from (timestep, guidance, pooled vec).
Blocks run one after another (the reference scans them); with ``remat``
each block is recomputed in the backward (``layers.remat``).

Joint attention goes through ``layers.sdpa`` (non-causal, no bias: on the
card the tensor-core flash kernel). It computes the reference's
einsum-softmax-einsum without its f32 [B, H, S, S] scores (8.2 GB a layer
at 4608 tokens and B=4). The bf16 rounding points differ: the reference
rounds the softmax weights to bf16 before P.V, the kernel rounds once at
the output; so parity with the reference is stated in f32.

Under sharding rules ``forward`` constrains the embedded image and text
streams to ("batch", "seq", "act_embed"), as the reference; without rules
it is the identity.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.rules import constrain, hold_grad_placements
from repro_torch.models.dit import patchify, unpatchify
from repro_torch.models.param import layer_params, stack_specs


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    img_res: int = 1024
    patch: int = 2
    latent_channels: int = 16
    vae_factor: int = 8
    d_model: int = 3072
    n_heads: int = 24
    n_double: int = 19
    n_single: int = 38
    mlp_ratio: int = 4
    txt_len: int = 512
    t5_dim: int = 4096
    clip_dim: int = 768
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def latent_res(self) -> int:
        return self.img_res // self.vae_factor

    @property
    def grid(self) -> int:
        return self.latent_res // self.patch

    @property
    def n_img_tokens(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.d_model * self.mlp_ratio


def _mod_specs(cfg: FluxConfig, n: int) -> dict:
    return L.linear_specs(cfg.d_model, n * cfg.d_model, axes=("embed", "mlp"), init="zeros")


def _double_specs(cfg: FluxConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "img_mod": _mod_specs(cfg, 6),
        "txt_mod": _mod_specs(cfg, 6),
        "img_attn": L.attention_specs(d, h, h, hd, qk_norm=True),
        "txt_attn": L.attention_specs(d, h, h, hd, qk_norm=True),
        "img_mlp": L.mlp_specs(d, cfg.d_ff),
        "txt_mlp": L.mlp_specs(d, cfg.d_ff),
    }


def _single_specs(cfg: FluxConfig) -> dict:
    d = cfg.d_model
    return {
        "mod": _mod_specs(cfg, 3),
        # fused qkv + mlp-in in one projection, attn-out + mlp-out in another
        "wqkv_mlp": L.linear_specs(d, 3 * d + cfg.d_ff, axes=("embed", "heads")),
        "q_norm": L.rmsnorm_specs(cfg.head_dim, (None,)),
        "k_norm": L.rmsnorm_specs(cfg.head_dim, (None,)),
        "w_out": L.linear_specs(d + cfg.d_ff, d, axes=("heads", "embed")),
    }


def specs(cfg: FluxConfig) -> dict:
    pdim = cfg.patch * cfg.patch * cfg.latent_channels
    d = cfg.d_model
    return {
        "img_in": L.linear_specs(pdim, d, axes=("patch", "embed")),
        "txt_in": L.linear_specs(cfg.t5_dim, d, axes=("patch", "embed")),
        "time_in1": L.linear_specs(256, d, axes=(None, "embed")),
        "time_in2": L.linear_specs(d, d, axes=("embed", "embed")),
        "guid_in1": L.linear_specs(256, d, axes=(None, "embed")),
        "guid_in2": L.linear_specs(d, d, axes=("embed", "embed")),
        "vec_in1": L.linear_specs(cfg.clip_dim, d, axes=(None, "embed")),
        "vec_in2": L.linear_specs(d, d, axes=("embed", "embed")),
        "double": stack_specs(cfg.n_double, lambda: _double_specs(cfg)),
        "single": stack_specs(cfg.n_single, lambda: _single_specs(cfg)),
        "final_ln": L.layernorm_specs(d),
        "final_ada": _mod_specs(cfg, 2),
        "final_proj": L.linear_specs(d, pdim, axes=("embed", "patch"), init="zeros"),
    }


def _rope_2d(x: torch.Tensor, pos_hw: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, D]; pos_hw [B, S, 2] (row, col; text tokens 0): RoPE of
    the rows on the first half of D, of the columns on the second."""
    x_r, x_c = x.chunk(2, dim=-1)
    return torch.cat([L.apply_rope(x_r, pos_hw[..., 0], theta),
                      L.apply_rope(x_c, pos_hw[..., 1], theta)], dim=-1)


def _mlp_embed(params: dict, name: str, v: torch.Tensor) -> torch.Tensor:
    return L.linear(params[f"{name}2"], F.silu(L.linear(params[f"{name}1"], v)))


def _joint_attention(cfg: FluxConfig, q, k, v) -> torch.Tensor:
    """q, k, v [B, S, H, D] -> [B, S, d_model], the flash kernel on the card."""
    out = L.sdpa(q, k, v)
    # the gradient of the heads' output must come back in whole heads
    return hold_grad_placements(out.reshape(*out.shape[:2], cfg.d_model))


def _qkv(ap: dict, x: torch.Tensor, cfg: FluxConfig, pos: torch.Tensor):
    q, k, v = (L._proj(ap, n, x, cfg.n_heads, cfg.head_dim) for n in "qkv")
    q = _rope_2d(L.rmsnorm(ap["q_norm"], q), pos)
    k = _rope_2d(L.rmsnorm(ap["k_norm"], k), pos)
    return q, k, v


def _modulated(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return L.layernorm_noparam(x) * (1 + scale[:, None]) + shift[:, None]


def _double_block(bp: dict, cfg: FluxConfig, img, txt, vec, img_pos, txt_pos):
    ish1, isc1, ig1, ish2, isc2, ig2 = L.linear(bp["img_mod"], F.silu(vec)).chunk(6, dim=-1)
    tsh1, tsc1, tg1, tsh2, tsc2, tg2 = L.linear(bp["txt_mod"], F.silu(vec)).chunk(6, dim=-1)

    iq, ik, iv = _qkv(bp["img_attn"], _modulated(img, ish1, isc1), cfg, img_pos)
    tq, tk, tv = _qkv(bp["txt_attn"], _modulated(txt, tsh1, tsc1), cfg, txt_pos)
    attn = _joint_attention(cfg, torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                            torch.cat([tv, iv], dim=1))
    t_attn, i_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]

    ia, ta = bp["img_attn"], bp["txt_attn"]
    img = img + ig1[:, None] * L.linear({"w": ia["wo"], "b": ia["bo"]}, i_attn)
    txt = txt + tg1[:, None] * L.linear({"w": ta["wo"], "b": ta["bo"]}, t_attn)
    img = img + ig2[:, None] * L.mlp(bp["img_mlp"], _modulated(img, ish2, isc2))
    txt = txt + tg2[:, None] * L.mlp(bp["txt_mlp"], _modulated(txt, tsh2, tsc2))
    return img, txt


def _single_block(bp: dict, cfg: FluxConfig, x, vec, pos):
    sh, sc, g = L.linear(bp["mod"], F.silu(vec)).chunk(3, dim=-1)
    proj = L.linear(bp["wqkv_mlp"], _modulated(x, sh, sc))
    qkv, h = proj[..., :3 * cfg.d_model], proj[..., 3 * cfg.d_model:]
    b, s, _ = x.shape
    q, k, v = qkv.reshape(b, s, 3 * cfg.n_heads, cfg.head_dim).chunk(3, dim=2)
    q = _rope_2d(L.rmsnorm(bp["q_norm"], q), pos)
    k = _rope_2d(L.rmsnorm(bp["k_norm"], k), pos)
    attn = _joint_attention(cfg, q, k, v)
    out = L.linear(bp["w_out"], torch.cat([attn, F.gelu(h, approximate="tanh")], dim=-1))
    return x + g[:, None] * out


def forward(params: dict, cfg: FluxConfig, latents: torch.Tensor, txt: torch.Tensor,
            vec: torch.Tensor, t: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """Rectified-flow velocity prediction.

    latents [B, latent_res, latent_res, C]; txt [B, txt_len, t5_dim];
    vec [B, clip_dim]; t, guidance [B] -> [B, latent_res, latent_res, C].
    """
    b, g = latents.shape[0], cfg.grid
    img = L.linear(params["img_in"], patchify(cfg, latents.to(cfg.dtype)))
    txt_e = L.linear(params["txt_in"], txt.to(cfg.dtype))
    img = constrain(img, ("batch", "seq", "act_embed"))
    txt_e = constrain(txt_e, ("batch", "seq", "act_embed"))

    vec_c = (_mlp_embed(params, "time_in", L.timestep_embedding(t * 1000.0, 256).to(cfg.dtype))
             + _mlp_embed(params, "guid_in",
                          L.timestep_embedding(guidance * 1000.0, 256).to(cfg.dtype))
             + _mlp_embed(params, "vec_in", vec.to(cfg.dtype)))

    dev = latents.device
    rows = torch.arange(g, device=dev).repeat_interleave(g)
    cols = torch.arange(g, device=dev).repeat(g)
    img_pos = torch.stack([rows, cols], -1)[None].expand(b, g * g, 2)
    txt_pos = torch.zeros((b, cfg.txt_len, 2), dtype=torch.long, device=dev)

    for l in range(cfg.n_double):
        img, txt_e = L.remat(cfg.remat, _double_block, layer_params(params, l, "double"), cfg,
                             img, txt_e, vec_c, img_pos, txt_pos)
    x = torch.cat([txt_e, img], dim=1)
    all_pos = torch.cat([txt_pos, img_pos], dim=1)
    for l in range(cfg.n_single):
        x = L.remat(cfg.remat, _single_block, layer_params(params, l, "single"), cfg, x, vec_c,
                    all_pos)
    img = x[:, cfg.txt_len:]

    sh, sc = L.linear(params["final_ada"], F.silu(vec_c)).chunk(2, dim=-1)
    img = L.layernorm(params["final_ln"], img) * (1 + sc[:, None]) + sh[:, None]
    return unpatchify(cfg, L.linear(params["final_proj"], img))
