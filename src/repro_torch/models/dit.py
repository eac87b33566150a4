"""DiT (Diffusion Transformer, Peebles & Xie), PyTorch port of
``repro.models.dit`` (the dit-s2 architecture).

A ViT over VAE latents (img_res/8 spatial, 4 channels, patch 2 over the
latent grid) with adaLN-zero conditioning on (timestep, class). Blocks run
one after another (the reference scans them); with ``remat`` each block of
``forward`` is recomputed in the backward (``layers.remat``).

``forward_janus`` is Janus ToMe inside one denoise step (ToMe-for-SD):
every block attends with the proportional ``log(sizes)`` key bias (on the
card the tensor-core flash kernel), a merge layer matches through
``core.tome`` without protecting the first token (the ``tome_scores``
kernel), and the per-layer unmerge maps broadcast merged tokens' outputs
back to the dense grid, so the output has the dense forward's shape.

Under sharding rules ``forward`` constrains the embedded tokens to
("batch", "seq", "act_embed"), as the reference; without rules it is the
identity.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import tome
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer_params, stack_specs
from repro_torch.models.vit import patchify
from repro_torch.sharding.rules import constrain


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    img_res: int = 256
    patch: int = 2
    n_layers: int = 12
    d_model: int = 384
    n_heads: int = 6
    mlp_ratio: int = 4
    n_classes: int = 1000
    latent_channels: int = 4
    vae_factor: int = 8
    dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def latent_res(self) -> int:
        return self.img_res // self.vae_factor

    @property
    def grid(self) -> int:
        return self.latent_res // self.patch

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.d_model * self.mlp_ratio


def _block_specs(cfg: DiTConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(cfg.d_model),
        "attn": L.attention_specs(cfg.d_model, cfg.n_heads, cfg.n_heads, cfg.head_dim),
        "ln2": L.layernorm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff),
        # adaLN-zero: c -> (shift, scale, gate) x (attn, mlp)
        "ada": L.linear_specs(cfg.d_model, 6 * cfg.d_model, axes=("embed", "mlp"),
                              init="zeros"),
    }


def specs(cfg: DiTConfig) -> dict:
    pdim = cfg.patch * cfg.patch * cfg.latent_channels
    return {
        "patch_embed": L.linear_specs(pdim, cfg.d_model, axes=("patch", "embed")),
        "pos": ParamSpec((1, cfg.num_tokens, cfg.d_model), (None, "pos", "embed"), init="normal"),
        "t_mlp1": L.linear_specs(256, cfg.d_model, axes=(None, "embed")),
        "t_mlp2": L.linear_specs(cfg.d_model, cfg.d_model, axes=("embed", "embed")),
        "y_embed": L.embed_specs(cfg.n_classes + 1, cfg.d_model),  # +1 null class (CFG)
        "blocks": stack_specs(cfg.n_layers, lambda: _block_specs(cfg)),
        "final_ln": L.layernorm_specs(cfg.d_model),
        "final_ada": L.linear_specs(cfg.d_model, 2 * cfg.d_model, axes=("embed", "mlp"),
                                    init="zeros"),
        "final_proj": L.linear_specs(cfg.d_model, pdim, axes=("embed", "patch"), init="zeros"),
    }


def unpatchify(cfg, x: torch.Tensor) -> torch.Tensor:
    """[B, grid*grid, p*p*C] -> [B, grid*p, grid*p, C]: ``patchify``'s
    inverse (``patchify`` is the ViT's, on the latents). On DTensors the
    patch dim is gathered first (and its gradient constrained alike): torch
    2.11 cannot view a split of it across the patch rows."""
    x = constrain(x, ("batch", "seq", None))
    b = x.shape[0]
    g, p, c = cfg.grid, cfg.patch, cfg.latent_channels
    x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * p, g * p, c)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def conditioning(params: dict, cfg: DiTConfig, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """c [B, d] from timesteps t [B] (float) and class ids y [B]."""
    temb = L.timestep_embedding(t, 256).to(cfg.dtype)
    temb = L.linear(params["t_mlp2"], F.silu(L.linear(params["t_mlp1"], temb)))
    return temb + L.embed(params["y_embed"], y).to(cfg.dtype)


def _attend(bp: dict, cfg: DiTConfig, x: torch.Tensor, c: torch.Tensor,
            sizes: torch.Tensor | None):
    """The block up to its merge point: the adaLN modulations, then x plus
    the gated attention (key bias ``log(sizes)`` when sizes are given).
    Returns (x, ToMe metric, the MLP half's (shift, scale, gate))."""
    sh1, sc1, g1, sh2, sc2, g2 = L.linear(bp["ada"], F.silu(c)).chunk(6, dim=-1)
    bias = None if sizes is None else torch.log(sizes.float())
    attn_out, _, metric = L.attention(
        bp["attn"], _modulate(L.layernorm(bp["ln1"], x), sh1, sc1),
        n_heads=cfg.n_heads, n_kv=cfg.n_heads, head_dim=cfg.head_dim,
        bias=bias, return_metric=True)
    return x + g1[:, None] * attn_out, metric, (sh2, sc2, g2)


def _mlp(bp: dict, x: torch.Tensor, mod) -> torch.Tensor:
    sh2, sc2, g2 = mod
    return x + g2[:, None] * L.mlp(bp["mlp"], _modulate(L.layernorm(bp["ln2"], x), sh2, sc2))


def _block(bp: dict, cfg: DiTConfig, x: torch.Tensor, c: torch.Tensor,
           sizes: torch.Tensor | None = None) -> torch.Tensor:
    x, _, mod = _attend(bp, cfg, x, c, sizes)
    return _mlp(bp, x, mod)


def _final(params: dict, cfg: DiTConfig, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    sh, sc = L.linear(params["final_ada"], F.silu(c)).chunk(2, dim=-1)
    return _modulate(L.layernorm(params["final_ln"], x), sh, sc)


def _embed(params: dict, cfg: DiTConfig, latents: torch.Tensor) -> torch.Tensor:
    x = L.linear(params["patch_embed"], patchify(cfg, latents).to(cfg.dtype))
    return x + params["pos"].to(x.dtype)


def forward(params: dict, cfg: DiTConfig, latents: torch.Tensor, t: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Predict the noise eps. latents [B, latent_res, latent_res, C]; t [B]
    float; y [B] class ids -> [B, latent_res, latent_res, C]."""
    x = constrain(_embed(params, cfg, latents), ("batch", "seq", "act_embed"))
    c = conditioning(params, cfg, t, y)
    for l in range(cfg.n_layers):
        x = L.remat(cfg.remat, _block, layer_params(params, l), cfg, x, c)
    return unpatchify(cfg, L.linear(params["final_proj"], _final(params, cfg, x, c)))


def forward_janus(params: dict, cfg: DiTConfig, latents: torch.Tensor, t: torch.Tensor,
                  y: torch.Tensor, schedule: Sequence[int]) -> torch.Tensor:
    """ToMe-merged forward with dense-output reconstruction: ``schedule[l]``
    tokens merge at layer l, and merged tokens' outputs are broadcast back
    through the per-layer merge maps (ToMe-SD average unmerge). Output shape
    equals ``forward``'s."""
    if len(schedule) != cfg.n_layers:
        raise ValueError(f"schedule has {len(schedule)} entries, model {cfg.n_layers} layers")
    x = _embed(params, cfg, latents)
    c = conditioning(params, cfg, t, y)
    sizes = torch.ones(x.shape[:2], dtype=cfg.dtype, device=x.device)
    maps = []  # per merge: [B, n_before] -> index into n_after

    for l in range(cfg.n_layers):
        bp = layer_params(params, l)
        r = int(schedule[l])
        if r > 0:  # the match made explicitly, to record the unmerge map
            x, metric, mod = _attend(bp, cfg, x, c, sizes)
            idx = tome.bipartite_soft_matching(metric, r, protect_first=False)
            maps.append(_unmerge_map(x.shape[1], idx))
            x, sizes = tome.merge_tokens(x, sizes, idx)
            x = _mlp(bp, x, mod)
        else:
            x = _block(bp, cfg, x, c, sizes)

    x = _final(params, cfg, x, c)
    for m in reversed(maps):  # unmerge back to the full token grid
        x = torch.gather(x, 1, m[..., None].expand(-1, -1, x.shape[-1]))
    return unpatchify(cfg, L.linear(params["final_proj"], x))


def _unmerge_map(n_before: int, idx: tome.MergeIndices) -> torch.Tensor:
    """[B, n_before] int64 map: token position before a merge -> its position
    after it (the reference's values; int64 for ``torch.gather``). B tokens
    land at ``n_unm`` + their index, surviving A tokens at their rank in
    ``unm_idx``, merged A tokens where their destination B token went. The
    three position sets are disjoint, so the writes commute."""
    b, r = idx.src_idx.shape
    n_unm = (n_before + 1) // 2 - r
    dev = idx.src_idx.device
    out = torch.empty((b, n_before), dtype=torch.long, device=dev)
    n_b = n_before // 2
    out[:, 1::2] = n_unm + torch.arange(n_b, device=dev)
    out.scatter_(1, 2 * idx.unm_idx, torch.arange(n_unm, device=dev).expand(b, n_unm))
    out.scatter_(1, 2 * idx.src_idx, n_unm + idx.dst_idx)
    return out
