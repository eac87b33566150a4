"""Vision Transformer, PyTorch port of ``repro.models.vit`` (the Janus path).

``forward_janus`` runs unrolled blocks with a static per-layer ToMe merge
schedule, and ``run_blocks`` / ``run_blocks_padded`` run any layer range
``[start, end)`` so the engine can run the device partition and the cloud
partition separately. Parameters are the reference's tree (``specs``), with
``blocks/*`` stacked over layers; ``layer_params`` slices one layer (views,
no copies).

Not ported yet: the scan-based ``forward`` (off the Janus path) and the
sharding ``constrain`` annotations of ``run_blocks``, which are no-ops on
one device (they come with the mesh slice).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import tome
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, stack_specs, tree_map


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_res: int = 224
    patch: int = 16
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 1000
    in_channels: int = 3
    dtype: torch.dtype = torch.float32
    prop_attn: bool = True  # ToMe proportional attention when pruning
    fused_qkv: bool = False  # single fused QKV matmul

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def grid(self) -> int:
        return self.img_res // self.patch

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1  # + cls


def _block_specs(cfg: ViTConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(cfg.d_model),
        "attn": L.attention_specs(cfg.d_model, cfg.n_heads, cfg.head_dim,
                                  bias=True, fused_qkv=cfg.fused_qkv),
        "ln2": L.layernorm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def specs(cfg: ViTConfig) -> dict:
    pdim = cfg.patch * cfg.patch * cfg.in_channels
    return {
        "patch_embed": L.linear_specs(pdim, cfg.d_model, axes=("patch", "embed")),
        "cls": ParamSpec((1, 1, cfg.d_model), (None, None, "embed"), init="normal"),
        "pos": ParamSpec((1, cfg.num_tokens, cfg.d_model), (None, "pos", "embed"),
                         init="normal"),
        "blocks": stack_specs(cfg.n_layers, lambda: _block_specs(cfg)),
        "norm": L.layernorm_specs(cfg.d_model),
        "head": L.linear_specs(cfg.d_model, cfg.n_classes, axes=("embed", "vocab")),
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] (NHWC, as the reference) -> [B, N, P*P*C]"""
    b, h, w, c = images.shape
    p = cfg.patch
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def embed_tokens(params: dict, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    x = L.linear(params["patch_embed"], patchify(cfg, images).to(cfg.dtype))
    cls = params["cls"].to(x.dtype).expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos"].to(x.dtype)


def _block(bp: dict, cfg: ViTConfig, x: torch.Tensor, sizes: torch.Tensor | None = None,
           merge_r: int = 0):
    bias = None
    if sizes is not None and cfg.prop_attn:
        bias = torch.log(sizes.float())
    attn_out, metric = L.attention(bp["attn"], L.layernorm(bp["ln1"], x),
                                   n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                   bias=bias, return_metric=True)
    x = x + attn_out
    if merge_r > 0:
        if sizes is None:
            raise ValueError("merging needs token sizes")
        x, sizes = tome.tome_merge(x, metric, sizes, merge_r)
    x = x + L.mlp(bp["mlp"], L.layernorm(bp["ln2"], x))
    return x, sizes


def layer_params(params: dict, l: int) -> dict:
    """One layer's slice of the stacked block params (views)."""
    return tree_map(lambda a: a[l], params["blocks"])


def run_blocks(params: dict, cfg: ViTConfig, x: torch.Tensor, sizes: torch.Tensor,
               schedule: Sequence[int], start: int, end: int):
    """Run blocks [start, end) with per-layer merge counts ``schedule[l]``.
    Token count entering layer l is num_tokens - sum(schedule[:l]).
    Returns (x, sizes)."""
    if len(schedule) != cfg.n_layers:
        raise ValueError(f"schedule has {len(schedule)} entries, model {cfg.n_layers} layers")
    for l in range(start, end):
        x, sizes = _block(layer_params(params, l), cfg, x, sizes, merge_r=int(schedule[l]))
    return x, sizes


def _block_padded(bp: dict, cfg: ViTConfig, x: torch.Tensor, sizes: torch.Tensor,
                  merge_r: int = 0):
    """Pad-aware block for bucketed execution: ``sizes == 0`` marks pad
    tokens (at the tail on entry). Pad keys get an additive -inf attention
    bias, so their softmax weight is exactly zero; merging goes through
    ``tome.tome_merge_padded``."""
    s32 = sizes.float()
    if cfg.prop_attn:
        bias = torch.log(s32)  # pads: log(0) = -inf
    else:
        bias = torch.where(s32 > 0.0, 0.0, -torch.inf)
    attn_out, metric = L.attention(bp["attn"], L.layernorm(bp["ln1"], x),
                                   n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                   bias=bias, return_metric=True)
    x = x + attn_out
    if merge_r > 0:
        x, sizes = tome.tome_merge_padded(x, metric, sizes, merge_r)
    x = x + L.mlp(bp["mlp"], L.layernorm(bp["ln2"], x))
    return x, sizes


def run_blocks_padded(params: dict, cfg: ViTConfig, x: torch.Tensor, sizes: torch.Tensor,
                      schedule: Sequence[int], start: int, end: int):
    """Pad-aware ``run_blocks``: tail tokens with ``sizes == 0`` are carried
    through every layer as inert padding."""
    if len(schedule) != cfg.n_layers:
        raise ValueError(f"schedule has {len(schedule)} entries, model {cfg.n_layers} layers")
    for l in range(start, end):
        x, sizes = _block_padded(layer_params(params, l), cfg, x, sizes,
                                 merge_r=int(schedule[l]))
    return x, sizes


def head_apply(params: dict, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.layernorm(params["norm"], x)
    return L.linear(params["head"], x[:, 0])


def forward_janus(params: dict, cfg: ViTConfig, images: torch.Tensor,
                  schedule: Sequence[int], split: int | None = None) -> torch.Tensor:
    """Full Janus forward (device and cloud in one call). ``split`` is
    accepted for signature parity with the reference; the engine runs the
    partitions separately."""
    x = embed_tokens(params, cfg, images)
    sizes = torch.ones(x.shape[:2], dtype=cfg.dtype, device=x.device)
    x, _ = run_blocks(params, cfg, x, sizes, schedule, 0, cfg.n_layers)
    return head_apply(params, cfg, x)


def token_counts(cfg: ViTConfig, schedule: Sequence[int]) -> list[int]:
    """Tokens *entering* each layer l (length n_layers + 1; last = output count)."""
    counts = [cfg.num_tokens]
    for r in schedule:
        counts.append(counts[-1] - int(r))
    return counts
