"""Swin Transformer, PyTorch port of ``repro.models.swin`` (the swin-b
architecture: window 7, depths 2-2-18-2).

Window attention with a relative position bias, shifted windows by
``torch.roll`` with a precomputed cross-window mask, and patch merging
between stages (the grid halves, channels double). Blocks of a stage come
in (regular, shifted) pairs stacked over a leading axis (the reference
scans the pairs; they run one after another here).

Window attention stays plain ``torch.matmul``/softmax, as the reference
computes it outside any Pallas kernel: f32 scores plus the [H, n, n]
relative bias (an operand the flash kernel does not take), ``-1e30`` on
masked pairs, softmax in f32, then the activation dtype. The output
projection casts ``wo`` to the activation dtype, as every other projection
does. The reference's einsum instead multiplies by ``wo`` as stored: with
f32 master weights and bf16 activations it promotes the block's output to
f32, and its scan then rejects the changed carry type (a bf16 Swin runs
there only on bf16 weights); on bf16 weights both agree.

Janus splits Swin at stage boundaries; ToMe does not apply (windows need
dense grids). Under sharding rules each stage's output is constrained to
("batch", None, None, "act_embed"), as the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer_params, stack_specs
from repro_torch.sharding.rules import constrain, run_local


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_res: int = 224
    patch: int = 4
    window: int = 7
    depths: tuple[int, ...] = (2, 2, 18, 2)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    heads: tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: int = 4
    n_classes: int = 1000
    in_channels: int = 3
    dtype: torch.dtype = torch.float32


def _rel_pos_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] indices into the (2ws-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, n, n]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws*ws, ws*ws] boolean mask (True = attend) for shifted windows."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return win[:, :, None] == win[:, None, :]


@functools.cache
def _tables(ws: int, hw: int, device: torch.device):
    """(relative-bias index [n*n] int64, shift mask [nW, n, n] bool) on
    ``device``, built once per (window, grid, device)."""
    idx = torch.from_numpy(_rel_pos_index(ws).reshape(-1).astype(np.int64)).to(device)
    mask = torch.from_numpy(_shift_mask(hw, hw, ws, ws // 2)).to(device)
    return idx, mask


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _block_specs(dim: int, heads: int, ws: int, mlp_ratio: int) -> dict:
    return {
        "ln1": L.layernorm_specs(dim),
        "attn": L.attention_specs(dim, heads, heads, dim // heads, bias=True),
        "rel_bias": ParamSpec(((2 * ws - 1) ** 2, heads), (None, "heads"), init="normal"),
        "ln2": L.layernorm_specs(dim),
        "mlp": L.mlp_specs(dim, dim * mlp_ratio),
    }


def specs(cfg: SwinConfig) -> dict:
    pdim = cfg.patch * cfg.patch * cfg.in_channels
    p: dict = {
        "patch_embed": L.linear_specs(pdim, cfg.dims[0], axes=("patch", "embed")),
        "ln_embed": L.layernorm_specs(cfg.dims[0]),
    }
    for i, depth in enumerate(cfg.depths):
        if depth % 2:
            raise ValueError("swin stages alternate regular/shifted pairs")
        p[f"stage{i}"] = stack_specs(
            depth // 2,
            lambda d=cfg.dims[i], h=cfg.heads[i]: {
                "reg": _block_specs(d, h, cfg.window, cfg.mlp_ratio),
                "shift": _block_specs(d, h, cfg.window, cfg.mlp_ratio),
            })
        if i < len(cfg.depths) - 1:
            p[f"merge{i}"] = {
                "ln": L.layernorm_specs(4 * cfg.dims[i]),
                "proj": L.linear_specs(4 * cfg.dims[i], cfg.dims[i + 1],
                                       axes=("embed", "mlp"), bias=False),
            }
    p["norm"] = L.layernorm_specs(cfg.dims[-1])
    p["head"] = L.linear_specs(cfg.dims[-1], cfg.n_classes, axes=("embed", "vocab"))
    return p


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x [B, hw, hw, C] rolled by ``shift`` on both spatial dims; behind the
    local boundary on DTensors (DTensor has no strategy for ``roll``)."""
    rows = ("batch", None, None, "channels")
    return run_local("roll", lambda t: torch.roll(t, (shift, shift), dims=(1, 2)), (x,),
                     (rows,), rows)


def _win_attention(bp: dict, cfg: SwinConfig, x: torch.Tensor, heads: int,
                   shift: bool, hw: int) -> torch.Tensor:
    """Windowed (optionally shifted) attention over x [B, hw, hw, C]."""
    ws = cfg.window
    n = ws * ws
    rel_idx, mask = _tables(ws, hw, x.device)
    rel_bias = bp["rel_bias"][rel_idx].reshape(n, n, heads).permute(2, 0, 1)  # [H, n, n]

    sh = ws // 2
    h = L.layernorm(bp["ln1"], x)
    if shift:
        h = _roll(h, -sh)
    dim = h.shape[-1]
    hd = dim // heads
    n_win = (hw // ws) ** 2

    # windows are independent per image, and heads per head: on DTensors
    # the partition, the attention and the reverse run behind the local
    # boundary (DTensor cannot flatten the head-sharded [B*nW, H] dims, and
    # its backward would split one image's windows across ranks), the
    # projections outside it
    win = run_local("swin window partition", lambda t: _window_partition(t, ws), (h,),
                    (("batch", None, None, None),), ("batch", None, None))  # [B*nW, n, C]
    q, k, v = (L._proj(bp["attn"], name, win, heads, hd) for name in "qkv")  # [B*nW, n, H, hd]

    def core(q, k, v, rel_bias):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)  # [B*nW, H, n, n]
        scores = scores + rel_bias[None].float()
        if shift:
            m = mask.repeat(q.shape[0] // mask.shape[0], 1, 1)[:, None]  # [B*nW, 1, n, n]
            scores = torch.where(m, scores, torch.full_like(scores, -1e30))
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(w, v)
        return out.transpose(1, 2).reshape(out.shape[0], n, out.shape[1] * hd)

    rows = ("batch", None, "heads", None)
    out = run_local("swin window attention", core, (q, k, v, rel_bias),
                    (rows, rows, rows, ("heads", None, None)), ("batch", None, "heads"))
    out = out @ bp["attn"]["wo"].to(out.dtype) + bp["attn"]["bo"].to(x.dtype)
    out = run_local("swin window reverse",
                    lambda t: _window_reverse(t, ws, t.shape[0] // n_win, hw, hw), (out,),
                    (("batch", None, None),), ("batch", None, None, None))
    out = constrain(out, ("batch", None, None, "act_embed"))  # and its gradient
    if shift:
        out = _roll(out, sh)
    return out


def _block(bp: dict, cfg: SwinConfig, x: torch.Tensor, heads: int, shift: bool,
           hw: int) -> torch.Tensor:
    # on DTensors, the residual enters each block replicated but for the
    # batch (the reference constrains it once a stage and leaves the rest to
    # XLA; DTensor would carry a spatial or batch split on "model" into the
    # roll and the windows, which treat neither independently of the heads)
    x = constrain(x, ("batch", None, None, "act_embed"))
    x = x + _win_attention(bp, cfg, x, heads, shift, hw)
    return x + L.mlp(bp["mlp"], L.layernorm(bp["ln2"], x))


def forward(params: dict, cfg: SwinConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C] (NHWC) -> logits [B, n_classes]."""
    b = images.shape[0]
    p = cfg.patch
    hw = cfg.img_res // p
    x = images.to(cfg.dtype).reshape(b, hw, p, hw, p, cfg.in_channels)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hw, hw, p * p * cfg.in_channels)
    x = L.layernorm(params["ln_embed"], L.linear(params["patch_embed"], x))

    for i, depth in enumerate(cfg.depths):
        for j in range(depth // 2):
            pair = layer_params(params, j, f"stage{i}")
            x = _block(pair["reg"], cfg, x, cfg.heads[i], False, hw)
            x = _block(pair["shift"], cfg, x, cfg.heads[i], True, hw)
        x = constrain(x, ("batch", None, None, "act_embed"))
        if i < len(cfg.depths) - 1:
            # patch merging: 2x2 neighbourhoods -> 4C -> proj to the next dim
            x = x.reshape(b, hw // 2, 2, hw // 2, 2, cfg.dims[i])
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hw // 2, hw // 2, 4 * cfg.dims[i])
            x = constrain(x, ("batch", None, None, "act_embed"))  # its gradient, on DTensors
            x = L.linear(params[f"merge{i}"]["proj"], L.layernorm(params[f"merge{i}"]["ln"], x))
            hw //= 2
    x = L.layernorm(params["norm"], x)
    return L.linear(params["head"], x.mean(dim=(1, 2)))
