"""Decoder-only transformer LM, dense part: PyTorch port of ``repro.models.lm``.

Covers starcoder2-3b (LayerNorm + GELU MLP + biases, tied embeddings) and
internlm2-1.8b (RMSNorm + SwiGLU, untied ``lm_head``): GQA with RoPE.

Two serving entry points, as the reference's ``launch/steps.py`` jits them:
  prefill      causal forward over a prompt that also fills the KV cache
               (attention through the flash kernel, causal)
  decode_step  one token against the stacked [L, B, S_max, n_kv, hd] cache
               (attention through the decode kernel)

Layers run in a Python loop over the stacked ``blocks/*`` params (the
reference scans them). Not ported yet: MoE, the int8 KV cache and the
``per_layer`` cache layout (ROADMAP queue 1, items 11-12), and the training
entry points ``forward``/``lm_loss`` (item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.param import flatten, layer_params, stack_specs
from repro_torch.runtime.device import require_on, resolve_device


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields and defaults. ``remat``, ``aux_loss_coef``,
    ``attn_chunk``, ``cache_reshard_per_layer`` and ``moe_impl`` concern
    training, the chunked jnp attention, meshes or MoE; the port's serving
    path accepts and ignores them."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    norm: str = "ln"            # "ln" | "rms"
    act: str = "gelu"           # "gelu" (mlp) | "swiglu"
    attn_bias: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    moe: Any = None
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    aux_loss_coef: float = 0.01
    attn_chunk: int | None = 512
    cache_quant_scale: float | None = None
    cache_reshard_per_layer: bool = False
    cache_layout: str = "stacked"
    moe_impl: str = "gspmd"

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError("MoE LMs are not ported yet (ROADMAP queue 1, item 12)")
        if self.cache_quant_scale is not None:
            raise NotImplementedError("the int8 KV cache is not ported yet "
                                      "(ROADMAP queue 1, item 11)")
        if self.cache_layout != "stacked":
            raise NotImplementedError(f"cache_layout={self.cache_layout!r} is not ported yet "
                                      "(ROADMAP queue 1, item 11); use 'stacked'")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def _block_specs(cfg: LMConfig) -> dict:
    p = {
        "norm1": L.norm_specs(cfg.norm, cfg.d_model),
        "attn": L.attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                                  bias=cfg.attn_bias, qk_norm=cfg.qk_norm),
        "norm2": L.norm_specs(cfg.norm, cfg.d_model),
    }
    if cfg.act == "swiglu":
        p["ffn"] = L.swiglu_specs(cfg.d_model, cfg.d_ff)
    else:
        p["ffn"] = L.mlp_specs(cfg.d_model, cfg.d_ff, bias=cfg.attn_bias)
    return p


def specs(cfg: LMConfig) -> dict:
    p = {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model),
        "blocks": stack_specs(cfg.n_layers, lambda: _block_specs(cfg)),
        "norm_f": L.norm_specs(cfg.norm, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.linear_specs(cfg.d_model, cfg.vocab, axes=("embed", "vocab"), bias=False)
    return p


def _block(bp: dict, cfg: LMConfig, x: torch.Tensor, *, kv_cache=None,
           cache_index: int | None = None, kv_len: torch.Tensor | None = None,
           return_kv: bool = False):
    """One layer: returns (x, new_cache) as ``layers.attention`` defines it."""
    attn_out, new_cache = L.attention(
        bp["attn"], L.norm(cfg.norm, bp["norm1"], x), n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, causal=True, rope=True, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len, return_kv=return_kv)
    x = x + attn_out
    h = L.norm(cfg.norm, bp["norm2"], x)
    x = x + (L.swiglu(bp["ffn"], h) if cfg.act == "swiglu" else L.mlp(bp["ffn"], h))
    return x, new_cache


def _logits(params: dict, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.norm(cfg.norm, params["norm_f"], x)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.linear(params["lm_head"], x)


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed stacked cache {"k", "v"} [L, B, max_len, n_kv, hd] on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``; raises if
    no card is there)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, max_len: int | None = None):
    """Causal forward over ``tokens`` [B, S]; returns (last-position logits
    [B, 1, V], cache). The cache holds the prompt's k/v in [0, S) and zeros
    up to ``max_len`` (default S), in the activation dtype. Runs on the
    device of ``tokens``; the params must lie there too."""
    require_on(tokens.device, {f"params/{k}": v for k, v in flatten(params).items()})
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    cache = init_cache(cfg, b, max_len, dtype=cfg.dtype, device=tokens.device)
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    for l in range(cfg.n_layers):
        x, (k, v) = _block(layer_params(params, l), cfg, x, return_kv=True)
        cache["k"][l, :, :s] = k
        cache["v"][l, :, :s] = v
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor, cache: dict, index: int):
    """One decode step: ``token`` [B, 1] at position ``index`` (a Python int,
    the number of valid cache entries before this step). Returns (logits
    [B, 1, V], cache).

    Unlike the reference, which returns a new cache, this writes the step's
    k/v into ``cache`` IN PLACE at ``index`` and returns the same dict. The
    valid lengths handed to the decode kernel (``index + 1``) are built on
    the device from the Python int: no host read-back."""
    require_on(token.device, {"cache/k": cache["k"], "cache/v": cache["v"]})
    index = int(index)
    if not 0 <= index < cache["k"].shape[2]:
        raise ValueError(f"index {index} outside the cache capacity {cache['k'].shape[2]}")
    x = L.embed(params["embed"], token).to(cfg.dtype)
    kv_len = torch.full((token.shape[0],), index + 1, dtype=torch.int32, device=token.device)
    for l in range(cfg.n_layers):
        x, _ = _block(layer_params(params, l), cfg, x, kv_cache=(cache["k"][l], cache["v"][l]),
                      cache_index=index, kv_len=kv_len)
    return _logits(params, cfg, x), cache

