"""Decoder-only transformer LM: PyTorch port of ``repro.models.lm``.

Covers starcoder2-3b (LayerNorm + GELU MLP + biases, tied embeddings),
internlm2-1.8b (RMSNorm + SwiGLU, untied ``lm_head``), qwen3-moe-30b-a3b
(RMSNorm + SwiGLU experts, qk-norm) and granite-moe-3b-a800m (SwiGLU
experts padded 40 -> 48): GQA with RoPE; MoE blocks through ``models.moe``.

Entry points, as the reference's:
  forward      causal forward over [B, S] -> (logits [B, S, V], MoE aux loss)
  lm_loss      next-token cross entropy of those logits
  prefill      causal forward over a prompt that also fills the KV cache
               (attention through the flash kernel, causal)
  decode_step  one token against the cache (attention through the decode
               kernel)

The cache is either ``stacked``, {"k", "v"} [L, B, S_max, n_kv, hd], or
``per_layer``, a list of L {"k", "v"} [B, S_max, n_kv, hd] buffers; with
``cache_quant_scale`` its entries are int8 steps of that scale. Layers run
in a Python loop over the stacked ``blocks/*`` params (the reference scans
them).

Under sharding rules (``sharding.rules.use_rules``) the reference's
``constrain`` sites apply to the DTensor activations; ``init_cache``
places the cache by ``cache_axes`` (``abstract_cache`` gives its shapes as
meta tensors) once, and every write into it (``layers.cache_write``) is in
place on each rank's local tensors, so the reference's per-step
re-constraint of the cache has nothing to do. With ``moe_impl="a2a"`` and
rules active, the MoE layers run ``moe_a2a.apply`` on the rules' mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_a2a
from repro_torch.models.param import flatten, layer_params, stack_specs, tree_map
from repro_torch.runtime.device import require_on, resolve_device
from repro_torch.sharding.rules import constrain, current_rules


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's fields and defaults. ``remat`` recomputes each block
    of ``forward`` in the backward (``layers.remat``). ``attn_chunk`` and
    ``cache_reshard_per_layer`` concern the chunked jnp attention or meshes;
    the port accepts and ignores them. ``moe_impl="a2a"`` runs
    ``moe_a2a.apply`` on the active rules' mesh; without rules the gspmd
    path serves, as in the reference."""
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
    moe: moe_lib.MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    aux_loss_coef: float = 0.01
    attn_chunk: int | None = 512
    cache_quant_scale: float | None = None  # int8 KV cache when set
    cache_reshard_per_layer: bool = False
    cache_layout: str = "stacked"   # "stacked" | "per_layer"
    moe_impl: str = "gspmd"         # "gspmd" | "a2a"

    def __post_init__(self):
        if self.cache_layout not in ("stacked", "per_layer"):
            raise ValueError(f"cache_layout {self.cache_layout!r}; need 'stacked' or 'per_layer'")

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch.int8 if self.cache_quant_scale is not None else self.dtype

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
    if cfg.moe is not None:
        p["moe"] = moe_lib.specs(cfg.moe)
    elif cfg.act == "swiglu":
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


def _ffn(bp: dict, cfg: LMConfig, x: torch.Tensor):
    """(ffn(x), aux loss): the MoE layer's, or a dense FFN's and 0. With
    ``moe_impl="a2a"`` and rules active the MoE layer is ``moe_a2a.apply``
    on the rules' mesh; otherwise ``moe.apply`` (without a mesh the two are
    the same computation)."""
    if cfg.moe is not None:
        rules = current_rules()
        if cfg.moe_impl == "a2a" and rules is not None:
            return moe_a2a.apply(bp["moe"], cfg.moe, x, rules.mesh)
        return moe_lib.apply(bp["moe"], cfg.moe, x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.act == "swiglu":
        return L.swiglu(bp["ffn"], x), zero
    return L.mlp(bp["ffn"], x), zero


def _block(bp: dict, cfg: LMConfig, x: torch.Tensor, *, kv_cache=None,
           cache_index: int | None = None, kv_len: torch.Tensor | None = None,
           return_kv: bool = False):
    """One layer: returns (x, new_cache, aux) with ``new_cache`` as
    ``layers.attention`` defines it."""
    h = constrain(L.norm(cfg.norm, bp["norm1"], x), ("batch", "seq", "act_embed"))
    attn_out, new_cache = L.attention(
        bp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, causal=True, rope=True, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len,
        cache_quant_scale=cfg.cache_quant_scale, return_kv=return_kv)
    x = x + attn_out
    ffn_out, aux = _ffn(bp, cfg, L.norm(cfg.norm, bp["norm2"], x))
    x = constrain(x + ffn_out, ("batch", "seq", "act_embed"))
    return x, new_cache, aux


def _logits(params: dict, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.norm(cfg.norm, params["norm_f"], x)
    if cfg.tie_embeddings:
        out = L.unembed(params["embed"], x)
    else:
        out = L.linear(params["lm_head"], x)
    return constrain(out, ("batch", "seq", "act_vocab"))


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, S] -> (logits [B, S, V], aux loss: the sum of the MoE
    layers' load-balancing losses, f32, 0 for a dense model)."""
    require_on(tokens.device, {f"params/{k}": v for k, v in flatten(params).items()})
    x = constrain(L.embed(params["embed"], tokens).to(cfg.dtype), ("batch", "seq", "act_embed"))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(cfg.n_layers):
        x, _, layer_aux = L.remat(cfg.remat, _block, layer_params(params, l), cfg, x)
        aux = aux + layer_aux
    return _logits(params, cfg, x), aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; logits [B, S, V], labels [B, S] (already
    shifted)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = L.take_labels(logp, labels)
    return -ll.mean()


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed cache in ``cfg.cache_layout``: {"k", "v"} [L, B, max_len, n_kv,
    hd] (``stacked``) or a list of L {"k", "v"} [B, max_len, n_kv, hd]
    (``per_layer``), on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``; raises if no card is there). ``prefill`` passes
    ``cfg.cache_dtype``. Under rules each buffer is placed by
    ``cache_axes(cfg)``."""
    device = resolve_device(device)
    rules = current_rules()
    axes = cache_axes(cfg)

    def buffer(t: torch.Tensor) -> torch.Tensor:
        z = torch.zeros(t.shape, dtype=dtype, device=device)
        return z if rules is None or device.type == "meta" else rules.place(z, axes)

    cache = abstract_cache(cfg, batch, max_len, dtype)
    if isinstance(cache, dict):
        return tree_map(buffer, cache)
    return [tree_map(buffer, layer) for layer in cache]


def abstract_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The cache's buffers as meta tensors (shapes and dtypes, no memory),
    in ``cfg.cache_layout``."""
    if cfg.cache_layout == "per_layer":
        shape = (batch, max_len, cfg.n_kv, cfg.hd)
        return [{"k": torch.empty(shape, dtype=dtype, device="meta"),
                 "v": torch.empty(shape, dtype=dtype, device="meta")}
                for _ in range(cfg.n_layers)]
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


CACHE_AXES = ("layers", "batch", "act_seq_kv", "act_kv", None)
CACHE_AXES_PER_LAYER = ("batch", "act_seq_kv", "act_kv", None)


def cache_axes(cfg: LMConfig):
    return (CACHE_AXES_PER_LAYER if cfg.cache_layout == "per_layer"
            else CACHE_AXES)


def _layer_cache(cache, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``l``'s (k, v) [B, S_max, n_kv, hd] of either layout (views)."""
    if isinstance(cache, dict):
        return cache["k"][l], cache["v"][l]
    return cache[l]["k"], cache[l]["v"]


def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, max_len: int | None = None):
    """Causal forward over ``tokens`` [B, S]; returns (last-position logits
    [B, 1, V], cache). The cache, in ``cfg.cache_layout`` and
    ``cfg.cache_dtype``, holds the prompt's k/v in [0, S) and zeros up to
    ``max_len`` (default S). Runs on the device of ``tokens``; the params
    must lie there too."""
    require_on(tokens.device, {f"params/{k}": v for k, v in flatten(params).items()})
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt length {s}")
    cache = init_cache(cfg, b, max_len, dtype=cfg.cache_dtype, device=tokens.device)
    x = constrain(L.embed(params["embed"], tokens).to(cfg.dtype), ("batch", "seq", "act_embed"))
    for l in range(cfg.n_layers):
        x, (k, v), _ = _block(layer_params(params, l), cfg, x, return_kv=True)
        kc, vc = _layer_cache(cache, l)
        L.cache_write(kc, k, 0)
        L.cache_write(vc, v, 0)
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: LMConfig, token: torch.Tensor, cache, index: int):
    """One decode step: ``token`` [B, 1] at position ``index`` (a Python int,
    the number of valid cache entries before this step). Returns (logits
    [B, 1, V], cache); ``cache`` is in ``cfg.cache_layout``.

    Unlike the reference, which returns a new cache, this writes the step's
    k/v into ``cache`` IN PLACE at ``index`` and returns the same object. The
    valid lengths handed to the decode kernel (``index + 1``) are built on
    the device from the Python int: no host read-back."""
    if isinstance(cache, dict) != (cfg.cache_layout == "stacked"):
        raise ValueError(f"cache_layout {cfg.cache_layout!r} does not match a cache of "
                         f"type {type(cache).__name__}")
    k0, v0 = _layer_cache(cache, 0)
    require_on(token.device, {"cache/k": k0, "cache/v": v0})
    index = int(index)
    if not 0 <= index < k0.shape[1]:
        raise ValueError(f"index {index} outside the cache capacity {k0.shape[1]}")
    x = constrain(L.embed(params["embed"], token).to(cfg.dtype), ("batch", "seq", "act_embed"))
    kv_len = torch.full((token.shape[0],), index + 1, dtype=torch.int32, device=token.device)
    for l in range(cfg.n_layers):
        x, _, _ = _block(layer_params(params, l), cfg, x, kv_cache=_layer_cache(cache, l),
                         cache_index=index, kv_len=kv_len)
    return _logits(params, cfg, x), cache
