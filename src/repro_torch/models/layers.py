"""Model building blocks in PyTorch (the ViT and dense-LM subset of
``repro.models.layers``).

Plain functions on tensors and nested dicts of parameters, in the
reference's layout: weights are ``[d_in, d_out]`` masters cast to the
activation dtype at use. Norm and RoPE math is f32 whatever the activation
dtype. Attention goes through ``kernels.ops``: ``flash_attention`` for
self-attention and prefill, ``decode_attention`` for a cached decode step;
the Hopper kernels on a CUDA tensor, their plain versions on a CPU tensor.
The reference's ``chunked_sdpa`` has no counterpart: the flash kernel is it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.param import ParamSpec

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def linear_specs(d_in: int, d_out: int, *, axes=("embed", "mlp"), bias: bool = True,
                 init: str = "fan_in", scale: float | None = None) -> dict:
    p = {"w": ParamSpec((d_in, d_out), axes, init=init, scale=scale)}
    if bias:
        p["b"] = ParamSpec((d_out,), (axes[1],), init="zeros")
    return p


def layernorm_specs(d: int, axes=("embed",)) -> dict:
    return {"scale": ParamSpec((d,), axes, init="ones"),
            "bias": ParamSpec((d,), axes, init="zeros")}


def rmsnorm_specs(d: int, axes=("embed",)) -> dict:
    return {"scale": ParamSpec((d,), axes, init="ones")}


def norm_specs(kind: str, d: int, axes=("embed",)) -> dict:
    return layernorm_specs(d, axes) if kind == "ln" else rmsnorm_specs(d, axes)


def attention_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                    bias: bool = True, qk_norm: bool = False,
                    fused_qkv: bool = False) -> dict:
    """GQA attention (ViT is the ``n_kv == n_heads`` case)."""
    if fused_qkv:
        if n_kv != n_heads:
            raise ValueError("fused qkv is for MHA (ViT-family)")
        hd = n_heads * head_dim
        p = {"wqkv": ParamSpec((d_model, 3 * hd), ("embed", "heads"), init="fan_in"),
             "wo": ParamSpec((hd, d_model), ("heads", "embed"), init="fan_in")}
        if bias:
            p["bqkv"] = ParamSpec((3 * hd,), ("heads",), init="zeros")
            p["bo"] = ParamSpec((d_model,), ("embed",), init="zeros")
        return p
    hq, hkv = n_heads * head_dim, n_kv * head_dim
    p = {"wq": ParamSpec((d_model, hq), ("embed", "heads"), init="fan_in"),
         "wk": ParamSpec((d_model, hkv), ("embed", "kv"), init="fan_in"),
         "wv": ParamSpec((d_model, hkv), ("embed", "kv"), init="fan_in"),
         "wo": ParamSpec((hq, d_model), ("heads", "embed"), init="fan_in")}
    if bias:
        p["bq"] = ParamSpec((hq,), ("heads",), init="zeros")
        p["bk"] = ParamSpec((hkv,), ("kv",), init="zeros")
        p["bv"] = ParamSpec((hkv,), ("kv",), init="zeros")
        p["bo"] = ParamSpec((d_model,), ("embed",), init="zeros")
    if qk_norm:
        p["q_norm"] = rmsnorm_specs(head_dim, (None,))
        p["k_norm"] = rmsnorm_specs(head_dim, (None,))
    return p


def mlp_specs(d_model: int, d_ff: int, *, bias: bool = True) -> dict:
    return {"fc1": linear_specs(d_model, d_ff, axes=("embed", "mlp"), bias=bias),
            "fc2": linear_specs(d_ff, d_model, axes=("mlp", "embed"), bias=bias)}


def swiglu_specs(d_model: int, d_ff: int) -> dict:
    return {"gate": linear_specs(d_model, d_ff, axes=("embed", "mlp"), bias=False),
            "up": linear_specs(d_model, d_ff, axes=("embed", "mlp"), bias=False),
            "down": linear_specs(d_ff, d_model, axes=("mlp", "embed"), bias=False)}


def embed_specs(vocab: int, d_model: int) -> dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)}


# ---------------------------------------------------------------------------
# linear / norm / rope
# ---------------------------------------------------------------------------


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math and eps 1e-6, as the reference (torch's default is 1e-5)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math and eps 1e-6, as the reference."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


def norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x) if kind == "ln" else rmsnorm(p, x)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x [..., seq, heads, head_dim], positions [..., seq]: the reference's
    split-halves rotation, in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA-general; ViT is the n_kv == n_heads special case)
# ---------------------------------------------------------------------------


def _proj(p: dict, name: str, x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    y = x @ p[f"w{name}"].to(x.dtype)
    if f"b{name}" in p:
        y = y + p[f"b{name}"].to(y.dtype)
    return y.reshape(*y.shape[:-1], n, head_dim)


def _qkv_proj(p: dict, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    """q [B, S, Hq, D], k, v [B, S, Hkv, D]: one fused matmul when 'wqkv' is
    present (MHA only)."""
    if "wqkv" not in p:
        return (_proj(p, "q", x, n_heads, head_dim),
                _proj(p, "k", x, n_kv, head_dim),
                _proj(p, "v", x, n_kv, head_dim))
    y = x @ p["wqkv"].to(x.dtype)
    if "bqkv" in p:
        y = y + p["bqkv"].to(y.dtype)
    q, k, v = y.chunk(3, dim=-1)
    return tuple(t.reshape(*t.shape[:-1], n_heads, head_dim) for t in (q, k, v))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         bias: torch.Tensor | None = None, causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention, q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    -> [B, Sq, Hq, D], through the flash kernel.

    GQA repeats each kv head over its group (q head h reads kv head
    h // (Hq // Hkv)). ``bias`` [B, Sk] is additive on the key axis (ToMe
    proportional-attention log sizes, -inf on bucket pads); ``causal`` is
    bottom-right aligned. Scores and softmax are f32 throughout, as the
    reference's flash kernel: the reference's jnp ``sdpa`` instead rounds
    scores and softmax weights to the activation dtype, so parity with it is
    stated in f32."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    if bias is not None:
        bias = bias.float().contiguous()
    out = ops.flash_attention(*heads, bias=bias, causal=causal)
    return out.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
              causal: bool = False, rope: bool = False, rope_theta: float = 10000.0,
              bias: torch.Tensor | None = None, return_metric: bool = False,
              kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_index: int | None = None, kv_len: torch.Tensor | None = None,
              return_kv: bool = False):
    """Attention over ``x`` [B, S, d]; returns ``(out, new_cache)``, plus the
    ToMe metric (mean of the keys over kv heads, [B, S, head_dim]) with
    ``return_metric``, as the reference.

    - ``return_kv`` (prefill): ``new_cache`` is this call's (k, v)
      [B, S, n_kv, D], and attention runs through the flash kernel.
    - ``kv_cache=(k_cache, v_cache)`` [B, S_max, n_kv, D] with the Python
      int ``cache_index`` (decode, S == 1): the new k/v are written into the
      cache at ``cache_index`` IN PLACE, ``new_cache`` is the same pair, and
      attention runs through the decode kernel over keys [0, cache_index]
      (``kv_len`` [B] int32 = cache_index + 1, built here if not given).
    - otherwise ``new_cache`` is None.
    """
    b, s, _ = x.shape
    q, k, v = _qkv_proj(p, x, n_heads, n_kv, head_dim)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if rope:
        base = 0 if cache_index is None else cache_index
        positions = (base + torch.arange(s, device=x.device))[None, :].expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    new_cache = None
    if kv_cache is not None and not return_kv:
        if s != 1:
            raise ValueError(f"a cached call decodes one token, got {s}")
        k_cache, v_cache = kv_cache
        idx = 0 if cache_index is None else cache_index
        k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
        v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        if kv_len is None:
            kv_len = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
        kc, vc = (c if c.dtype == q.dtype else c.to(q.dtype) for c in (k_cache, v_cache))
        out = ops.decode_attention(q[:, 0], kc, vc, kv_len)
        if return_metric:
            k = kc
    else:
        if return_kv:
            new_cache = (k, v)
        out = sdpa(q, k, v, bias=bias, causal=causal)

    y = out.reshape(b, s, n_heads * head_dim) @ p["wo"].to(out.dtype)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    if return_metric:
        return y, new_cache, k.mean(dim=2)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs, embeddings
# ---------------------------------------------------------------------------


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP. The reference's ``jax.nn.gelu`` is the tanh form."""
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table for ``ids`` (int32 or int64) -> [*ids.shape, d]."""
    table = p["table"]
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: x . table^T."""
    return x @ p["table"].to(x.dtype).T
