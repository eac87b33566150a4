"""ViT building blocks in PyTorch (the ViT subset of ``repro.models.layers``).

Plain functions on tensors and nested dicts of parameters, in the
reference's layout: weights are ``[d_in, d_out]`` f32 masters cast to the
activation dtype at use. Norm math is f32 whatever the activation dtype.
Attention goes through ``kernels.ops.flash_attention``: the Hopper kernel on
a CUDA tensor, its plain version on a CPU tensor.
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


def attention_specs(d_model: int, n_heads: int, head_dim: int, *,
                    bias: bool = True, fused_qkv: bool = False) -> dict:
    """Multi-head attention (the ViT case: as many kv heads as q heads)."""
    hd = n_heads * head_dim
    if fused_qkv:
        p = {"wqkv": ParamSpec((d_model, 3 * hd), ("embed", "heads"), init="fan_in"),
             "wo": ParamSpec((hd, d_model), ("heads", "embed"), init="fan_in")}
        if bias:
            p["bqkv"] = ParamSpec((3 * hd,), ("heads",), init="zeros")
            p["bo"] = ParamSpec((d_model,), ("embed",), init="zeros")
        return p
    p = {"wq": ParamSpec((d_model, hd), ("embed", "heads"), init="fan_in"),
         "wk": ParamSpec((d_model, hd), ("embed", "kv"), init="fan_in"),
         "wv": ParamSpec((d_model, hd), ("embed", "kv"), init="fan_in"),
         "wo": ParamSpec((hd, d_model), ("heads", "embed"), init="fan_in")}
    if bias:
        p["bq"] = ParamSpec((hd,), ("heads",), init="zeros")
        p["bk"] = ParamSpec((hd,), ("kv",), init="zeros")
        p["bv"] = ParamSpec((hd,), ("kv",), init="zeros")
        p["bo"] = ParamSpec((d_model,), ("embed",), init="zeros")
    return p


def mlp_specs(d_model: int, d_ff: int, *, bias: bool = True) -> dict:
    return {"fc1": linear_specs(d_model, d_ff, axes=("embed", "mlp"), bias=bias),
            "fc2": linear_specs(d_ff, d_model, axes=("mlp", "embed"), bias=bias)}


# ---------------------------------------------------------------------------
# apply
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


def _proj(p: dict, name: str, x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    y = x @ p[f"w{name}"].to(x.dtype)
    if f"b{name}" in p:
        y = y + p[f"b{name}"].to(y.dtype)
    return y.reshape(*y.shape[:-1], n, head_dim)


def _qkv_proj(p: dict, x: torch.Tensor, n_heads: int, head_dim: int):
    """q, k, v [B, S, H, D]: one fused matmul when 'wqkv' is present."""
    if "wqkv" not in p:
        return (_proj(p, "q", x, n_heads, head_dim),
                _proj(p, "k", x, n_heads, head_dim),
                _proj(p, "v", x, n_heads, head_dim))
    y = x @ p["wqkv"].to(x.dtype)
    if "bqkv" in p:
        y = y + p["bqkv"].to(y.dtype)
    q, k, v = y.chunk(3, dim=-1)
    return tuple(t.reshape(*t.shape[:-1], n_heads, head_dim) for t in (q, k, v))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention, q/k/v [B, S, H, D] -> [B, Sq, H, D].

    ``bias`` [B, Sk] is additive on the key axis (ToMe proportional-attention
    log sizes, -inf on bucket pads). Scores and softmax are f32 throughout, as
    the reference's flash kernel: the reference's jnp ``sdpa`` instead rounds
    scores and softmax weights to the activation dtype, so parity with it is
    stated in f32."""
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    if bias is not None:
        bias = bias.float().contiguous()
    out = ops.flash_attention(*heads, bias=bias)
    return out.transpose(1, 2)


def attention(p: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
              bias: torch.Tensor | None = None, return_metric: bool = False):
    """Self-attention over ``x`` [B, S, d]. With ``return_metric`` also returns
    the ToMe metric, the mean of the keys over heads [B, S, head_dim]."""
    b, s, _ = x.shape
    q, k, v = _qkv_proj(p, x, n_heads, head_dim)
    out = sdpa(q, k, v, bias=bias).reshape(b, s, n_heads * head_dim)
    y = out @ p["wo"].to(out.dtype)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    if return_metric:
        return y, k.mean(dim=2)
    return y


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP. The reference's ``jax.nn.gelu`` is the tanh form."""
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))
