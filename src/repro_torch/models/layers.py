"""Model building blocks in PyTorch (counterpart of ``repro.models.layers``).

Plain functions on tensors and nested dicts of parameters, in the
reference's layout: weights are ``[d_in, d_out]`` masters cast to the
activation dtype at use. Norm and RoPE math is f32 whatever the activation
dtype. Attention goes through ``kernels.ops``: ``flash_attention`` for
self-attention and prefill, ``decode_attention`` for a cached decode step;
the Hopper kernels on a CUDA tensor, their plain versions on a CPU tensor.
The reference's ``chunked_sdpa`` has no counterpart: the flash kernel is it.
"""
from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models.param import ParamSpec
from repro_torch.sharding.rules import (BATCH_AXES, hold_grad_placements, local_part, place,
                                        redistribute, replicated, run_local)

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


def _product(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)``, w [d_in, d_out]. On DTensors split over more than
    one rank the placements are decided here, as GSPMD propagates the
    reference's: the activation keeps its split and the weight follows it,
    mesh dim by mesh dim of size > 1.

    - x split on a row dim (batch, tokens): the weight whole there.
    - x split on d_in: the weight split on d_in (row-parallel).
    - x whole, on a batch axis ("pod", "data"): the weight whole there (a
      weight split over a batch axis is stored split: ZeRO-3 gathers it).
    - x whole, on another axis: a weight split on d_in splits x's d_in too
      (row-parallel), one split on d_out stays (column-parallel).

    A pending sum (``Partial``) is reduced where it is made: x's before the
    product, the row-parallel product's before the bias, and under autograd
    x's gradient, which a column-parallel weight makes one, at x. Left to
    DTensor, operands that disagree are reconciled at the least cost of its
    model, which prefers splitting mesh dims the rules left replicated (a
    batch replicated by the divisibility fallback has its tokens split over
    "pod" and "data"), and the matmul's view back to [B, S, d] then fails.
    On a mesh of one rank nothing can be split, and DTensor's placements
    are kept (deciding them there doubled a product's host time)."""
    mesh = next((t.device_mesh for t in (x, w) if isinstance(t, DTensor)), None)
    split = [] if mesh is None else [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    if not split:
        y = x @ w.to(x.dtype)
        return y if b is None else y + b.to(y.dtype)
    x = _sums_reduced(x)
    xp = list(x.placements) if isinstance(x, DTensor) else [Replicate()] * mesh.ndim
    wp = list(w.placements) if isinstance(w, DTensor) else [Replicate()] * mesh.ndim
    last, column = x.ndim - 1, False
    for i in split:
        if isinstance(xp[i], Shard):
            wp[i] = Shard(0) if xp[i].dim == last else Replicate()
        elif mesh.mesh_dim_names[i] in BATCH_AXES:
            wp[i] = Replicate()
        elif isinstance(wp[i], Shard):
            if wp[i].dim == 0:
                xp[i] = Shard(last)
            else:
                column = True
    if column:
        x = hold_grad_placements(x)
    x = _placed(x, mesh, xp)
    y = _sums_reduced(x @ _placed(w, mesh, wp).to(x.dtype))
    if b is None:
        return y
    bp = [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
          for p in y.placements]
    return y + _placed(b, mesh, bp).to(y.dtype)


def _placed(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` in ``placements`` (a plain tensor is the global value)."""
    if not isinstance(t, DTensor):
        return place(t, mesh, placements)
    return redistribute(t, placements)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _product(x, p["w"], p.get("b"))


def _normalized(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last axis, in f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 math and eps 1e-6, as the reference (torch's default is 1e-5)."""
    y = _normalized(x, eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layernorm_noparam(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layernorm without scale or bias (the diffusion blocks' adaLN input),
    f32 math and eps 1e-6, as the reference."""
    return _normalized(x, eps).to(x.dtype)


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


def _sums_reduced(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` with every pending sum (``Partial``) reduced;
    anything else as it is."""
    if not isinstance(t, DTensor) or not any(isinstance(p, Partial) for p in t.placements):
        return t
    return redistribute(t, [Replicate() if isinstance(p, Partial) else p for p in t.placements])


def _gathered(t: torch.Tensor, dim: int, n: int = 1) -> torch.Tensor:
    """A DTensor ``t`` replicated on every mesh dim that splits its ``dim``
    into parts ``n`` does not divide by (``n`` = 1: every split); anything
    else as it is. ``n`` heads: where the weight divides and the heads do
    not, XLA splits inside a head for the reference, and DTensor cannot view
    such a split as [..., n, head_dim]."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    dim %= t.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim and n % mesh.size(i) else p
            for i, p in enumerate(t.placements)]
    return t if want == list(t.placements) else redistribute(t, want)


def _proj(p: dict, name: str, x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    y = _product(x, p[f"w{name}"], p.get(f"b{name}"))
    return _gathered(y, -1, n).reshape(*y.shape[:-1], n, head_dim)


def _qkv_proj(p: dict, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    """q [B, S, Hq, D], k, v [B, S, Hkv, D]: one fused matmul when 'wqkv' is
    present (MHA only)."""
    if "wqkv" not in p:
        return (_proj(p, "q", x, n_heads, head_dim),
                _proj(p, "k", x, n_kv, head_dim),
                _proj(p, "v", x, n_kv, head_dim))
    y = _product(x, p["wqkv"], p.get("bqkv"))
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
    stated in f32.

    The kernel runs whole sequences and whole heads: a DTensor operand that
    holds a pending sum, or is split on its sequence dim (DTensor's
    propagation splits a replicated token dim where the batch cannot be, as
    at B=1), or on its heads into parts that are not whole, is reduced and
    gathered first, as GSPMD does for the reference."""
    q, k, v = (_gathered(_gathered(_sums_reduced(t), 1), 2, t.shape[2]) for t in (q, k, v))
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=2) for t in (k, v))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    if bias is not None:
        bias = bias.float().contiguous()
    out = ops.flash_attention(*heads, bias=bias, causal=causal)
    return out.transpose(1, 2)


def _quantize(t: torch.Tensor, scale: float | None, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a cache entry: cast to ``dtype``, or int8 steps of ``scale``
    (round half to even, as ``jnp.round``) when a scale is set."""
    if scale is None:
        return t.to(dtype)
    return torch.clamp(torch.round(t.float() / scale), -127, 127).to(torch.int8)


def _dequantize(cache: torch.Tensor, scale: float | None, dtype: torch.dtype) -> torch.Tensor:
    if scale is None:
        return cache.to(dtype)
    return (cache.float() * scale).to(dtype)


def _local_range(t: DTensor, dim: int) -> tuple[int, int]:
    """(first global index, count) of ``dim`` held by this rank: each mesh
    dim sharding it splits what the ones before left, as ``torch.chunk``."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    first, n = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-n // mesh.size(i))
            at = min(coord[i] * chunk, n)
            first, n = first + at, min(chunk, n - at)
    return first, n


def cache_write(cache: torch.Tensor, value: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + S] = value`` in place, for a cache [B, S_max,
    n_kv, hd] and a value [B, S, n_kv, hd]. On a DTensor cache the write runs
    on this rank's local tensors (the value brought to the cache's
    placements), so it lands in the cache's own storage. Where the cache's
    sequence dim is split (the rules' ``act_seq_kv``), the value comes whole
    on that dim and each rank writes the part that falls in its own slots."""
    if isinstance(cache, DTensor):
        mesh = cache.device_mesh
        seq = [mesh.size(i) > 1 and isinstance(p, Shard) and p.dim == 1
               for i, p in enumerate(cache.placements)]
        want = [Replicate() if s else p for s, p in zip(seq, cache.placements)]
        value = local_part(value, mesh, want)
        if any(seq):
            first, n = _local_range(cache, 1)
            lo, hi = max(start, first), min(start + value.shape[1], first + n)
            if lo < hi:
                cache.to_local()[:, lo - first:hi - first] = value[:, lo - start:hi - start]
            return
        cache = cache.to_local()
    cache[:, start:start + value.shape[1]] = value


def attention(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
              causal: bool = False, rope: bool = False, rope_theta: float = 10000.0,
              bias: torch.Tensor | None = None, return_metric: bool = False,
              kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_index: int | None = None, kv_len: torch.Tensor | None = None,
              cache_quant_scale: float | None = None, return_kv: bool = False):
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

    ``cache_quant_scale`` (int8 KV cache, as the reference): the cache holds
    ``clip(round(k / scale), -127, 127)`` as int8. Prefill attends over the
    unquantized k/v and returns them quantized; decode writes the quantized
    k/v, then attends over the whole cache dequantized to the activation
    dtype (``cache.float() * scale``).
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
        cache_write(k_cache, _quantize(k[:, 0], cache_quant_scale, k_cache.dtype)[:, None], idx)
        cache_write(v_cache, _quantize(v[:, 0], cache_quant_scale, v_cache.dtype)[:, None], idx)
        new_cache = (k_cache, v_cache)
        if kv_len is None:
            kv_len = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
        # the decode kernel reads a whole cache axis: a split one is gathered
        kc, vc = (_dequantize(_gathered(c, 1), cache_quant_scale, q.dtype)
                  for c in (k_cache, v_cache))
        # a rank's query heads must read its own kv heads: where the kv heads
        # do not divide by a mesh dim splitting the query heads, gather those
        out = ops.decode_attention(_gathered(q[:, 0], 1, n_kv), kc, vc, kv_len)
        if return_metric:
            k = kc
    else:
        if return_kv:
            new_cache = tuple(_quantize(t, cache_quant_scale, t.dtype) for t in (k, v))
        out = sdpa(q, k, v, bias=bias, causal=causal)

    # the gradient of the heads' output must come back in whole heads
    y = _product(hold_grad_placements(out.reshape(b, s, n_heads * head_dim)), p["wo"],
                 p.get("bo"))
    if return_metric:
        return y, new_cache, k.mean(dim=2)
    return y, new_cache


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``enabled`` and grad mode is on: the reference's ``jax.checkpoint``
    around a scanned block (``cfg.remat``). The block's activations are
    dropped after its forward and recomputed in the backward, so a block
    runs its forward, attention kernel included, twice per training step.
    The recompute runs in a copy of the forward's context variables
    (``ops.plain_versions``): on the card autograd recomputes on its own
    thread, which would otherwise see the defaults and run the kernels where
    the forward ran the plain versions. Without grad, or when no tensor
    argument requires grad (serving), it is a plain call."""
    if enabled and torch.is_grad_enabled() and any(
            t.requires_grad for a in args
            for t in (a.values() if isinstance(a, dict) else [a])
            if isinstance(t, torch.Tensor)):
        ctx = contextvars.copy_context()
        return torch.utils.checkpoint.checkpoint(ctx.run, fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# MLPs, embeddings
# ---------------------------------------------------------------------------


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP. The reference's ``jax.nn.gelu`` is the tanh form."""
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table for ``ids`` (int32 or int64) -> [*ids.shape, d].
    On DTensors behind the local boundary: the table gathered whole (its
    vocab and embed dims), the ids split by batch. DTensor's own lookup
    fails under autograd on a sharded table: its ``index_select`` backward
    in torch 2.11, its masked ``embedding`` on a 2-D mesh in 2.13."""
    table = p["table"]
    if isinstance(table, DTensor):
        table = replicated(table)
    roles = ("batch",) + (None,) * (ids.dim() - 1)

    def lookup(t, i):
        return torch.index_select(t, 0, i.reshape(-1)).reshape(*i.shape, t.shape[1])
    return run_local("embed", lookup, (table, ids), ((None, None), roles), roles + (None,))


def take_labels(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``x[..., labels]`` row by row: x [..., V], integer labels [...]. On a
    DTensor a masked sum rather than a gather, so that it runs on logits
    sharded on the vocab dim (each rank sums its own slice; the value is
    exact, one term and zeros); on a plain tensor the gather."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, labels.long()[..., None])[..., 0]
    hit = torch.arange(x.shape[-1], device=labels.device) == labels[..., None].long()
    return torch.sum(torch.where(hit, x, 0.0), dim=-1)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: x . table^T."""
    return x @ p["table"].to(x.dtype).T


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of t [B] (float, in [0, 1000]) -> [B, dim] f32:
    ``cos(t * freqs) || sin(t * freqs)`` with ``freqs = exp(-log(max_period)
    * i / half)``, as the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
