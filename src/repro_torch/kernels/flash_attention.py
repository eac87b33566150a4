"""Wrapper of the Hopper flash-attention kernels.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas). Two
kernels compute it; which one serves a call is a pure function of (dtype,
head dim), ``kernel_for``:

- ``csrc/flash_attention_mma.cu``: bf16 tensor cores (``mma.sync``), bf16 at
  D 64 and 128 (the ViT blocks and the LM prefill);
- ``csrc/flash_attention.cu``: CUDA-core f32 math, f32 at every head dim and
  bf16 at D 16 and 32. f32 stays off the tensor cores, where it would be TF32.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
a kernel or raises, never falls back. ``launches`` counts launches of both
kernels, ``launches_mma`` those of the tensor-core kernel.

Gradient: when grad mode is on and q, k, v or the bias requires grad, the
call goes through ``_FlashAttention``, a ``torch.autograd.Function`` whose
forward is the same kernel (or, on a CPU tensor, the same plain version)
and whose ``backward`` is explicit PyTorch on both devices. The reference
has no backward kernel: its models train through the jnp ``layers.sdpa``,
which XLA differentiates outside any Pallas kernel, so plain products are
the counterpart here. ``backward`` recomputes the f32 scores from q and k
(bf16 operands, exact in f32, f32 products), takes the f32 softmax P, then
``dP = dO V^T`` (an f32 product), ``dS = P * (dP - rowsum(dO * O))``,
``dV = P^T dO``, ``dQ = dS K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``; P and
dS are rounded to q's dtype before the products that give dV, dQ and dK, as
FlashAttention-2's backward does (with f32 inputs everything is f32).
Fully masked rows, which output 0, get zero gradient. Its time is
quadratic f32 passes over ``[B, H, Sq, Sk]``; a backward kernel is queued
(ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, ref

launches = 0
launches_mma = 0

CUDA_CORE = "flash_attention"    # kernel names are their sources' names
MMA = "flash_attention_mma"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MMA_HEAD_DIMS = (64, 128)


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves a call with q/k/v of ``dtype`` and head dim
    ``d``: ``MMA`` for bf16 at D 64 and 128, else ``CUDA_CORE``. Raises
    TypeError for another dtype and ValueError for another head dim."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype}; need float32 or bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    return MMA if dtype == torch.bfloat16 and d in _MMA_HEAD_DIMS else CUDA_CORE


@functools.cache
def _fn(name: str):
    """The C entry ``<name>_fwd``: q, k, v, bias, kv_len, out, then B, H, Sq,
    Sk, D, the dtype code (the CUDA-core kernel only; the tensor-core one is
    bf16 only), causal and the stream."""
    fn = getattr(_build.load(name), f"{name}_fwd")
    n_ints = 7 if name == CUDA_CORE else 6
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: torch.Tensor | None = None,
                    kv_len: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v [B, H, S, D] (equal head counts) -> [B, H, Sq, D] in q's dtype.

    ``bias`` [B, Sk] f32: additive per-key logit term (ToMe proportional
    attention, -inf on bucket pads). ``kv_len`` [B] int32: keys at or past it
    are masked. ``causal``: bottom-right aligned causal mask. Differentiable
    in q, k, v and the bias (see the module's docstring)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, kv_len, causal)
    return _forward(q, k, v, bias, kv_len, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kv_len, causal):
        out = _forward(q, k, v, bias, kv_len, causal)
        ctx.save_for_backward(q, k, v, out, bias, kv_len)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, bias, kv_len = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = backward(q, k, v, out, dout, bias=bias, kv_len=kv_len,
                                     causal=ctx.causal, need_bias=need_bias)
        return dq, dk, dv, dbias, None, None


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             dout: torch.Tensor, *, bias: torch.Tensor | None = None,
             kv_len: torch.Tensor | None = None, causal: bool = False,
             need_bias: bool = False):
    """(dq, dk, dv, dbias) of ``flash_attention`` at (q, k, v, bias) with
    output ``out`` and its gradient ``dout``; ``dbias`` [B, Sk] f32 when
    ``need_bias``, else None. Plain PyTorch on any device (the module's
    docstring gives the arithmetic); the masks are the forward's. The
    quadratic tensors are few passes: the scale rides on the S product,
    ``dP - rowsum(dO * O)`` is one product with a broadcast addend, and
    ``P * (dP - D)`` is written straight in q's dtype when no f32 dS is
    needed (bf16 without a bias gradient)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
    do3 = dout.reshape(b * h, sq, d)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = torch.baddbmm(zero, q3.float(), k3.float().transpose(1, 2), beta=0.0, alpha=scale)
    s = s.view(b, h, sq, sk)
    if bias is not None:
        s.add_(bias.float().clamp_min(ref.NEG)[:, None, None, :])
    mask = None
    kpos = torch.arange(sk, device=q.device)
    if kv_len is not None:
        mask = (kpos[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
    if causal:
        qpos = torch.arange(sq, device=q.device)
        cmask = qpos[:, None] + (sk - sq) >= kpos[None, :]
        mask = cmask if mask is None else mask & cmask
    if mask is not None:
        s.masked_fill_(~mask, ref.NEG)
    p = torch.softmax(s, dim=-1)
    if mask is not None or bias is not None:  # rows with no unmasked key output 0
        p.mul_(s.amax(dim=-1, keepdim=True) > 0.5 * ref.NEG)
    del s
    p = p.view(b * h, sq, sk)
    dv = torch.bmm(p.to(q.dtype).transpose(1, 2), do3.to(q.dtype))
    rowsum = (dout.float() * out.float()).sum(dim=-1).reshape(b * h, sq, 1)
    ds = torch.baddbmm(rowsum, do3.float(), v3.float().transpose(1, 2), beta=-1.0)
    dbias = None
    if q.dtype == torch.float32 or need_bias:
        ds.mul_(p)
        if need_bias:
            dbias = ds.view(b, h, sq, sk).sum(dim=(1, 2)) * (bias.float() >= ref.NEG)
        ds_lp = ds.to(q.dtype)
    else:
        ds_lp = torch.mul(ds, p, out=torch.empty_like(ds, dtype=q.dtype))
    del ds, p
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    dq = torch.baddbmm(zero, ds_lp, k3, beta=0.0, alpha=scale)
    dk = torch.baddbmm(zero, ds_lp.transpose(1, 2), q3, beta=0.0, alpha=scale)
    return (dq.view(b, h, sq, d), dk.view(b, h, sk, d), dv.to(v.dtype).view(b, h, sk, d),
            dbias)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: torch.Tensor | None, kv_len: torch.Tensor | None,
             causal: bool) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [B, H, S, D] with k, v alike")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    kernel = kernel_for(q.dtype, d)
    if min(b, h, sq, sk) == 0:
        raise ValueError(f"flash_attention: empty shape q {tuple(q.shape)} k {tuple(k.shape)}")
    tensors = [q, k, v]
    if bias is not None:
        if bias.shape != (b, sk) or bias.dtype != torch.float32:
            raise ValueError(f"flash_attention: bias must be float32 [{b}, {sk}], got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if kv_len is not None:
        if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
            raise ValueError(f"flash_attention: kv_len must be int32 [{b}], got "
                             f"{kv_len.dtype} {tuple(kv_len.shape)}")
        tensors.append(kv_len)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_attention: operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous")
    if kernel == MMA and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q/k/v must start on a 16-byte boundary")

    global launches, launches_mma
    out = torch.empty_like(q)
    dtype = [] if kernel == MMA else [_DTYPES[q.dtype]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          None if bias is None else bias.data_ptr(),
                          None if kv_len is None else kv_len.data_ptr(),
                          out.data_ptr(), b, h, sq, sk, d, *dtype, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    launches += 1
    if kernel == MMA:
        launches_mma += 1
    return out
