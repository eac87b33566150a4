"""Wrapper of the Hopper flash-attention kernels and of their gradient.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas). Two
kernels compute it; which one serves a call is a pure function of (dtype,
head dim), ``kernel_for``:

- ``csrc/flash_attention_mma.cu``: bf16 tensor cores (``wgmma`` for every
  product, K/V tiles by TMA from a producer warp into an ``mbarrier`` ring,
  one or two consumer warpgroups of 64 query rows), bf16 at D 64 and 128
  (the ViT blocks, the LM prefill, dit and flux, the training forward);
- ``csrc/flash_attention.cu``: 3xTF32 tensor cores (``mma.sync`` m16n8k8,
  each f32 operand split into two TF32 terms, which keeps f32 accuracy), f32
  at every head dim and bf16 at D 16 and 32.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
a kernel or raises, never falls back. ``launches`` counts launches of both
kernels, ``launches_mma`` those of the tensor-core kernel.

Gradient: when grad mode is on and q, k, v or the bias requires grad, the
call goes through ``_FlashAttention``, a ``torch.autograd.Function`` whose
forward is the same kernel (which then also writes each row's log-sum-exp)
and whose backward is ``backward``, a dispatcher like the forward's: on a
CUDA tensor the backward kernel of the forward's route,
``csrc/flash_attention_mma_bwd.cu`` (bf16 at D 64/128: ``wgmma`` for every
product, TMA loads from a producer warp into an ``mbarrier`` ring, two
consumer warpgroups of 64 rows) or ``csrc/flash_attention_bwd.cu`` (3xTF32
tensor cores, the rest); on a CPU tensor the plain
``ref.flash_attention_bwd_ref``. ``launches_bwd`` counts
backward calls on both kernels (each call is two launches: the dQ pass,
then the dK/dV pass), ``launches_bwd_mma`` those on the tensor-core one.
The reference has no backward kernel: its models train through the jnp
``layers.sdpa``, which XLA differentiates; the port computes the same
gradient. Both routes share the plain version's arithmetic: the f32 scores
are recomputed from q and k (exact products of the inputs), P is the f32
softmax (the kernels take it as ``exp(s - lse)`` with the forward's
log-sum-exp), ``dP = dO V^T`` in f32, ``dS = P * (dP - rowsum(dO * O))``,
``dV = P^T dO``, ``dQ = dS K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``; P
and dS are rounded to q's dtype before the products that give dV, dQ and dK,
as FlashAttention-2's backward does (with f32 inputs everything is f32).
Fully masked rows, which output 0, get zero gradient, and keys that no query
sees get dK = dV = 0. The kernels sum without atomics, so a gradient is the
same bit for bit from run to run.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.runtime import hlo_bytes

launches = 0
launches_mma = 0
launches_bwd = 0
launches_bwd_mma = 0

CUDA_CORE = "flash_attention"    # kernel names are their sources' names
MMA = "flash_attention_mma"
BWD = {CUDA_CORE: "flash_attention_bwd", MMA: "flash_attention_mma_bwd"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MMA_HEAD_DIMS = (64, 128)


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves a call with q/k/v of ``dtype`` and head dim
    ``d``: ``MMA`` for bf16 at D 64 and 128, else ``CUDA_CORE``. Raises
    TypeError for another dtype and ValueError for another head dim. Its
    gradient runs on ``BWD[kernel_for(dtype, d)]``."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype}; need float32 or bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    return MMA if dtype == torch.bfloat16 and d in _MMA_HEAD_DIMS else CUDA_CORE


@functools.cache
def _fn(name: str):
    """The C entry ``<name>_fwd``: q, k, v, bias, kv_len, out, lse, then B, H,
    Sq, Sk, D, the dtype code (the ``CUDA_CORE`` route's kernel only; the bf16
    tensor-core one is bf16 only), causal and the stream."""
    fn = getattr(_build.load(name), f"{name}_fwd")
    n_ints = 7 if name == CUDA_CORE else 6
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn(name: str):
    """The C entry of backward kernel ``name`` (``BWD``'s values): q, k, v,
    out, dout, lse, bias, kv_len, dq, dk, dv, the per-head dbias sums, the
    rowsum(dO * O) scratch, then B, H, Sq, Sk, D, the dtype code (the
    ``CUDA_CORE`` route's kernel only), causal and the stream."""
    fn = getattr(_build.load(name), name)
    n_ints = 7 if name == BWD[CUDA_CORE] else 6
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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
        out, lse = _forward(q, k, v, bias, kv_len, causal, True)
        ctx.save_for_backward(q, k, v, out, bias, kv_len, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import ops  # ops imports this module

        q, k, v, out, bias, kv_len, lse = ctx.saved_tensors
        need_bias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = hlo_bytes.kernel(
            "flash_attention_bwd",
            lambda: ops.flash_bwd_cost(q, k, v, bias, kv_len, ctx.causal, need_bias),
            lambda: backward(q, k, v, out, dout, bias=bias, kv_len=kv_len, causal=ctx.causal,
                             need_bias=need_bias, lse=lse))
        return dq, dk, dv, dbias, None, None


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             dout: torch.Tensor, *, bias: torch.Tensor | None = None,
             kv_len: torch.Tensor | None = None, causal: bool = False,
             need_bias: bool = False, lse: torch.Tensor | None = None):
    """(dq, dk, dv, dbias) of ``flash_attention`` at (q, k, v, bias) with
    output ``out``, its gradient ``dout`` and, on a CUDA tensor, the
    forward's log-sum-exp ``lse`` [B, H, Sq] f32; ``dbias`` [B, Sk] f32 when
    ``need_bias``, else None. On a CUDA tensor the backward kernel of the
    forward's route (``BWD[kernel_for(dtype, D)]``), on a CPU tensor the
    plain ``ref.flash_attention_bwd_ref``; anything else raises."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, bias=bias, kv_len=kv_len,
                                           causal=causal, need_bias=need_bias)
    kernel = _checked(q, k, v, bias, kv_len)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        want = (b, h, sq) if name == "lse" else q.shape
        if t is None or t.shape != want or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be {dtype} "
                             f"{tuple(want)} on {q.device}, got "
                             + ("None" if t is None else f"{t.dtype} {tuple(t.shape)} "
                                                         f"on {t.device}"))
    if need_bias and bias is None:
        raise ValueError("flash_attention backward: need_bias without a bias")
    # the gradient autograd hands over may be a strided or offset view: the
    # kernels read rows of 16 bytes
    out, dout = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format) for t in (out, dout))
    lse = lse.contiguous()

    global launches_bwd, launches_bwd_mma
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((b, h, sk), dtype=torch.float32, device=q.device) if need_bias
            else None)
    name = BWD[kernel]
    dtype = [] if kernel == MMA else [_DTYPES[q.dtype]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), None if bias is None else bias.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if part is None else part.data_ptr(), rowsum.data_ptr(),
            b, h, sq, sk, d, *dtype, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches_bwd += 1
    if kernel == MMA:
        launches_bwd_mma += 1
    dbias = None
    if need_bias:  # the kernel's per-head sums of the f32 dS; zero where clamped
        dbias = part.sum(dim=1) * (bias >= ref.NEG)
    return dq, dk, dv, dbias


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: torch.Tensor | None, kv_len: torch.Tensor | None) -> str:
    """The kernel that serves these operands on a CUDA device; raises on an
    operand the kernels do not take."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # both kernels copy 16-byte pieces
        raise ValueError("flash_attention: q/k/v must start on a 16-byte boundary")
    return kernel


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: torch.Tensor | None, kv_len: torch.Tensor | None,
             causal: bool, with_lse: bool = False):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor. With
    ``with_lse``, (out, lse): the kernel also writes each row's log-sum-exp
    [B, H, Sq] f32 for the backward (None on a CPU tensor, whose backward is
    the plain version)."""
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
        return (out, None) if with_lse else out
    kernel = _checked(q, k, v, bias, kv_len)
    b, h, sq, d = q.shape

    global launches, launches_mma
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    dtype = [] if kernel == MMA else [_DTYPES[q.dtype]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          None if bias is None else bias.data_ptr(),
                          None if kv_len is None else kv_len.data_ptr(),
                          out.data_ptr(), None if lse is None else lse.data_ptr(),
                          b, h, sq, k.shape[2], d, *dtype, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    launches += 1
    if kernel == MMA:
        launches_mma += 1
    return (out, lse) if with_lse else out
