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
"""
from __future__ import annotations

import ctypes
import functools

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
    are masked. ``causal``: bottom-right aligned causal mask."""
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
