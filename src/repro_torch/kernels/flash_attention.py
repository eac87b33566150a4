"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas). A CPU
tensor goes to the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises, never falls back. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
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

    global launches
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    None if kv_len is None else kv_len.data_ptr(),
                    out.data_ptr(), b, h, sq, sk, d, _DTYPES[q.dtype],
                    int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
