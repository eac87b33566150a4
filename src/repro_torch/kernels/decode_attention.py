"""Wrapper of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro.kernels.decode_attention.decode_attention`` (Pallas). A CPU
tensor goes to the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises, never falls back. ``launches`` counts kernel launches (one
per call: the split pass and its combine pass).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
CH = 64    # cache positions per tile, as in the .cu
GT = 16    # query heads per block, as in the .cu
TARGET_BLOCKS = 4 * 132  # about four blocks on each of the H100's 132 SMs


@functools.cache
def _fn():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def n_splits(b: int, hq: int, hkv: int, s: int) -> int:
    """Splits of the cache axis: enough blocks to fill the card, from the
    shapes alone, and no more splits than tiles of capacity."""
    blocks_per_split = b * hkv * -(-(hq // hkv) // GT)
    return max(1, min(-(-s // CH), -(-TARGET_BLOCKS // blocks_per_split)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | int) -> torch.Tensor:
    """q [B, Hq, D], k/v cache [B, S, Hkv, D] -> [B, Hq, D] in q's dtype.

    ``lengths``: valid cache length, an int32 tensor [B] on q's device or a
    scalar (int or 0-d tensor) broadcast to [B]; keys at or past it are
    masked, and a length of 0 gives 0."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [B, Hq, D] and [B, S, Hkv, D]")
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (need Hq a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need all float32 or all bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {_HEAD_DIMS}")
    if min(b, hq, s) == 0:
        raise ValueError(f"decode_attention: empty shape q {tuple(q.shape)} k {tuple(k.shape)}")
    if not isinstance(lengths, torch.Tensor) or lengths.dim() == 0:
        lengths = torch.full((b,), int(lengths), dtype=torch.int32, device=q.device)
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention: lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    for t in (q, k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"decode_attention: operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attention: operands must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q/k/v must start on a 16-byte boundary")

    global launches
    nsplit = n_splits(b, hq, hkv, s)
    part_acc = torch.empty((b, hq, nsplit, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, b, hq, nsplit), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                    part_acc.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
                    out.data_ptr(), b, hq, hkv, s, d, nsplit, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
