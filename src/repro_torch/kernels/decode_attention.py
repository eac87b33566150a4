"""Wrapper of the Hopper decode-attention kernels.

Replaces ``repro.kernels.decode_attention.decode_attention`` (Pallas). Two
kernels compute it; which one serves a call is a pure function of (dtype,
head dim), ``kernel_for``:

- ``csrc/decode_attention_mma.cu``: bf16 tensor cores (``mma.sync``) with a
  ``cp.async`` K/V ring, bf16 at D 64 and 128 (every LM decode step);
- ``csrc/decode_attention.cu``: CUDA-core f32 math with a ``cp.async`` K/V
  ring, f32 at D 64 and 128 (the f32 parity paths). f32 stays off the
  tensor cores, where it would be TF32.

Both split the cache axis across blocks, spread the valid tiles evenly over
the splits, and combine the partials in a second pass. A CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor launches a kernel or raises,
never falls back. ``launches`` counts launches of both kernels (one per
call: the split pass and its combine pass), ``launches_mma`` those of the
tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

launches = 0
launches_mma = 0

CUDA_CORE = "decode_attention"    # kernel names are their sources' names
MMA = "decode_attention_mma"
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
CH = 64       # cache positions per tile of the tensor-core kernel, as in its .cu
GT = 16       # query heads per block of the tensor-core kernel, as in its .cu
CH_F32 = 32   # cache positions per tile of the CUDA-core kernel, as in its .cu
SMS = 132     # the H100's SMs
MIN_TILES = 4  # tiles of capacity per split, at least


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves a call with q/k/v of ``dtype`` and head dim
    ``d``: ``MMA`` for bf16, ``CUDA_CORE`` for f32. Raises TypeError for
    another dtype and ValueError for another head dim."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode_attention: dtype {dtype}; need float32 or bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {_HEAD_DIMS}")
    return MMA if dtype == torch.bfloat16 else CUDA_CORE


@functools.cache
def _fn(name: str):
    """The C entry ``<name>_fwd``: q, k, v, lengths, part_acc, part_m,
    part_l, out, then B, Hq, Hkv, S, D, nsplit and the stream (each kernel
    serves one dtype)."""
    fn = getattr(_build.load(name), f"{name}_fwd")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def n_splits(b: int, hq: int, hkv: int, s: int, kernel: str) -> int:
    """Splits of the cache axis, from the shapes alone (no host read of the
    lengths): at least ``MIN_TILES`` tiles of capacity per split, so that a
    block walks several tiles and overlaps their loads, and no more blocks
    than about two per SM. A block serves ``GT`` query heads on the
    tensor-core kernel and, on the CUDA-core one, 4 lane groups of 1 to 4
    heads each (its ``heads_per_lane``), the fewest that cover the group up
    to 16; larger groups take several head tiles."""
    g = hq // hkv
    heads = GT if kernel == MMA else 4 * min(4, -(-g // 4))
    blocks_per_split = b * hkv * -(-g // heads)
    tiles = -(-s // (CH if kernel == MMA else CH_F32))
    return max(1, min(-(-tiles // MIN_TILES), 2 * SMS // blocks_per_split))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | int) -> torch.Tensor:
    """q [B, Hq, D], k/v cache [B, S, Hkv, D] -> [B, Hq, D] in q's dtype.

    ``lengths``: valid cache length, an int32 tensor [B] on q's device or a
    scalar (int or 0-d tensor) broadcast to [B]; keys at or past it are
    masked, and a length of 0 gives 0. It has no backward: with grad mode on
    and q, k or v requiring grad it raises, on any device (decoding never
    trains; ``flash_attention`` is the differentiable path)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no backward: call it under "
                           "torch.no_grad() or on tensors that do not require grad")
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
    kernel = kernel_for(q.dtype, d)
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

    global launches, launches_mma
    nsplit = n_splits(b, hq, hkv, s, kernel)
    rows = b * hq * nsplit
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    acc_ptr = part.data_ptr()  # part_acc [rows, D], then part_m [rows], part_l [rows]
    m_ptr = acc_ptr + rows * d * 4
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                          acc_ptr, m_ptr, m_ptr + rows * 4, out.data_ptr(),
                          b, hq, hkv, s, d, nsplit, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    launches += 1
    if kernel == MMA:
        launches_mma += 1
    return out
