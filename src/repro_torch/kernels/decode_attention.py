"""Wrapper of the Hopper decode-attention kernels.

Replaces ``repro.kernels.decode_attention.decode_attention`` (Pallas). Two
kernels compute it; which one serves a call is a pure function of (dtype,
head dim), ``kernel_for``:

- ``csrc/decode_attention_mma.cu``: bf16 tensor cores (``mma.sync``), K/V
  tiles by TMA into an mbarrier ring, the splits combined in the same launch
  (a cluster's over distributed shared memory; a long cache's clusters by
  the last block to finish), bf16 at D 64 and 128 (every LM decode step);
- ``csrc/decode_attention.cu``: CUDA-core f32 math with a ``cp.async`` K/V
  ring and a combine pass, f32 at D 64 and 128 (the f32 parity paths). f32
  stays off the tensor cores, where it would be TF32.

Both split the cache axis across blocks and spread the valid tiles evenly
over the splits. A CPU tensor goes to the plain version in ``ref.py``; a
CUDA tensor launches a kernel or raises, never falls back. ``launches``
counts calls of both kernels (the f32 one's split pass and combine pass are
one call), ``launches_mma`` those of the tensor-core kernel, one launch a
call.

The tensor-core kernel reads the cache through TMA tensor maps, encoded on
the host; a decode step reads the same cache buffers every step, so the
encoded maps are kept by (device, pointers, shape, strides) (``_MAPS``), and
the counters a long cache's last blocks use are allocated once per device
and stream (``_COUNTERS``) and left zero by every launch.
"""
from __future__ import annotations

import collections
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
MAX_CLUSTER = 8  # splits a cluster of the tensor-core kernel at most, as in its .cu
CH_F32 = 32   # cache positions per tile of the CUDA-core kernel, as in its .cu
SMS = 132     # the H100's SMs
MIN_TILES = 4  # tiles of capacity per split on the CUDA-core kernel, at least
MIN_SPLIT_ELEMS = 8 * CH * 128  # positions x head dim of capacity per split on the tensor-core one
_MAPS: collections.OrderedDict = collections.OrderedDict()  # encoded K/V maps, newest last
_MAPS_KEPT = 256
_COUNTERS: dict = {}  # (device index, stream) -> uint32 split counters, all zero


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
    """The C entry ``<name>_fwd``. The CUDA-core kernel's: q, k, v, lengths,
    part_acc, part_m, part_l, out, then B, Hq, Hkv, S, D, nsplit and the
    stream. The tensor-core kernel's: q, k, v, the K/V maps, lengths,
    part_acc, part_m, part_l, the split counters, out, then the same ints
    and the stream."""
    fn = getattr(_build.load(name), f"{name}_fwd")
    n_ptrs = 10 if name == MMA else 8
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _maps_fn():
    """``decode_attention_mma_maps``: k, v, B, S, Hkv, D, the 256-byte host
    buffer the two encoded tensor maps go into."""
    fn = _build.load(MMA).decode_attention_mma_maps
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kv_maps(k: torch.Tensor, v: torch.Tensor):
    """The K/V caches' encoded tensor maps, encoded on a first call with
    these buffers, shape and strides, then reused."""
    key = (k.device.index, k.data_ptr(), v.data_ptr(), tuple(k.shape), k.stride())
    maps = _MAPS.get(key)
    if maps is not None:
        _MAPS.move_to_end(key)
        return maps
    maps = ctypes.create_string_buffer(256)
    b, s, hkv, d = k.shape
    err = _maps_fn()(k.data_ptr(), v.data_ptr(), b, s, hkv, d, maps)
    if err != 0:
        raise RuntimeError(f"{MMA}: tensor maps did not encode: error {err}")
    _MAPS[key] = maps
    if len(_MAPS) > _MAPS_KEPT:
        _MAPS.popitem(last=False)
    return maps


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """``n`` zero split counters for launches on ``stream``: allocated once
    (grown when a call needs more), left zero by every launch."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


def n_splits(b: int, hq: int, hkv: int, s: int, d: int, kernel: str) -> int:
    """Splits of the cache axis, from the shapes alone (no host read of the
    lengths). A block serves ``GT`` query heads on the tensor-core kernel
    and, on the CUDA-core one, 4 lane groups of 1 to 4 heads each (its
    ``heads_per_lane``), the fewest that cover the group up to 16; larger
    groups take several head tiles.

    CUDA-core kernel: at least ``MIN_TILES`` tiles of capacity per split, so
    that a block walks several tiles and overlaps their loads, and up to
    about two blocks an SM. Tensor-core kernel: its splits run as clusters
    of up to ``MAX_CLUSTER`` that combine over distributed shared memory, so
    the count is a power of two, with at least ``MIN_SPLIT_ELEMS`` / D
    positions of capacity per split (8 tiles at D=128: a block's share
    amortises the cluster's launch and combine) and up to one block an SM
    (on the H100, tools/decode_mma_ablations.py: 4 splits beat 8 at
    starcoder2-3b's decode step, and grids of two blocks an SM, 8 splits at
    qwen3-moe's and 4 at granite-moe's, ran 1.5x the time of half as many)."""
    g = hq // hkv
    heads = GT if kernel == MMA else 4 * min(4, -(-g // 4))
    blocks_per_split = b * hkv * -(-g // heads)
    if kernel != MMA:
        tiles = -(-s // CH_F32)
        return max(1, min(-(-tiles // MIN_TILES), 2 * SMS // blocks_per_split))
    n = max(1, min(-(-(s * d) // MIN_SPLIT_ELEMS), SMS // blocks_per_split))
    return 1 << (n.bit_length() - 1)


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
    nsplit = n_splits(b, hq, hkv, s, d, kernel)
    # the partials: part_acc [rows, D], then part_m [rows], part_l [rows]; the
    # tensor-core kernel writes them only when its splits span several clusters
    scratch = kernel != MMA or nsplit > MAX_CLUSTER
    rows = b * hq * nsplit if scratch else 0
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device) if scratch else None
    acc_ptr = part.data_ptr() if scratch else 0
    m_ptr = acc_ptr + rows * d * 4 if scratch else 0
    l_ptr = m_ptr + rows * 4 if scratch else 0
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == MMA:
            groups = b * hkv * -(-(hq // hkv) // GT) * MAX_CLUSTER  # a counter a slice
            counters = _counters(q.device, stream, groups).data_ptr() if scratch else 0
            err = _fn(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(), _kv_maps(k, v),
                              lengths.data_ptr(), acc_ptr, m_ptr, l_ptr, counters,
                              out.data_ptr(), b, hq, hkv, s, d, nsplit, stream)
        else:
            err = _fn(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                              acc_ptr, m_ptr, l_ptr, out.data_ptr(), b, hq, hkv, s, d, nsplit,
                              stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    launches += 1
    if kernel == MMA:
        launches_mma += 1
    return out
