"""Wrapper of the Hopper ToMe-scores kernel (``csrc/tome_scores.cu``).

Replaces ``repro.kernels.tome_scores.tome_scores`` (Pallas), plus the
pad-column mask of ``tome_merge_padded`` as an optional per-member valid
count ``nb_len``. A CPU tensor goes to the plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises, never falls back. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

launches = 0

_DIMS = (16, 32, 64, 128)


@functools.cache
def _fn():
    fn = _build.load("tome_scores").tome_scores_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tome_scores(a: torch.Tensor, b: torch.Tensor,
                nb_len: torch.Tensor | None = None):
    """a [B, Na, D], b [B, Nb, D] f32 (L2-normalized by the caller) ->
    (node_max [B, Na] f32, node_idx [B, Na] int32), first index on ties.
    ``nb_len`` [B] int32: columns at or past it are -inf."""
    if a.device.type == "cpu":
        return ref.tome_scores_ref(a, b, nb_len)
    if a.device.type != "cuda":
        raise ValueError(f"tome_scores: unsupported device {a.device}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"tome_scores: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "must be [B, Na, D] and [B, Nb, D]")
    bsz, na, d = a.shape
    nb = b.shape[1]
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"tome_scores: a/b must be float32, got {a.dtype}/{b.dtype}")
    if d not in _DIMS:
        raise ValueError(f"tome_scores: dim {d} not in {_DIMS}")
    if min(bsz, na, nb) == 0:
        raise ValueError(f"tome_scores: empty shape a {tuple(a.shape)} b {tuple(b.shape)}")
    tensors = [a, b]
    if nb_len is not None:
        if nb_len.shape != (bsz,) or nb_len.dtype != torch.int32:
            raise ValueError(f"tome_scores: nb_len must be int32 [{bsz}], got "
                             f"{nb_len.dtype} {tuple(nb_len.shape)}")
        tensors.append(nb_len)
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"tome_scores: operand on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError("tome_scores: operands must be contiguous")

    global launches
    node_max = torch.empty((bsz, na), dtype=torch.float32, device=a.device)
    node_idx = torch.empty((bsz, na), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(),
                    None if nb_len is None else nb_len.data_ptr(),
                    node_max.data_ptr(), node_idx.data_ptr(), bsz, na, nb, d, stream)
    if err != 0:
        raise RuntimeError(f"tome_scores kernel launch failed: cudaError {err}")
    launches += 1
    return node_max, node_idx
