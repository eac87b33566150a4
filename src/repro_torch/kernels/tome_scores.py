"""Wrapper of the Hopper ToMe-scores kernels (``csrc/tome_scores.cu``).

Replaces ``repro.kernels.tome_scores.tome_scores`` (Pallas), plus the
pad-column mask of ``tome_merge_padded`` as an optional per-member valid
count ``nb_len``. The source has two routes with bit-equal results:
``SMALL``, sized for the ViT's latency-bound calls, and ``LARGE``, an
SGEMM-like register tile fed by TMA for calls whose FMAs bound them (dit-s2's
merges); ``route_for`` picks one by the work of the call. A CPU tensor goes
to the plain version in ``ref.py``; a CUDA tensor launches a kernel or
raises, never falls back. ``launches`` counts kernel launches of both
routes, ``launches_large`` those of the large one.

Its outputs carry no gradient, by nature: the index is an argmax, and the
max only ranks candidate edges (the merge's weighted average, not the
score, carries the tokens' values). The reference trains without ToMe.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

launches = 0
launches_large = 0

SMALL = "small"  # tome_scores_kernel: 8-row groups, a cp.async ring, one wave of blocks
LARGE = "large"  # tome_scores_large_kernel: 32-row blocks, 8 x 8 register tiles, TMA
_DIMS = (16, 32, 64, 128)
LARGE_DIMS = (64, 128)
# B * Na * Nb from which the large route serves a call: above the ViT's
# calls (B=8: 666k), below dit-s2's merges (4.2M to 16.8M); kernel_bench
# times both routes at the ViT's B=1 and B=8 calls
LARGE_MIN_WORK = 1 << 21


def route_for(b: int, na: int, nb: int, d: int) -> str:
    """The route that serves a call at a [b, na, d] x [b, nb, d]: ``LARGE``
    at D 64 and 128 from ``LARGE_MIN_WORK`` scores on, else ``SMALL``."""
    return LARGE if d in LARGE_DIMS and b * na * nb >= LARGE_MIN_WORK else SMALL


@functools.cache
def _fn(route: str):
    lib = _build.load("tome_scores")
    fn = lib.tome_scores_large_fwd if route == LARGE else lib.tome_scores_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tome_scores(a: torch.Tensor, b: torch.Tensor,
                nb_len: torch.Tensor | None = None, *, route: str | None = None):
    """a [B, Na, D], b [B, Nb, D] f32 (L2-normalized by the caller) ->
    (node_max [B, Na] f32, node_idx [B, Na] int32), first index on ties.
    ``nb_len`` [B] int32: columns at or past it are -inf. ``route`` forces
    a route on a CUDA tensor (``route_for`` picks it otherwise)."""
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
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("tome_scores: a/b must start on a 16-byte boundary")
    route = route_for(bsz, na, nb, d) if route is None else route
    if route not in (SMALL, LARGE) or (route == LARGE and d not in LARGE_DIMS):
        raise ValueError(f"tome_scores: route {route!r} does not take D={d}")

    global launches, launches_large
    node_max = torch.empty((bsz, na), dtype=torch.float32, device=a.device)
    node_idx = torch.empty((bsz, na), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn(route)(a.data_ptr(), b.data_ptr(),
                         None if nb_len is None else nb_len.data_ptr(),
                         node_max.data_ptr(), node_idx.data_ptr(), bsz, na, nb, d, stream)
    if err != 0:
        raise RuntimeError(f"tome_scores ({route} route) kernel launch failed: error {err}")
    launches += 1
    launches_large += route == LARGE
    return node_max, node_idx
