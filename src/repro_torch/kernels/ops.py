"""Dispatch the model calls: the Hopper kernels, or their plain versions.

The model (``models.layers``, ``core.tome``) calls these. By default a
call goes to the kernel wrapper, which runs the kernel on a CUDA tensor and
the plain version on a CPU tensor. ``plain_versions()`` routes every call in
its scope to the plain versions on any device, so that a run on the card can
hold the kernels' whole path against the plain path (``chip_smoke.py``'s
parity phase); it is a context, scoped and restored, never a fallback.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import tome_scores as _tome

_PLAIN = contextvars.ContextVar("repro_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions instead of the kernels in this scope."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def flash_attention(q, k, v, *, bias=None, kv_len=None, causal: bool = False):
    """q, k, v [B, H, S, D] -> [B, H, Sq, D]; see ``kernels.flash_attention``."""
    if _PLAIN.get():
        return ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
    return _flash.flash_attention(q, k, v, bias=bias, kv_len=kv_len, causal=causal)


def tome_scores(a, b, nb_len=None):
    """(node_max, node_idx) for ToMe bipartite matching; see
    ``kernels.tome_scores``."""
    if _PLAIN.get():
        return ref.tome_scores_ref(a, b, nb_len)
    return _tome.tome_scores(a, b, nb_len)


def decode_attention(q, k, v, lengths):
    """q [B, Hq, D], k/v cache [B, S, Hkv, D], valid ``lengths`` [B] (or a
    scalar) -> [B, Hq, D]; see ``kernels.decode_attention``."""
    if _PLAIN.get():
        return ref.decode_attention_ref(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)
