"""Dispatch the model calls: the Hopper kernels, or their plain versions.

The model (``models.layers``, ``core.tome``) calls these. By default a
call goes to the kernel wrapper, which runs the kernel on a CUDA tensor and
the plain version on a CPU tensor. ``plain_versions()`` routes every call in
its scope to the plain versions on any device, so that a run on the card can
hold the kernels' whole path against the plain path (``chip_smoke.py``'s
parity phase); it is a context, scoped and restored, never a fallback.

On DTensor operands (under ``sharding.rules``) each call runs behind the
local boundary ``rules.run_local``: the kernel, or the plain version, on
each rank's local tensors, the result wrapped with the operands'
placements. Only the dims the function treats independently may be
sharded: batch, and heads for flash and decode attention (a GQA decode
sharded on heads needs the kv heads to divide too, so that each rank's
query heads read its own kv heads); any other sharding raises.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import tome_scores as _tome
from repro_torch.sharding.rules import run_local

_PLAIN = contextvars.ContextVar("repro_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions instead of the kernels in this scope."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


_BHSD = ("batch", "heads", None, None)


def flash_attention(q, k, v, *, bias=None, kv_len=None, causal: bool = False):
    """q, k, v [B, H, S, D] -> [B, H, Sq, D]; see ``kernels.flash_attention``."""
    def call(q, k, v, bias, kv_len):
        if _PLAIN.get():
            return ref.flash_attention_ref(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
        return _flash.flash_attention(q, k, v, bias=bias, kv_len=kv_len, causal=causal)
    return run_local("flash_attention", call, (q, k, v, bias, kv_len),
                     (_BHSD, _BHSD, _BHSD, ("batch", None), ("batch",)), _BHSD)


def tome_scores(a, b, nb_len=None):
    """(node_max, node_idx) for ToMe bipartite matching; see
    ``kernels.tome_scores``."""
    def call(a, b, nb_len):
        if _PLAIN.get():
            return ref.tome_scores_ref(a, b, nb_len)
        return _tome.tome_scores(a, b, nb_len)
    rows = ("batch", None, None)
    return run_local("tome_scores", call, (a, b, nb_len), (rows, rows, ("batch",)),
                     [("batch", None), ("batch", None)])


def decode_attention(q, k, v, lengths):
    """q [B, Hq, D], k/v cache [B, S, Hkv, D], valid ``lengths`` [B] (or a
    scalar) -> [B, Hq, D]; see ``kernels.decode_attention``."""
    def call(q, k, v, lengths):
        if _PLAIN.get():
            return ref.decode_attention_ref(q, k, v, lengths)
        return _decode.decode_attention(q, k, v, lengths)
    q_roles, kv_roles = ("batch", "heads", None), ("batch", None, "heads", None)
    len_roles = ("batch",) if isinstance(lengths, torch.Tensor) and lengths.dim() else ()
    return run_local("decode_attention", call, (q, k, v, lengths),
                     (q_roles, kv_roles, kv_roles, len_roles), q_roles)
