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

Every call reports itself to the active per-rank counters
(``runtime.hlo_bytes.kernel``) on the local tensors, on every route: the
kernel's FLOPs and bytes (inputs read once, outputs written once, as
``chip_smoke.py``'s bounds), with dispatch counting paused inside, so the
plain version's materialised scores are not counted where it stands in
for the kernel. The flash backward reports itself the same way, as
``flash_attention_bwd`` at ``flash_bwd_cost``, from the kernel's autograd
Function on every route of the wrapper (under ``plain_versions()`` autograd
differentiates the plain forward, whose operations are counted as such). A masked key (``kv_len``, a decode's ``lengths``) is data,
which a fake tensor does not have: the count takes every key of the call.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import tome_scores as _tome
from repro_torch.runtime import hlo_bytes
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


def _bytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors if t is not None))


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a flash call computes: every pair, or the causal
    ones (bottom-right aligned: query i sees keys 0 .. i + sk - sq)."""
    if causal and sk >= sq:
        return sq * (sk - sq + 1) + sq * (sq - 1) // 2
    if causal:
        return sum(max(0, i + sk - sq + 1) for i in range(sq))
    return sq * sk


def flash_cost(q, k, v, bias=None, kv_len=None, causal: bool = False):
    """(FLOPs, bytes, dtype) of one flash call: 4*D FLOPs a (query, key)
    pair, every pair or the causal ones (bottom-right aligned); q, k, v,
    bias and kv_len read once, the output written once."""
    b, h, sq, d = q.shape
    return (4.0 * b * h * d * _pairs(sq, k.shape[2], causal),
            _bytes(q, k, v, bias, kv_len) + _bytes(q), q.dtype)


def flash_bwd_cost(q, k, v, bias=None, kv_len=None, causal: bool = False,
                   need_bias: bool = False):
    """(FLOPs, bytes, dtype) of one flash backward call: five products of
    2*D FLOPs a (query, key) pair (S, dP, dV, dQ, dK); q, k, v, the output,
    its gradient, the f32 log-sum-exp [B, H, Sq], bias and kv_len read once;
    dq, dk, dv (and the f32 dbias [B, Sk]) written once."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lse = b * h * sq * 4.0
    dbias = b * sk * 4.0 if need_bias else 0.0
    return (10.0 * b * h * d * _pairs(sq, sk, causal),
            _bytes(q, k, v, bias, kv_len) + 2 * _bytes(q) + lse + _bytes(q, k, v) + dbias,
            q.dtype)


def tome_cost(a, b, nb_len=None):
    """(FLOPs, bytes, dtype) of one tome_scores call: a [B, Na, D] against
    b [B, Nb, D], 2*D FLOPs a pair; a, b read once, the f32 max and int32
    index [B, Na] written once."""
    bsz, na, d = a.shape
    return (2.0 * bsz * na * b.shape[1] * d, _bytes(a, b, nb_len) + bsz * na * 8.0, a.dtype)


def decode_cost(q, k, v, lengths):
    """(FLOPs, bytes, dtype) of one decode call: 4*D FLOPs a (query head,
    cache slot) over the whole cache S; q and the cache read once, the
    output written once."""
    b, hq, d = q.shape
    n = _bytes(lengths) if isinstance(lengths, torch.Tensor) else 0.0
    return (4.0 * b * hq * k.shape[1] * d, _bytes(q, k, v) + n + _bytes(q), q.dtype)


def flash_attention(q, k, v, *, bias=None, kv_len=None, causal: bool = False):
    """q, k, v [B, H, S, D] -> [B, H, Sq, D]; see ``kernels.flash_attention``."""
    def call(q, k, v, bias, kv_len):
        fn = ref.flash_attention_ref if _PLAIN.get() else _flash.flash_attention
        return hlo_bytes.kernel(
            "flash_attention", lambda: flash_cost(q, k, v, bias, kv_len, causal),
            lambda: fn(q, k, v, bias=bias, kv_len=kv_len, causal=causal))
    return run_local("flash_attention", call, (q, k, v, bias, kv_len),
                     (_BHSD, _BHSD, _BHSD, ("batch", None), ("batch",)), _BHSD)


def tome_scores(a, b, nb_len=None):
    """(node_max, node_idx) for ToMe bipartite matching; see
    ``kernels.tome_scores``."""
    def call(a, b, nb_len):
        fn = ref.tome_scores_ref if _PLAIN.get() else _tome.tome_scores
        return hlo_bytes.kernel("tome_scores", lambda: tome_cost(a, b, nb_len),
                                lambda: fn(a, b, nb_len))
    rows = ("batch", None, None)
    return run_local("tome_scores", call, (a, b, nb_len), (rows, rows, ("batch",)),
                     [("batch", None), ("batch", None)])


def decode_attention(q, k, v, lengths):
    """q [B, Hq, D], k/v cache [B, S, Hkv, D], valid ``lengths`` [B] (or a
    scalar) -> [B, Hq, D]; see ``kernels.decode_attention``."""
    def call(q, k, v, lengths):
        fn = ref.decode_attention_ref if _PLAIN.get() else _decode.decode_attention
        return hlo_bytes.kernel("decode_attention", lambda: decode_cost(q, k, v, lengths),
                                lambda: fn(q, k, v, lengths))
    q_roles, kv_roles = ("batch", "heads", None), ("batch", None, "heads", None)
    len_roles = ("batch",) if isinstance(lengths, torch.Tensor) and lengths.dim() else ()
    return run_local("decode_attention", call, (q, k, v, lengths),
                     (q_roles, kv_roles, kv_roles, len_roles), q_roles)
