"""Plain PyTorch versions of the port's kernels.

The wrappers use them for CPU tensors; the tests and the card phase of
``chip_smoke.py`` hold the CUDA kernels against them. They compute exactly
the kernels' functions, including ``nb_len`` and fully masked rows, and
repeat the kernels' f32 arithmetic (they are no yardstick of speed).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30  # the flash kernels' masked-score sentinel


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        bias: torch.Tensor | None = None,
                        kv_len: torch.Tensor | None = None,
                        causal: bool = False) -> torch.Tensor:
    """q, k, v [B, H, S, D] -> [B, H, Sq, D] in q's dtype.

    f32 scores and softmax; ``bias`` [B, Sk] is clamped at -1e30 and added
    per key; keys at or past ``kv_len`` [B] and, with ``causal``, keys past
    ``qpos + (Sk - Sq)`` are masked to -1e30. A row with no unmasked key
    (its max score is the sentinel) outputs 0."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias.float().clamp_min(NEG)[:, None, None, :]
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((q.shape[0], 1, sq, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
    if causal:
        qpos = torch.arange(sq, device=q.device)
        mask = mask & (qpos[:, None] + (sk - sq) >= kpos[None, :])
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.where(m > 0.5 * NEG, out, torch.zeros_like(out))
    return out.to(q.dtype)


def tome_scores_ref(a: torch.Tensor, b: torch.Tensor,
                    nb_len: torch.Tensor | None = None):
    """a [B, Na, D], b [B, Nb, D] -> (node_max [B, Na] f32, node_idx [B, Na]
    int32): row max of ``a . b^T`` and its first argmax; columns at or past
    ``nb_len`` [B] are -inf."""
    scores = torch.einsum("bnd,bmd->bnm", a.float(), b.float())
    if nb_len is not None:
        col = torch.arange(b.shape[1], device=a.device)
        valid = col[None, :] < nb_len.to(a.device)[:, None]
        scores = scores.masked_fill(~valid[:, None, :], -torch.inf)
    return scores.amax(dim=-1), scores.argmax(dim=-1).to(torch.int32)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor | int) -> torch.Tensor:
    """q [B, Hq, D], k/v cache [B, S, Hkv, D] -> [B, Hq, D] in q's dtype.

    Single-query GQA attention: q head h reads kv head h // (Hq // Hkv).
    ``lengths`` [B] int32, or a scalar broadcast to [B]: keys at or past it
    are masked. f32 scores scaled by 1/sqrt(D), softmax weights of masked
    keys exactly 0 (cache entries past the length never reach the output,
    whatever they hold), output normalised by max(l, 1e-30) and cast once,
    so a row with length 0 outputs 0 (as the Pallas kernel; its jnp oracle
    gives NaN)."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (1.0 / math.sqrt(d))
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(b)
    valid = (torch.arange(s, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    v = torch.where(valid[:, 0, 0, :, None, None], v.float(), 0.0)  # as the kernel: never read
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, d).to(q.dtype)
