"""ToMe bipartite soft matching token merging, PyTorch port of
``repro.core.tome`` (Bolya et al., ICLR'23).

At a merge layer the ``r`` most similar (src -> dst) token pairs of the
alternating A/B split are merged, so the token count drops by exactly ``r``.
The O(Na·Nb·D) score + row-argmax goes through ``kernels.ops.tome_scores``
(the Hopper kernel on a CUDA tensor, its plain version on a CPU tensor).
The reference's ``vmap`` over the batch is a batch dimension here.

Numerics that must match the reference: ``jnp.argsort`` is stable, so every
sort here passes ``stable=True``; ``.at[dst].add`` sums several sources into
one destination in source order with the array's dtype rounding after each
add (``sizes`` carries the activation dtype, so under bf16 merged sizes above
256 round), which ``_scatter_add`` reproduces deterministically on any device
(CUDA ``index_add_`` sums colliding indices in no fixed order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class MergeIndices(NamedTuple):
    src_idx: torch.Tensor  # [B, r]    positions in the A (src) set that get merged
    unm_idx: torch.Tensor  # [B, Na-r] positions in the A set that survive (sorted)
    dst_idx: torch.Tensor  # [B, r]    destination in the B (dst) set per merged src


def _normalized_halves(metric: torch.Tensor):
    m = metric.float()
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    return m[:, ::2].contiguous(), m[:, 1::2].contiguous()


def _select(node_max: torch.Tensor, node_idx: torch.Tensor, r: int) -> MergeIndices:
    order = torch.argsort(-node_max, dim=-1, stable=True)  # descending similarity
    src_idx = order[:, :r]
    unm_idx = torch.sort(order[:, r:], dim=-1).values  # original order (cls stays first)
    dst_idx = torch.gather(node_idx.long(), 1, src_idx)
    return MergeIndices(src_idx, unm_idx, dst_idx)


def _check_r(n: int, r: int) -> None:
    na = (n + 1) // 2
    if not 0 < r < na:
        raise ValueError(f"r={r} must be in (0, {na})")


def bipartite_soft_matching(metric: torch.Tensor, r: int, *,
                            protect_first: bool = True) -> MergeIndices:
    """Which r tokens of the alternating A set merge into the B set.
    metric: [B, N, D] similarity metric (ToMe uses the mean attention keys)."""
    _check_r(metric.shape[1], r)
    a, bset = _normalized_halves(metric)
    node_max, node_idx = ops.tome_scores(a, bset)
    if protect_first:
        node_max = node_max.clone()
        node_max[:, 0] = -torch.inf
    return _select(node_max, node_idx, r)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, ...] indexed along dim 1 by idx [B, k]."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _scatter_add(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].add(vals)`` per batch member, summing colliding sources
    in source order with one rounding per add, deterministically.

    Pass k adds the k-th source (in source order) of every destination, so
    no pass has two sources on one destination; the other slots add an exact
    zero, which changes no value."""
    b, r = idx.shape
    n = base.shape[1]
    pos = torch.arange(r, device=idx.device).expand(b, r)
    by_dst = torch.argsort(idx, dim=1, stable=True)
    sorted_idx = torch.gather(idx, 1, by_dst)
    starts = torch.ones_like(sorted_idx, dtype=torch.bool)
    starts[:, 1:] = sorted_idx[:, 1:] != sorted_idx[:, :-1]
    group_start = torch.cummax(torch.where(starts, pos, torch.zeros_like(pos)), dim=1).values
    rank = torch.empty((b, r), dtype=torch.long, device=idx.device)
    rank.scatter_(1, by_dst, pos - group_start)
    flat_idx = (idx + n * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    out = base.reshape(b * n, *base.shape[2:]).clone()
    vals = vals.reshape(b * r, *vals.shape[2:])
    rank = rank.reshape(-1)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for k in range(int(rank.max()) + 1):
        sel = (rank == k).reshape(-1, *([1] * (vals.dim() - 1)))
        out.index_add_(0, flat_idx, torch.where(sel, vals, zero))
    return out.reshape(base.shape)


def merge_tokens(x: torch.Tensor, sizes: torch.Tensor, idx: MergeIndices):
    """Apply a matching. x [B, N, D], sizes [B, N] -> ([B, N-r, D], [B, N-r])."""
    a, bset = x[:, ::2], x[:, 1::2]
    sa, sb = sizes[:, ::2], sizes[:, 1::2]
    aw = a * sa[..., None]
    bw = bset * sb[..., None]
    src_vals = _gather_rows(aw, idx.src_idx)
    src_sizes = _gather_rows(sa, idx.src_idx)
    b_new = _scatter_add(bw, idx.dst_idx, src_vals)
    sb_new = _scatter_add(sb, idx.dst_idx, src_sizes)
    # real tokens always have sb_new >= 1; size-0 pad tokens (padded merge)
    # would otherwise turn 0/0 into NaN
    dst = b_new / sb_new.clamp_min(1e-30)[..., None]
    unm = _gather_rows(a, idx.unm_idx)
    s_unm = _gather_rows(sa, idx.unm_idx)
    return torch.cat([unm, dst], dim=1), torch.cat([s_unm, sb_new], dim=1)


def tome_merge(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor, r: int, *,
               protect_first: bool = True):
    """Full ToMe step: match on ``metric``, merge ``x``. Returns (x', sizes')."""
    if r <= 0:
        return x, sizes
    idx = bipartite_soft_matching(metric, r, protect_first=protect_first)
    return merge_tokens(x, sizes, idx)


def padded_matching(metric: torch.Tensor, sizes: torch.Tensor, r: int, *,
                    protect_first: bool = True) -> MergeIndices:
    """The matching of ``tome_merge_padded``. Pad columns of the score matrix
    are -inf: pads sit at the tail on entry, so the pad mask over the B set
    is a per-member valid count, handed to the kernel as ``nb_len``. Pad
    rows' ``node_max`` is -inf, so pads sort behind every real candidate."""
    _check_r(metric.shape[1], r)
    a, bset = _normalized_halves(metric)
    pad_a = sizes[:, ::2] <= 0.0
    nb_len = (sizes[:, 1::2] > 0.0).sum(dim=-1, dtype=torch.int32)
    node_max, node_idx = ops.tome_scores(a, bset, nb_len)
    if protect_first:
        node_max = node_max.clone()
        node_max[:, 0] = -torch.inf
    node_max = node_max.masked_fill(pad_a, -torch.inf)
    return _select(node_max, node_idx, r)


def tome_merge_padded(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor,
                      r: int, *, protect_first: bool = True):
    """Pad-aware ToMe step for bucketed execution (``core.bucketing``).

    ``x`` carries real tokens first and size-0 pads at the tail; the real
    count may differ per batch member. The merge of the real tokens is the
    one ``tome_merge`` makes on the unpadded input: pads never win a match
    (``padded_matching``), and after the merge the tokens are stably
    re-sorted so pads return to the tail and the next layer's A/B split of
    the real tokens is the unpadded run's. Attention keeps pads out through
    the ``log(0) = -inf`` size bias (the caller's job)."""
    if r <= 0:
        return x, sizes
    idx = padded_matching(metric, sizes, r, protect_first=protect_first)
    x, sizes = merge_tokens(x, sizes, idx)
    tail = torch.argsort((sizes <= 0.0).to(torch.int32), dim=-1, stable=True)
    return _gather_rows(x, tail), torch.gather(sizes, 1, tail)
