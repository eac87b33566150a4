"""Operations and bytes counted from shapes: the yardstick of the
whole-frame share of peak and of the kernels' rooflines. Frozen here, so
that a change to the program cannot change what it is measured against.

The peaks are the H100 SXM data sheet's dense rates, as
``src/repro_torch/benchmarks/timing.py`` has them; the kernel formulas are
``kernel_bench.Case``'s.
"""
from __future__ import annotations

from typing import Sequence

PEAK_BF16 = 989e12   # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12     # FLOP/s, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def token_counts(num_tokens: int, schedule: Sequence[int]) -> list[int]:
    """Tokens entering each layer, then the count leaving the last."""
    counts = [num_tokens]
    for r in schedule:
        counts.append(counts[-1] - int(r))
    return counts


def frame_flops(cfg: dict, schedule: Sequence[int]) -> float:
    """Useful FLOPs of one frame: the patch embedding, per layer the q, k, v
    and output projections (8 n d^2) and attention (4 n^2 d) at the tokens
    entering it and the MLP (4 m d d_ff) at the m tokens left after its
    merge, and the head on the class token. ToMe's scores are not counted."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    n0 = cfg["num_tokens"]
    pdim = cfg["patch"] ** 2 * cfg["in_channels"]
    total = 2.0 * (n0 - 1) * pdim * d + 2.0 * d * cfg["num_classes"]
    counts = token_counts(n0, schedule)
    for n, m in zip(counts[:-1], counts[1:]):
        total += 8.0 * n * d * d + 4.0 * n * n * d + 4.0 * m * d * ff
    return total


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least seconds the card could take: the larger of the operations
    at ``peak`` and the bytes at the HBM rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def flash_bound_s(batch: int, heads: int, tokens: int, head_dim: int) -> float:
    """One bf16 flash call over [batch, heads, tokens, head_dim] with the
    f32 log-size bias: 4 D FLOPs a (query, key) pair; q, k, v read and the
    output written once, the bias read once."""
    flops = 4.0 * batch * heads * head_dim * tokens * tokens
    nbytes = 4.0 * batch * heads * tokens * head_dim * 2 + batch * tokens * 4
    return bound_s(flops, nbytes, PEAK_BF16)


def tome_bound_s(batch: int, tokens: int, head_dim: int) -> float:
    """One f32 tome_scores call at a merge layer of ``tokens`` tokens: A is
    the ceil(n/2) even positions, B the floor(n/2) odd ones; a and b read
    once, the row max (f32) and its index (int32) written."""
    na, nb = (tokens + 1) // 2, tokens // 2
    flops = 2.0 * batch * na * nb * head_dim
    nbytes = (batch * na * head_dim + batch * nb * head_dim) * 4.0 + batch * na * 8
    return bound_s(flops, nbytes, PEAK_F32)


def group_bounds(cfg: dict, schedule: Sequence[int], frames: int) -> tuple[float, float]:
    """(flash, tome_scores) bound seconds of one stacked cloud forward of
    ``frames`` frames at ``schedule``."""
    heads, hd = cfg["num_attention_heads"], cfg["head_dim"]
    counts = token_counts(cfg["num_tokens"], schedule)
    flash = sum(flash_bound_s(frames, heads, n, hd) for n in counts[:-1])
    tome = sum(tome_bound_s(frames, n, hd) for n, r in zip(counts[:-1], schedule) if r > 0)
    return flash, tome
