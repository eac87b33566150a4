"""Janus §III-B: fine-to-coarse splitting-points generation.

Eq. 3:  C = {0, N+1} ∪ { s_i | s_i = s_{i−1} + ceil(i/k), s_1 = 1, s_i <= N }

s = 0    -> cloud-only (device transmits the compressed raw input)
s in 1..N -> device runs layers 1..s, cloud runs s+1..N
s = N+1  -> device-only (no transfer)

k controls density. NOTE (paper erratum): the prose in §III-B says "a smaller
k value leads to a denser distribution", but Eq. 3's step is ceil(i/k) — a
LARGER k makes the step smaller and the candidate set denser. Fig. 4
(N=12, k=3 -> C = {0, 1, 2, 3, 5, 7, 9, 12, 13}) is consistent with the
formula, so we follow the formula; property-tested in
tests/test_janus_policies.py::test_larger_k_denser.

For CNN-family models (resnet — the paper's §II-C motivating case) and Swin
(built-in patch-merging reduction), ``cnn_split_points`` exposes the stage
boundaries plus per-boundary activation sizes so the same scheduler works.
"""
from __future__ import annotations

import math
from typing import Sequence


def candidate_split_points(n_layers: int, k: int) -> list[int]:
    """Eq. 3. Returns sorted candidate split points including 0 and N+1."""
    if k < 1:
        raise ValueError("k must be >= 1")
    pts = {0, n_layers + 1}
    s, i = 1, 1
    while s <= n_layers:
        pts.add(s)
        i += 1
        s += math.ceil(i / k)
    return sorted(pts)


def uniform_split_points(n_layers: int) -> list[int]:
    """The naive all-layers candidate set (what fine-to-coarse prunes down)."""
    return list(range(0, n_layers + 2))


def search_space_reduction(n_layers: int, k: int) -> float:
    """Fraction of candidate points removed vs uniform — §III-B's overhead win."""
    return 1.0 - len(candidate_split_points(n_layers, k)) / len(uniform_split_points(n_layers))


def transfer_tokens(split: int, counts: Sequence[int], x0: int) -> int | None:
    """Tokens transferred at a split point, given per-layer token counts
    (counts[l] = tokens entering layer l+1; counts[0] = x0).

    Returns None for device-only (no transfer); for cloud-only the caller
    should use the raw input size instead (see scheduler).
    """
    n = len(counts) - 1
    if split == n + 1:
        return None
    if split == 0:
        return x0  # caller substitutes raw-input bytes
    return int(counts[split])


def cnn_split_points(feature_sizes: Sequence[int]) -> list[int]:
    """For CNN/hierarchical models: all stage boundaries are candidates.

    feature_sizes[i] = flattened activation element count after stage i.
    Returns indices 0..len(sizes)+1 in the same {0..N+1} convention.
    """
    return list(range(0, len(feature_sizes) + 2))
