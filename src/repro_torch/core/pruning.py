"""Janus §III-A: collaboration-aware token pruner — mixed pruning policy.

Eq. 1:  Δx_l = floor(2^(α(N−l)))  for α != 0, else 0     (l = 1..N)
Eq. 2:  Σ_{l=1..N} floor(2^(α_max(N−(l−1)))) <= x0 − 1   (bounds α_max)

plus the linear-declining baseline the paper compares against (Table I):
        Δx_l = floor(α·(N−l))

Schedules are *clamped* so that (a) ToMe's bipartite constraint r < ceil(x/2)
holds at every layer (the cls token is protected and cannot merge), and
(b) at least ``min_tokens`` remain. Clamping never fires for α <= α_max but
keeps arbitrary α safe — property-tested in tests/test_janus_policies.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


def exponential_schedule(alpha: float, n_layers: int) -> list[int]:
    """Eq. 1 — number of tokens merged at each layer l = 1..N."""
    if alpha == 0:
        return [0] * n_layers
    return [int(math.floor(2 ** (alpha * (n_layers - l)))) for l in range(1, n_layers + 1)]


def linear_schedule(alpha: float, n_layers: int) -> list[int]:
    """Linear-declining baseline (§III-A, Table I)."""
    return [int(math.floor(alpha * (n_layers - l))) for l in range(1, n_layers + 1)]


def fixed_schedule(r: int, n_layers: int) -> list[int]:
    """ToMe's original fixed-r policy (the paper's baselines use this)."""
    return [r] * n_layers


def cumulative(schedule: Sequence[int]) -> int:
    return int(sum(schedule))


def _eq2_sum(alpha: float, n_layers: int) -> int:
    """The Eq. 2 bound uses exponent N−(l−1) (one step steeper than Eq. 1)."""
    return sum(int(math.floor(2 ** (alpha * (n_layers - (l - 1)))))
               for l in range(1, n_layers + 1))


def alpha_max(n_layers: int, x0: int, t: float = 0.01) -> float:
    """Largest multiple of t with Eq.2 cumulative reduction <= x0 - 1.

    (Floors at 0.0 when even alpha=0 violates Eq.2, i.e. x0 <= N — the paper's
    regime always has x0 >> N.) The candidate is rounded BEFORE evaluating
    Eq.2: floor(2^(alpha*k)) is discontinuous, so testing an unrounded
    0.09999... and storing 0.1 could overshoot the bound.
    """
    a = 0.0
    while True:
        cand = round(a + t, 10)
        if cand > 10 or _eq2_sum(cand, n_layers) > x0 - 1:
            return a
        a = cand


def clamp_schedule(schedule: Sequence[int], x0: int, *, min_tokens: int = 2,
                   protect_first: bool = True) -> list[int]:
    """Enforce ToMe feasibility: r_l <= ceil(x_l/2) - protected, and x stays
    >= min_tokens. Returns a new schedule."""
    out = []
    x = x0
    for r in schedule:
        na = (x + 1) // 2
        cap = max(na - (1 if protect_first else 0), 0)
        r = max(0, min(int(r), cap, x - min_tokens))
        out.append(r)
        x -= r
    return out


def token_counts(x0: int, schedule: Sequence[int]) -> list[int]:
    """Tokens entering layer l (length N+1, last entry = output token count)."""
    counts = [x0]
    for r in schedule:
        counts.append(counts[-1] - int(r))
    return counts


def pruned_fraction(x0: int, schedule: Sequence[int], patch_tokens: int | None = None) -> float:
    """Fraction of (non-cls) patches merged away by the end of the stack."""
    total = cumulative(schedule)
    denom = patch_tokens if patch_tokens is not None else (x0 - 1)
    return min(total / max(denom, 1), 1.0)


@dataclasses.dataclass(frozen=True)
class AccuracyModel:
    """Simulation-side accuracy proxy, calibrated to the paper's observations:

    - no pruning   -> base accuracy
    - ToMe's max fixed pruning (~95.7% of patches merged) -> ~0.2-0.3% drop
      (Janus reports <=0.29% average accuracy delta vs max-pruned baselines,
       and <0.0021 delta between exponential and linear declining)

    acc(α) = base − drop_at_full · pruned_fraction^gamma. gamma > 1 captures
    that early merges are near-free (redundant tokens) and late ones costly.
    """
    base: float = 0.8543       # ViT-L/B ImageNet-1k territory (paper §I)
    drop_at_full: float = 0.003
    gamma: float = 2.5

    def accuracy(self, x0: int, schedule: Sequence[int]) -> float:
        f = pruned_fraction(x0, schedule)
        return self.base - self.drop_at_full * (f ** self.gamma)


def make_schedule(kind: str, alpha: float, n_layers: int, x0: int) -> list[int]:
    if kind == "exponential":
        s = exponential_schedule(alpha, n_layers)
    elif kind == "linear":
        s = linear_schedule(alpha, n_layers)
    elif kind == "none":
        s = [0] * n_layers
    else:
        raise ValueError(kind)
    return clamp_schedule(s, x0)
