"""Token-count bucketing for continuous batching of mixed pruning levels.

The fleet's real-execution path compiles one cloud-partition program per
(schedule-suffix, split, token-count) geometry. Janus's per-frame scheduler
re-picks α continuously, so a fleet of streams produces many distinct cloud
*input* token counts — but the exponential merge schedule Δx_l =
floor(2^{α(N-l)}) saturates at late layers, so different α frequently share
the *same* schedule suffix past the split. Those plans differ only in token
count: pad each one's tokens up to a small set of **bucket edges** and they
share a single compiled geometry.

This module owns the bucketing *policy*: which edges exist per split, and
which edge a given token count rounds up to. The padded math itself (size-0
pads, -inf attention bias, pad-aware merge) lives in ``models.vit`` /
``core.tome``; the grouping that consumes this table lives in
``core.engine.run_cloud_batch``.

The table is enumerable ahead of time — the α grid is finite and schedules
are deterministic — which is exactly what makes it consumable by the
latency-aware planner (ROADMAP: bucketed pruning): the planner can price a
decision at its *padded* token count instead of its nominal one.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Mapping, Sequence

from repro_torch.core import pruning


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    """Policy knobs. ``n_edges`` bounds the compiled-geometry count per split:
    retraces for one (suffix, split) group are bounded by the number of edges
    its token counts round up to, not by the number of distinct α in flight."""
    n_edges: int = 4

    def __post_init__(self):
        if self.n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {self.n_edges}")


def bucket_edges(counts: Iterable[int], n_edges: int) -> tuple[int, ...]:
    """Pick <= n_edges bucket edges covering ``counts``.

    Edges are a quantile-spaced subset of the unique counts; the maximum is
    always an edge, so every count rounds *up* to some edge (never truncates
    tokens). With few distinct counts, every count is its own edge and
    padding is a no-op.
    """
    uniq = sorted({int(c) for c in counts})
    if not uniq:
        return ()
    if len(uniq) <= n_edges:
        return tuple(uniq)
    if n_edges == 1:
        return (uniq[-1],)
    last = len(uniq) - 1
    idx = {round(i * last / (n_edges - 1)) for i in range(n_edges)}
    return tuple(uniq[i] for i in sorted(idx))


class BucketTable:
    """Per-split bucket edges for a model's cloud-partition token counts.

    Built by enumerating the scheduler's α grid: for each α the exec-geometry
    schedule is derived, and for each split s the token count entering the
    cloud partition (``token_counts[s]``) is collected. ``edge_for`` then
    rounds a runtime count up to its bucket edge; counts outside the table
    (α off-grid, unseen split) fall back to the exact count — unbatched but
    always correct.
    """

    def __init__(self, edges_by_split: Mapping[int, Sequence[int]],
                 config: BucketingConfig | None = None):
        self.config = config or BucketingConfig()
        self.edges_by_split: dict[int, tuple[int, ...]] = {
            int(s): tuple(sorted(int(e) for e in edges))
            for s, edges in edges_by_split.items()}

    @classmethod
    def build(cls, model_cfg, alphas: Iterable[float], *,
              kind: str = "exponential",
              config: BucketingConfig | None = None) -> "BucketTable":
        """Enumerate cloud-entry token counts over (α grid × split grid) for
        the executed model and bucket them per split. Splits run 0..n_layers:
        split 0 is the cloud-only geometry, split n is the head-only program
        a device-only frame still dispatches."""
        return cls.build_for(model_cfg.n_layers, model_cfg.num_tokens, alphas,
                             kind=kind, config=config)

    @classmethod
    def build_for(cls, n_layers: int, num_tokens: int, alphas: Iterable[float],
                  *, kind: str = "exponential",
                  config: BucketingConfig | None = None) -> "BucketTable":
        """``build`` from the raw (n_layers, num_tokens) geometry — no
        ViTConfig needed. The step-aware planner prices the *timing-plane*
        profile, which may model a bigger ViT than the executed one."""
        config = config or BucketingConfig()
        n = n_layers
        counts_by_split: dict[int, set[int]] = {s: set() for s in range(n + 1)}
        for alpha in alphas:
            sched = pruning.make_schedule(kind, float(alpha), n, num_tokens)
            counts = pruning.token_counts(num_tokens, sched)
            for s in range(n + 1):
                counts_by_split[s].add(int(counts[s]))
        return cls({s: bucket_edges(c, config.n_edges)
                    for s, c in counts_by_split.items()}, config)

    def edge_for(self, split: int, t: int) -> int:
        """Smallest bucket edge >= t for this split; t itself when no edge
        covers it (exact geometry, no padding)."""
        edges = self.edges_by_split.get(int(split), ())
        i = bisect.bisect_left(edges, int(t))
        if i == len(edges):
            return int(t)
        return edges[i]

    @property
    def n_cells(self) -> int:
        """Total number of (split, edge) cells — the retrace upper bound for
        fully bucket-aligned traffic."""
        return sum(len(e) for e in self.edges_by_split.values())

    def as_json(self) -> dict:
        return {
            "n_edges": self.config.n_edges,
            "edges_by_split": {str(s): list(e)
                               for s, e in sorted(self.edges_by_split.items())},
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "BucketTable":
        return cls({int(s): tuple(e) for s, e in d["edges_by_split"].items()},
                   BucketingConfig(n_edges=int(d.get("n_edges", 4))))
