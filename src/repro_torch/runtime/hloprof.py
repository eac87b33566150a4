"""Structural per-rank profile of a counted step, PyTorch port of
``repro.runtime.hloprof`` (which reads compiled HLO text).

Aggregates operand+result bytes per op kind from a
``runtime.hlo_bytes.Counter``'s calls and lists the heaviest single calls:
the hypothesis generator for the hill-climb loop (redundant gathers and
copies, f32 upcasts, casts and layout copies all show up here, as do the
kernels' own reported bytes).
"""
from __future__ import annotations

from collections import defaultdict


def profile_calls(calls, top: int = 20):
    """(bytes by kind, calls by kind, the ``top`` heaviest calls as
    (bytes, description)) of ``calls`` (``hlo_bytes.Call`` records)."""
    by_kind: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    heavy: list[tuple[float, str]] = []
    for c in calls:
        by_kind[c.kind] += c.bytes
        count[c.kind] += 1
        heavy.append((c.bytes, f"{c.kind}({c.shapes})"[:160]))
    heavy.sort(key=lambda x: -x[0])
    return dict(sorted(by_kind.items(), key=lambda kv: -kv[1])), dict(count), heavy[:top]


def report(counter, top: int = 15) -> str:
    """The profile of a ``Counter`` as text."""
    by_kind, counts, heavy = profile_calls(counter.calls, top)
    lines = ["bytes by op kind:"]
    for k, v in list(by_kind.items())[:15]:
        lines.append(f"  {k:28s} {v/1e9:9.3f} GB  x{counts[k]}")
    lines.append("heaviest calls:")
    for b, line in heavy:
        lines.append(f"  {b/1e9:8.3f} GB  {line}")
    return "\n".join(lines)
