"""The program's own spans and counters over the traced stretch.

While a profiler records, ``repro_torch.runtime.spans`` keeps one record a
``run_cloud_batch`` call: its frames, per span name ``[count, host
seconds]``, per counter its total. The stretch's records are the trailing
ones whose frames sum exactly to ``obs["trace_frames"]``: that leaves out the
profiled warm-up micro-batch dispatched before the stretch. A program
without that module, or records that do not sum so, give None.
"""
from __future__ import annotations


def stretch(obs: dict, records=None) -> list | None:
    """The traced stretch's records, oldest first, or None."""
    if records is None:
        try:
            from repro_torch.runtime import spans
        except ImportError:
            return None
        records = spans.records
    want = obs.get("trace_frames")
    if not want:
        return None
    picked, total = [], 0
    for rec in reversed(records):
        if total >= want:
            break
        picked.append(rec)
        total += rec.frames
    return picked[::-1] if total == want else None


def span_total(records: list, name: str) -> tuple[int, float]:
    """Count and host seconds of the spans ``name`` over ``records``."""
    n, s = 0, 0.0
    for rec in records:
        c, t = rec.spans.get(name, (0, 0.0))
        n, s = n + c, s + t
    return n, s


def counter_total(records: list, name: str) -> int:
    return sum(rec.counters.get(name, 0) for rec in records)
