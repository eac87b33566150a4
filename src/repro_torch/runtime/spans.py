"""Spans and counters on the port's real-math path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records: the test
is the profiler's own flag, ``torch.autograd.profiler._is_profiler_enabled``.
There is no other switch.

Off, ``span`` returns one shared no-op context and ``count`` returns at once:
one flag read a site, no clock read, no allocation, no ``record_function``.

On, ``span(name)`` opens ``record_function(name)``, so the span lies in the
profiler's timeline beside the kernels it launches, and adds its count and
host seconds to the record that is open. ``batch(name, frames)`` is a span
that opens a ``Record`` (one a ``core.engine.run_cloud_batch`` call); on exit
the record goes to ``records``, in memory, for whoever reads it after the
session. Spans and counters outside an open record reach the profiler only.

Names on the cloud path: ``engine.cloud_batch`` (the record's root) ⊃
``engine.forward`` (one stacked forward) ⊃ ``tome.merge`` (one ToMe step) ⊃
``tome.readback`` (the merge scatter's device-to-host read); the counter
``host_syncs`` counts device-to-host reads.
"""
from __future__ import annotations

import collections
import contextlib
from time import perf_counter_ns as _clock

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


class Record:
    """One batch: its ``frames``, per span name ``[count, host seconds]``
    (``spans``), per counter its total (``counters``)."""

    __slots__ = ("frames", "spans", "counters")

    def __init__(self, frames: int):
        self.frames = frames
        self.spans: dict[str, list] = {}
        self.counters: dict[str, int] = {}


records: collections.deque[Record] = collections.deque(maxlen=4096)
_open: Record | None = None


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = _clock()

    def __exit__(self, *exc):
        dt = (_clock() - self._t0) * 1e-9
        self._range.__exit__(*exc)
        if _open is not None:
            entry = _open.spans.setdefault(self.name, [0, 0.0])
            entry[0] += 1
            entry[1] += dt


class _Batch(_Span):
    __slots__ = ("_record", "_outer")

    def __init__(self, name: str, frames: int):
        super().__init__(name)
        self._record = Record(frames)

    def __enter__(self):
        global _open
        self._outer, _open = _open, self._record
        super().__enter__()

    def __exit__(self, *exc):
        global _open
        super().__exit__(*exc)
        _open = self._outer
        records.append(self._record)


def span(name: str):
    """A context that times ``name`` while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def batch(name: str, frames: int):
    """A span that opens the record of one batch of ``frames`` frames."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Batch(name, frames)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    if _profiler._is_profiler_enabled and _open is not None:
        _open.counters[name] = _open.counters.get(name, 0) + n
