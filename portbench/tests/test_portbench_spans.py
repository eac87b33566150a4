"""The readers of the program's spans and counters: the traced stretch's
records picked from the program's, and each metric on a synthetic stretch."""
from types import SimpleNamespace

import pytest

from harness import program_spans, spec


def rec(frames, spans=None, counters=None):
    return SimpleNamespace(frames=frames, spans=spans or {}, counters=counters or {})


def test_stretch_is_the_trailing_records_that_sum_to_its_frames():
    warm, a, b, c = rec(8), rec(16), rec(16), rec(5)
    records = [warm, a, b, c]
    assert program_spans.stretch({"trace_frames": 37}, records) == [a, b, c]
    assert program_spans.stretch({"trace_frames": 5}, records) == [c]
    assert program_spans.stretch({"trace_frames": 45}, records) == records
    for frames in (40, 30, 46, 0, None):   # no trailing run sums to it
        assert program_spans.stretch({"trace_frames": frames}, records) is None
    assert program_spans.stretch({"trace_frames": 5}, []) is None


def test_stretch_without_the_program_module(monkeypatch):
    """A program that keeps no spans (the import fails) reads as nothing."""
    import sys
    import repro_torch.runtime
    from repro_torch.runtime import spans
    monkeypatch.setattr(spans, "records", [rec(5)])
    assert program_spans.stretch({"trace_frames": 5}) == spans.records
    monkeypatch.delattr(repro_torch.runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert program_spans.stretch({"trace_frames": 5}) is None


SYNTHETIC = [
    rec(8, {"engine.forward": [1, 0.5]}),   # the profiled warm-up batch, left out
    rec(10, {"engine.forward": [3, 0.30], "tome.merge": [4, 0.10], "tome.readback": [8, 0.06]},
        {"host_syncs": 8}),
    rec(6, {"engine.forward": [1, 0.02]}),
]


@pytest.mark.parametrize("metric, want", [
    ("forward_host_ms.sat", (0.30 + 0.02) / 4 * 1e3),
    ("readback_ms_per_batch.sat", 0.06 / 2 * 1e3),
    ("merge_issue_ms_per_batch.sat", (0.10 - 0.06) / 2 * 1e3),
    ("host_syncs_per_frame.sat", 8 / 16),
])
def test_reader_on_a_synthetic_stretch(metric, want, monkeypatch):
    from repro_torch.runtime import spans
    monkeypatch.setattr(spans, "records", SYNTHETIC)
    read = spec.reader(metric)
    assert read({"trace_frames": 16}) == pytest.approx(want)
    assert read({"trace_frames": 15}) is None
