"""``runtime.spans`` and its sites on the cloud path, on the CPU.

Off (no profiler session): no record, no ``record_function``, no clock.
Under ``torch.profiler.profile``: one record a ``run_cloud_batch`` call, with
its frames, one ``engine.forward`` a plan-cache lookup, one ``tome.merge`` a
merge layer and two read-backs each; the ranges nest in the profiler's
timeline around the ``aten::`` ops they issue; the logits do not change.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine
from repro_torch.core.bucketing import BucketTable
from repro_torch.models import param, vit
from repro_torch.runtime import spans

torch.set_num_threads(1)

CFG = vit.ViTConfig(img_res=32, patch=8, n_layers=4, d_model=32, n_heads=2, d_ff=64,
                    n_classes=8)   # 17 tokens
PLAIN = (0, 0, 0, 0)
MERGED = (3, 0, 2, 1)
NESTING = ["engine.cloud_batch", "engine.forward", "tome.merge", "tome.readback"]


def _params():
    return param.init_params(vit.specs(CFG), torch.Generator().manual_seed(0), device="cpu")


def _plans(params):
    """Three frames of a schedule that never merges, two of one that does."""
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(5, CFG.img_res, CFG.img_res, 3, generator=gen)
    plans = []
    for i, sched in enumerate([PLAIN] * 3 + [MERGED] * 2):
        x, sizes = engine.device_forward(params, CFG, images[i:i + 1], sched, 0)
        plans.append(engine.ExecPlan(sched, 0, x=x, sizes=sizes))
    return plans


def _run(params, plans, buckets=None, cache=None):
    engine.run_cloud_batch(cache or engine.CompiledPlanCache(), CFG, params, plans, buckets)
    return torch.cat([p.logits for p in plans])


def _refuse(*_a, **_k):
    raise AssertionError("called with the profiler off")


def test_off_by_default(monkeypatch):
    params = _params()
    plans = _plans(params)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(spans, "_clock", _refuse)
    before = list(spans.records)
    _run(params, plans)
    assert list(spans.records) == before and spans._open is None
    # one shared no-op context, whatever the name; a counter returns at once
    assert spans.span("a") is spans.span("b") is spans.batch("c", 3)
    assert spans.count("host_syncs") is None


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "bucketed"])
def test_record_of_one_batch(bucketed):
    params = _params()
    plans = _plans(params)
    buckets = BucketTable.build(CFG, (0.0,)) if bucketed else None
    cache = engine.CompiledPlanCache()
    with profile(activities=[ProfilerActivity.CPU]):
        n = len(spans.records)
        _run(params, plans, buckets, cache)
    assert len(spans.records) == n + 1 and spans._open is None
    rec = spans.records[-1]
    merges = sum(r > 0 for r in MERGED)
    assert rec.frames == len(plans)
    assert rec.spans["engine.cloud_batch"][0] == 1
    assert rec.spans["engine.forward"][0] == cache.hits + cache.misses == 2
    assert rec.spans["tome.merge"][0] == merges
    assert rec.spans["tome.readback"][0] == rec.counters["host_syncs"] == 2 * merges
    secs = {name: s for name, (_, s) in rec.spans.items()}
    assert all(s > 0 for s in secs.values())
    assert secs["engine.cloud_batch"] >= secs["engine.forward"] >= secs["tome.merge"] \
        >= secs["tome.readback"]


def test_ranges_nest_on_the_profiler_clock():
    params = _params()
    plans = _plans(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(params, plans)
    events = prof.events()
    by_name = {name: [e for e in events if e.name == name] for name in NESTING}
    assert [len(by_name[n]) for n in NESTING] == [1, 2, 3, 6]

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e

    for outer, inner in zip(NESTING, NESTING[1:]):
        for e in by_name[inner]:
            parent = next(a for a in ancestors(e) if a.name in NESTING)
            assert parent.name == outer, (inner, parent.name)
            assert parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= parent.time_range.end
    # the ops each span issues lie inside it, in the same timeline
    for name, op in [("engine.forward", "aten::matmul"), ("tome.merge", "aten::argsort"),
                     ("tome.readback", "aten::max")]:
        inside = [e for e in events if e.name == op
                  and any(a.name == name for a in ancestors(e))]
        assert inside, (name, op)


def test_logits_bit_equal_with_tracing_on():
    params = _params()
    off = _run(params, _plans(params))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _run(params, _plans(params))
    assert torch.equal(off, on)
