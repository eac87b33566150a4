"""The port's fleet with ``execute=True`` against the reference's, on the CPU.

The reference's small ViT of ``tests/test_serving_fleet.py`` (32 px, 8-px
patches, 4 layers, d=32) with the reference's weights carried across by
``models/param.py::from_jax_params``, the same images (numpy, seeded) and
the same traces through both fleets, in f32. Tolerances, as
``tests/test_torch_engine.py`` states them: identical (α, split) per frame;
logits atol 1e-5; payload bytes within 1% and latency rel 1e-2 (an ulp in
the device activation can flip one int8 code and so the LZW length, which
the latency reads). Within the port: batched = per-item, N=1 fleet = the
single-stream engine, bucketed fleet = exact fleet.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_model_profile

import repro.models  # noqa: F401  (import models before sharding: circular import)
from repro.core import bandwidth as jbandwidth
from repro.core import engine as jengine
from repro.models import param as jparam
from repro.models import vit as jvit
from repro.serving import fleet as jfleet

from repro_torch.core import bandwidth, engine, pruning
from repro_torch.core.bucketing import BucketingConfig
from repro_torch.models import param, vit
from repro_torch.serving import fleet, workload

from test_torch_engine import _mixed_profile
from test_torch_engine import _port_profile as _to_port_profile
from test_torch_serving import _port_profile

# -n 6 workers, each running 8 intra-op threads on 8 cores, oversubscribe the CPU
# (a 2 s case took 150 s among six copies): one thread a worker
torch.set_num_threads(1)

KW = dict(img_res=32, patch=8, n_layers=4, d_model=32, n_heads=2, d_ff=64, n_classes=8)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = jvit.ViTConfig(**KW), vit.ViTConfig(**KW)
    jp = jparam.init_params(jvit.specs(jcfg), jax.random.key(0))
    images = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(np.float32)
    return jcfg, cfg, jp, param.from_jax_params(jax.tree.map(np.asarray, jp), "cpu"), images


# per-frame uplink rates under which the mixed profile's Algorithm 1 picks
# inner splits with merges, device-only frames and unpruned frames
_BPS = np.array([3e5, 1e6, 3e6, 1e7, 2e5, 5e5])


def _cfg(lib, sla_s=0.5):
    return lib.EngineConfig(sla_s=sla_s, execute=True, include_scheduler_overhead=False)


def _traces(lib, n_streams, frames, kind):
    if kind == "steady":  # co-batching streams (tests/test_serving_fleet.py)
        return [lib.NetworkTrace(np.full(frames, 80e6), 0.002, f"s{i}")
                for i in range(n_streams)]
    return [lib.NetworkTrace(np.roll(_BPS, i)[:frames], 0.005, f"m{i}")
            for i in range(n_streams)]


def _sla(kind):
    return 0.5 if kind == "steady" else 0.03


def _port_fleet(n_streams, frames, max_batch, kind="steady", bucketing=None):
    _, cfg, _, tp, images = _setup()
    streams = [fleet.StreamSpec(t, frames) for t in _traces(bandwidth, n_streams, frames, kind)]
    prof = _port_profile() if kind == "steady" else _to_port_profile(_mixed_profile())
    rt = fleet.FleetRuntime(
        prof, _cfg(engine, _sla(kind)), streams,
        cloud=fleet.CloudTierConfig(capacity=2, max_batch=max_batch, max_wait_s=0.02),
        model_cfg=cfg, params=tp, bucketing=bucketing, device="cpu")
    return rt, rt.run(images=torch.from_numpy(images))


def _ref_fleet(n_streams, frames, max_batch, kind="steady", bucketing=None):
    from repro.core.bucketing import BucketingConfig as JBucketingConfig
    jcfg, _, jp, _, images = _setup()
    streams = [jfleet.StreamSpec(t, frames)
               for t in _traces(jbandwidth, n_streams, frames, kind)]
    prof = small_model_profile() if kind == "steady" else _mixed_profile()
    rt = jfleet.FleetRuntime(
        prof, _cfg(jengine, _sla(kind)), streams,
        cloud=jfleet.CloudTierConfig(capacity=2, max_batch=max_batch, max_wait_s=0.02),
        model_cfg=jcfg, params=jp,
        bucketing=None if bucketing is None else JBucketingConfig(n_edges=bucketing.n_edges))
    return rt, rt.run(images=jnp.asarray(images))


def _assert_close_to(fs, ref_fs, payload_rel=0.01, latency_rel=1e-2):
    assert len(fs.all_frames) == len(ref_fs.all_frames) > 0
    for st, jst in zip(fs.per_stream, ref_fs.per_stream):
        assert len(st.frames) == len(jst.frames)
        for f, jf in zip(st.frames, jst.frames):
            assert (f.alpha, f.split) == (jf.alpha, jf.split)
            assert f.accuracy == jf.accuracy and f.bandwidth_bps == jf.bandwidth_bps
            assert abs(f.payload_bytes - jf.payload_bytes) <= payload_rel * jf.payload_bytes
            assert f.latency_s == pytest.approx(jf.latency_s, rel=latency_rel)
            assert f.logits is not None and jf.logits is not None
            np.testing.assert_allclose(f.logits.numpy(), np.asarray(jf.logits), atol=1e-5)


@pytest.mark.parametrize("kind,n_edges", [("steady", None), ("mixed", None),
                                          ("mixed", 2)])
def test_execute_fleet_matches_reference(kind, n_edges):
    bucketing = None if n_edges is None else BucketingConfig(n_edges=n_edges)
    n_streams, frames = (4, 3) if kind == "steady" else (6, 4)
    rt, fs = _port_fleet(n_streams, frames, max_batch=n_streams, kind=kind,
                         bucketing=bucketing)
    jrt, jfs = _ref_fleet(n_streams, frames, max_batch=n_streams, kind=kind,
                          bucketing=bucketing)
    _assert_close_to(fs, jfs)
    assert fs.batch_sizes == jfs.batch_sizes
    if kind == "steady":
        assert fs.avg_batch_size > 1.0, "steady streams must co-batch"
    else:
        decisions = {(f.alpha, f.split) for f in fs.all_frames}
        assert {s for _, s in decisions} >= {1, 7} and max(a for a, _ in decisions) > 0, \
            f"decisions must mix inner splits, device-only frames and merges: {decisions}"
    if n_edges is not None:
        assert rt.buckets.as_json() == jrt.buckets.as_json()
    assert rt.plan_cache.traces_by_kind == jrt.plan_cache.traces_by_kind


def test_batched_execute_equals_per_item_and_split_inference():
    """Micro-batched cloud partitions (one stacked forward per geometry)
    equal per-item execution (max_batch=1) and the split_inference round
    trip of each frame's decision."""
    rt_b, fs_b = _port_fleet(4, 3, max_batch=4)
    _, fs_u = _port_fleet(4, 3, max_batch=1)
    assert fs_b.avg_batch_size > 1.0 and fs_u.avg_batch_size == 1.0
    _, cfg, _, tp, images = _setup()
    prof = rt_b.engines[0].profile
    n_exec, n_prof = cfg.n_layers, prof.n_layers
    for fb, fu in zip(fs_b.all_frames, fs_u.all_frames):
        assert (fb.alpha, fb.split) == (fu.alpha, fu.split)
        np.testing.assert_allclose(fb.logits.numpy(), fu.logits.numpy(), atol=1e-5, rtol=1e-5)
        sched = tuple(pruning.make_schedule(prof.schedule_kind, fb.alpha, n_exec,
                                            cfg.num_tokens))
        split_exec = n_exec + 1 if fb.split >= n_prof + 1 else \
            min(round(fb.split * n_exec / n_prof), n_exec)
        ref, _ = engine.split_inference(tp, cfg, torch.from_numpy(images), sched,
                                        split_exec, quantize=True)
        np.testing.assert_allclose(fb.logits.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_fleet_shares_one_plan_cache_across_streams():
    rt, _ = _port_fleet(4, 2, max_batch=4)
    assert all(e.plan_cache is rt.plan_cache for e in rt.engines)
    assert rt.plan_cache.traces == 2, rt.plan_cache.traces_by_kind
    assert rt.plan_cache.hits > 0


def test_n1_fleet_matches_run_trace():
    """One stream, max_batch=1: the fleet reproduces the single-stream engine
    (latencies, payloads and logits bit for bit)."""
    _, cfg, _, tp, images = _setup()
    img = torch.from_numpy(images)
    trace = bandwidth.synthetic_trace("wifi", "walking", steps=8, seed=5)
    eng = engine.JanusEngine(_port_profile(), _cfg(engine), model_cfg=cfg, params=tp,
                             device="cpu")
    st_engine = eng.run_trace(trace, 8, "janus", images=img)
    fs = fleet.FleetRuntime(_port_profile(), _cfg(engine), [fleet.StreamSpec(trace, 8)],
                            cloud=fleet.CloudTierConfig(max_batch=1), model_cfg=cfg,
                            params=tp, device="cpu").run(images=img)
    st_fleet = fs.per_stream[0]
    assert [f.latency_s for f in st_fleet.frames] == [f.latency_s for f in st_engine.frames]
    assert [f.payload_bytes for f in st_fleet.frames] == \
        [f.payload_bytes for f in st_engine.frames]
    for ff, fe in zip(st_fleet.frames, st_engine.frames):
        assert torch.equal(ff.logits, fe.logits)


def test_bucketed_fleet_equals_exact_fleet():
    """Bucketing changes which stacked geometry fills the logits, never the
    timing plane, and the logits only within float reassociation."""
    rt0, fs0 = _port_fleet(6, 4, max_batch=6, kind="mixed")
    rt1, fs1 = _port_fleet(6, 4, max_batch=6, kind="mixed",
                           bucketing=BucketingConfig(n_edges=2))
    assert rt1.buckets is not None and rt1.buckets.n_cells > 0
    for f0, f1 in zip(fs0.all_frames, fs1.all_frames):
        assert (f0.alpha, f0.split, f0.latency_s, f0.payload_bytes, f0.queue_s) == \
            (f1.alpha, f1.split, f1.latency_s, f1.payload_bytes, f1.queue_s)
        np.testing.assert_allclose(f0.logits.numpy(), f1.logits.numpy(), atol=1e-5, rtol=1e-5)
    assert fs0.batch_sizes == fs1.batch_sizes
    assert rt1.plan_cache.traces_by_kind.get("cloud_padded", 0) <= \
        max(rt0.plan_cache.traces_by_kind.get("cloud", 0), 1)


def test_build_runtime_executes_with_telemetry():
    """``workload.build_runtime`` on the CPU with execute: frames conserved,
    logits on every executed frame, and the telemetry reconciles."""
    from repro_torch.serving import telemetry
    _, cfg, _, tp, images = _setup()
    spec = workload.WorkloadSpec.from_dict(dict(
        n_streams=4, n_frames=4, seed=3, capacity=2, max_batch=4,
        network={"kind": "synthetic", "network": "wifi", "mobility": "static"},
        arrivals={"kind": "poisson", "rate_fps": 10.0, "max_inflight": 4}))
    rt = workload.build_runtime(spec, _port_profile(), _cfg(engine), model_cfg=cfg,
                                params=tp, bucketing=BucketingConfig(n_edges=2),
                                device="cpu")
    tel = telemetry.Telemetry(telemetry.TelemetryConfig(stream_sample=1))
    fs = rt.run(images=torch.from_numpy(images), telemetry=tel)
    for st, dropped in zip(fs.per_stream, fs.dropped_per_stream):
        assert len(st.frames) + dropped == spec.n_frames
    assert all(f.logits is not None and f.logits.shape == (1, cfg.n_classes)
               for f in fs.all_frames)
    assert tel.reconcile(fs)["ok"]


def test_cli_fleet_execute_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--streams", "4", "--frames", "5", "--execute", "--bucket-edges", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[fleet aggregate] frames=20 " in out
    assert "[fleet execute] plan_cache" in out and "bucket_cells=" in out
