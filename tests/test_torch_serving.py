"""The port's serving tier against the reference's, on the timing plane.

Same workload specs (built from one dict on both sides), the same fitted
profile (each package's own profiler on the same numbers) and
``include_scheduler_overhead=False``: the port's ``FleetStats`` must be
bit-identical to the reference's, field by field, on the seed scenarios of
``tests/test_simcore.py``, a 3-region spillover fleet, a fault fleet, tiered
streams and a telemetry run. The port's own ``run()`` must equal its
``run_reference()`` where the oracle applies. The batchers, the circuit
breaker and the JSON specs give the same event sequences and documents.
"""
import dataclasses
import json
import math
import sys

import pytest
from conftest import small_model_profile

from repro.core import engine as jengine
from repro.launch import serve as jserve
from repro.runtime import fault_tolerance as jft
from repro.serving import batcher as jbatcher
from repro.serving import faults as jfaults
from repro.serving import telemetry as jtelemetry
from repro.serving import workload as jworkload

from repro_torch.core import engine, profiler, scheduler
from repro_torch.launch import serve
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.serving import batcher, faults, fleet, simcore, telemetry, workload

_FRAME_FIELDS = ("latency_s", "violated", "deviation", "alpha", "split",
                 "accuracy", "payload_bytes", "bandwidth_bps", "queue_s", "logits")
_WIFI = {"kind": "synthetic", "network": "wifi", "mobility": "static"}


def _port_profile():
    """``tests/conftest.py::small_model_profile`` built by the port's profiler."""
    d, dff, x0, n = 256, 1024, 145, 12
    grid = range(16, x0 + 1, 16)
    return scheduler.ModelProfile(
        n_layers=n, x0=x0, token_bytes=d * 1.0, raw_input_bytes=50_000,
        device=profiler.profile_platform(profiler.EDGE_PLATFORM, d, dff, grid),
        cloud=profiler.profile_platform(profiler.CLOUD_PLATFORM, d, dff, grid),
        device_embed_s=1e-3, cloud_embed_s=1e-4, head_s=1e-4)


def _three_cells():
    return [{"name": f"r{i}", "capacity": 2, "rtt_ms": rtt}
            for i, rtt in enumerate((0.0, 5.0, 10.0))]


SCENARIOS = {
    # the four seed scenarios of tests/test_simcore.py
    "closed-loop": dict(n_streams=8, n_frames=25, seed=3),
    "poisson-overload": dict(
        n_streams=8, n_frames=30, seed=3, network=_WIFI, capacity=1, max_batch=4,
        arrivals={"kind": "poisson", "rate_fps": 50.0, "max_inflight": 2}),
    "mmpp-burst": dict(
        n_streams=8, n_frames=30, seed=3, network=_WIFI, capacity=1, max_batch=1,
        arrivals={"kind": "mmpp", "rate_fps": 30.0, "burst_rate_fps": 200.0,
                  "p_burst": 0.15, "p_calm": 0.05, "max_inflight": 8},
        autoscale={"min_capacity": 1, "max_capacity": 8, "interval_s": 0.1,
                   "cooldown_s": 0.1, "high_util": 0.30, "low_util": 0.10}),
    "sla-mix": dict(
        n_streams=9, n_frames=25, seed=3, network=_WIFI, capacity=1, max_batch=4,
        arrivals={"kind": "poisson", "rate_fps": 5.0, "max_inflight": 6},
        sla_classes=["interactive", "standard", "batch"]),
    # heterogeneous device tiers and the predictive autoscaler
    "tiers": dict(
        n_streams=6, n_frames=20, seed=5, network=_WIFI, capacity=1, max_batch=4,
        tiers=["phone", "jetson", "laptop"],
        arrivals={"kind": "mmpp", "rate_fps": 2.0, "burst_rate_fps": 40.0,
                  "p_burst": 0.10, "p_calm": 0.05, "max_inflight": 12},
        autoscale={"min_capacity": 1, "max_capacity": 8, "interval_s": 0.10,
                   "cooldown_s": 0.10, "policy": "predictive", "lookahead_s": 0.3,
                   "ewma_alpha": 0.5}),
    # 3 regions with heavy spillover (tests/test_regions.py)
    "regions": dict(
        n_streams=64, n_frames=12, seed=11, network=_WIFI, max_batch=1,
        spill_slack_ms=2.0,
        regions=[{"name": "a", "capacity": 1}, {"name": "b", "capacity": 1, "rtt_ms": 3.0},
                 {"name": "c", "capacity": 1, "rtt_ms": 3.0}],
        arrivals={"kind": "mmpp", "rate_fps": 30.0, "burst_rate_fps": 300.0,
                  "p_burst": 0.2, "p_calm": 0.05, "max_inflight": 8}),
    # region outage, executor crash and a blackout (tests/test_faults.py)
    "faults": dict(
        n_streams=24, n_frames=15, seed=7, network=_WIFI, max_batch=4,
        spill_slack_ms=10.0, regions=_three_cells(),
        arrivals={"kind": "poisson", "rate_fps": 8.0, "max_inflight": 6},
        faults={"episodes": [
            {"kind": "region_outage", "start_s": 0.5, "duration_s": 0.4, "region": 0},
            {"kind": "executor_crash", "start_s": 0.3, "region": 1},
            {"kind": "blackout", "start_s": 0.3, "duration_s": 0.2, "stream": 1}]}),
}
_HAS_ORACLE = ("closed-loop", "poisson-overload", "mmpp-burst", "sla-mix", "tiers")


def _cfgs():
    return (jengine.EngineConfig(sla_s=0.3, include_scheduler_overhead=False),
            engine.EngineConfig(sla_s=0.3, include_scheduler_overhead=False))


def _runtimes(spec: dict):
    jcfg, cfg = _cfgs()
    jrt = jworkload.build_runtime(jworkload.WorkloadSpec.from_dict(spec),
                                  small_model_profile(), jcfg)
    rt = workload.build_runtime(workload.WorkloadSpec.from_dict(spec),
                                _port_profile(), cfg, device="cpu")
    return jrt, rt


def assert_fleet_stats_identical(a, b):
    """Every FleetStats field bit-identical (as tests/test_simcore.py compares
    them), plus per-region stats, recovery stats and the capacity timeline."""
    assert len(a.per_stream) == len(b.per_stream)
    for st_a, st_b in zip(a.per_stream, b.per_stream):
        assert len(st_a.frames) == len(st_b.frames)
        for fa, fb in zip(st_a.frames, st_b.frames):
            for field in _FRAME_FIELDS:
                assert getattr(fa, field) == getattr(fb, field), field
    for name in ("cloud_busy_s", "horizon_s", "capacity", "batch_sizes",
                 "dropped_per_stream", "capacity_timeline", "stream_classes",
                 "stream_regions", "violation_ratio", "drop_ratio", "p50_latency_s",
                 "p99_latency_s", "avg_queue_s", "avg_accuracy", "capacity_seconds",
                 "cloud_utilization", "avg_batch_size", "aggregate_fps",
                 "total_spilled", "unaccounted_frames"):
        assert getattr(a, name) == getattr(b, name), name
    assert list(a.per_class) == list(b.per_class)
    for cls in a.per_class:
        ca, cb = a.per_class[cls], b.per_class[cls]
        assert (ca.violation_ratio, ca.drop_ratio, ca.p50_latency_s,
                ca.p99_latency_s, ca.frames) == \
            (cb.violation_ratio, cb.drop_ratio, cb.p50_latency_s,
             cb.p99_latency_s, cb.frames)
    assert [dataclasses.asdict(r) for r in a.per_region] == \
        [dataclasses.asdict(r) for r in b.per_region]
    assert [vars(r) for r in a.recovery] == [vars(r) for r in b.recovery]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fleet_stats_bit_identical_to_reference(scenario):
    jrt, rt = _runtimes(SCENARIOS[scenario])
    fs = rt.run()
    assert_fleet_stats_identical(jrt.run(), fs)
    if scenario in _HAS_ORACLE:
        assert_fleet_stats_identical(rt.run_reference(), fs)
    if scenario == "poisson-overload":
        assert fs.drop_ratio > 0
    if scenario == "mmpp-burst":
        assert fs.peak_capacity > 1
    if scenario == "sla-mix":
        assert rt.priority and len(fs.per_class) == 3
    if scenario == "regions":
        assert fs.total_spilled > 0
    if scenario == "faults":
        assert fs.recovery[0].lost_offers > 0 and fs.unaccounted_frames == 0


def test_event_sequence_identical_to_reference():
    """The popped event stream (time, kind, payload) matches the reference's
    on a spilling, faulted fleet."""
    spec = dict(SCENARIOS["faults"], regions=SCENARIOS["regions"]["regions"],
                spill_slack_ms=2.0)
    jrt, rt = _runtimes(spec)
    from repro.serving import simcore as jsimcore
    ev_j, ev_t = [], []
    jsimcore.simulate(jrt, record=ev_j)
    simcore.simulate(rt, record=ev_t)
    assert any(kind == "enqueue" for _, kind, _ in ev_t)
    assert any(kind == "fault" for _, kind, _ in ev_t)
    assert ev_j == ev_t


@pytest.mark.parametrize("scenario", ["sla-mix", "regions", "faults"])
def test_telemetry_identical_to_reference(scenario):
    """Telemetry at full sampling: the same spans, decisions and windowed
    metrics as the reference's recorder, both reconcile, and the run stays
    bit-exact with the telemetry-off run."""
    jrt, rt = _runtimes(SCENARIOS[scenario])
    jtel = jtelemetry.Telemetry(jtelemetry.TelemetryConfig(stream_sample=1, frame_sample=1))
    tel = telemetry.Telemetry(telemetry.TelemetryConfig(stream_sample=1, frame_sample=1))
    fs_j, fs = jrt.run(telemetry=jtel), rt.run(telemetry=tel)
    assert_fleet_stats_identical(fs_j, fs)
    assert_fleet_stats_identical(rt.run(), fs)
    assert tel.spans == jtel.spans and tel.spans_total == jtel.spans_total > 0
    assert tel.decision_log() == jtel.decision_log()
    assert tel.metrics_summary() == jtel.metrics_summary()
    assert tel.chrome_trace() == jtel.chrome_trace()
    rec = tel.reconcile(fs)
    assert rec["ok"], rec
    assert rec == jtel.reconcile(fs_j)
    assert telemetry.format_window_summary(tel) == jtelemetry.format_window_summary(jtel)


def test_telemetry_writers_match_reference(tmp_path):
    jrt, rt = _runtimes(SCENARIOS["poisson-overload"])
    jtel, tel = jtelemetry.Telemetry(), telemetry.Telemetry()
    jrt.run(telemetry=jtel)
    rt.run(telemetry=tel)
    for writer in ("write_jsonl", "write_chrome_trace", "write_metrics"):
        getattr(jtel, writer)(str(tmp_path / f"j_{writer}"))
        getattr(tel, writer)(str(tmp_path / f"t_{writer}"))
        assert (tmp_path / f"j_{writer}").read_bytes() == \
            (tmp_path / f"t_{writer}").read_bytes(), writer


# ------------------------------------------------------------- unit parity

def _step_times(n_active):
    return 0.004 + 0.0015 * n_active


def test_continuous_batcher_and_slots_match_reference():
    def drive(lib):
        cb = lib.ContinuousBatcher(3, _step_times)
        for i in range(9):
            cb.submit(lib.Request(i, arrival_s=0.003 * i * i, max_new=2 + i % 4))
        log = []
        while cb.queue or cb.active:
            cb.step()
            log.append((cb.now, sorted(cb.active), cb.slots.in_use,
                        [(r.rid, r.slot, r.done_s) for r in cb.completed]))
        slots = lib.KVSlotManager(4)
        got = [slots.alloc() for _ in range(5)]
        slots.release(got[1])
        got += [slots.alloc(), slots.in_use]
        return log, got

    assert drive(batcher) == drive(jbatcher)


def test_priority_micro_batcher_matches_reference():
    def drive(lib):
        pb = lib.PriorityMicroBatcher(3, 0.010)
        fifo = lib.MicroBatcher(3, 0.010)
        classes = ("batch", "standard", "interactive")
        out = []
        for i in range(30):
            now = 0.0017 * i
            cls = classes[(i * 7) % 3]
            req = lib.Request(i, arrival_s=now, sla_class=cls, deadline_s=now + 0.05 * (1 + i % 3))
            for b in (pb, fifo):
                got = b.offer(req, now) or b.poll(now + 0.0005)
                out.append((b.deadline(), b.pending_count,
                            None if got is None else [r.rid for r in got]))
        out.append(([r.rid for r in pb.flush()], [r.rid for r in fifo.flush()]))
        return out

    assert drive(batcher) == drive(jbatcher)


def test_circuit_breaker_and_monitors_match_reference():
    def drive(lib):
        cb = lib.CircuitBreaker(lib.BreakerConfig(trip_after=2, open_s=0.5))
        log = []
        for t, ev in ((0.1, "f"), (0.2, "s"), (0.3, "f"), (0.4, "f"), (0.5, "f"),
                      (0.7, "a"), (0.95, "a"), (0.95, "d"), (1.0, "a"), (1.1, "f"),
                      (1.5, "a"), (1.7, "a"), (1.7, "d"), (1.8, "s"), (1.9, "a")):
            if ev == "f":
                cb.record_failure(t)
            elif ev == "s":
                cb.record_success(t)
            elif ev == "d":
                cb.note_dispatch(t)
            log.append((ev, cb.admits(t), cb.state, cb.trips, cb.opened_at,
                        cb.open_seconds(t)))
        hb = lib.HeartbeatMonitor(["w0", "w1", "w2"], timeout_steps=2)
        sd = lib.StragglerDetector(factor=1.5, patience=2)
        for step in range(6):
            hb.beat("w0")
            if step < 2:
                hb.beat("w1")
            log.append((hb.tick(), hb.alive(),
                        sd.observe({"w0": 1.0, "w1": 1.0, "w2": 2.0 + step})))
        log.append(lib.plan_elastic_mesh(13, 2))
        return log

    a, b = drive(ft), drive(jft)
    assert a[:-1] == b[:-1]
    assert vars(a[-1]) == vars(b[-1])


def test_workload_and_fault_spec_json_match_reference(tmp_path):
    spec = dict(SCENARIOS["faults"], name="chaos", tiers=["phone", "laptop"],
                sla_classes=["interactive", "batch"],
                autoscale={"min_capacity": 1, "max_capacity": 4},
                faults=dict(SCENARIOS["faults"]["faults"],
                            retry={"max_retries": 2, "backoff_base_s": 0.02},
                            breaker={"trip_after": 2, "open_s": 0.1}))
    ws, jws = workload.WorkloadSpec.from_dict(spec), jworkload.WorkloadSpec.from_dict(spec)
    assert ws.to_dict() == jws.to_dict()
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(ws.to_dict()))
    assert workload.WorkloadSpec.from_json(str(path)) == ws
    assert jworkload.WorkloadSpec.from_json(str(path)).to_dict() == ws.to_dict()
    fspec = faults.FaultSpec.from_dict(spec["faults"])
    assert fspec.to_dict() == jfaults.FaultSpec.from_dict(spec["faults"]).to_dict()
    assert faults.FaultSpec.from_dict(fspec.to_dict()) == fspec
    assert [fspec.retry.backoff_s(k) for k in range(5)] == \
        [jfaults.RetryConfig(**dataclasses.asdict(fspec.retry)).backoff_s(k) for k in range(5)]


def test_runtime_rejects_mesh_rules():
    _, cfg = _cfgs()
    spec = workload.WorkloadSpec.from_dict(SCENARIOS["closed-loop"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        workload.build_runtime(spec, _port_profile(), cfg, mesh_rules=object(),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        fleet.FleetRuntime(_port_profile(), cfg, [], mesh_rules=object(), device="cpu")


# -------------------------------------------------------------------- CLI

def _fleet_lines(main, argv, capsys, monkeypatch):
    """The CLI's output with the wall clock frozen, so billing the planner's
    measured overhead adds 0 on both sides (the timing plane is then exact)."""
    import time
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)
    main(argv)
    monkeypatch.undo()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", [
    ["--streams", "4", "--frames", "5"],
    ["--streams", "6", "--frames", "8", "--network", "wifi", "--mobility", "static",
     "--arrivals", "poisson", "--rate-fps", "30", "--max-inflight", "2",
     "--sla-classes", "interactive", "standard", "--regions", "2",
     "--region-rtt-ms", "0,20", "--fault-outage", "0@0.2+0.3", "--telemetry-sample", "1"],
])
def test_cli_fleet_report_matches_reference(argv, capsys, monkeypatch):
    ref = _fleet_lines(jserve.main, argv, capsys, monkeypatch)
    port = _fleet_lines(serve.main, argv + ["--device", "cpu"], capsys, monkeypatch)
    agg = [line for line in port if line.startswith("[fleet aggregate]")]
    assert len(agg) == 1 and agg == [x for x in ref if x.startswith("[fleet aggregate]")]
    assert port == ref


def test_cli_fleet_only_flags_and_mesh_are_refused():
    with pytest.raises(SystemExit):
        serve.main(["--arrivals", "poisson", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        serve.main(["--streams", "2", "--mesh", "dp", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        serve.main(["--streams", "2", "--mesh-model", "2", "--device", "cpu"])


def test_serving_names_match_reference():
    import repro.serving as jserving
    import repro_torch.serving as serving
    assert serving.__all__ == jserving.__all__
    for name in serving.__all__:
        assert hasattr(serving, name), name
    assert math.isinf(batcher.Request(0, 0.0).deadline_s)
    assert "repro_torch.serving.fleet" in sys.modules


def test_chip_smoke_fleet_traffic_prunes_and_cobatches():
    """The traffic of ``chip_smoke.py``'s fleet phase, on the timing plane
    (exact for its frames, none of which splits mid-model): streams
    co-batch, and Algorithm 1 prunes some frames both in the cloud and on
    the device, so merge layers run there. Under wifi static every frame
    would be cloud-only at α=0 and no merge layer would run."""
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import janus_vit_l384

    profile = serve.make_profile(janus_vit_l384.CONFIG)
    _, cfg = _cfgs()
    spec = chip_smoke._fleet_spec(workload)
    fs = workload.build_runtime(spec, profile, cfg, device="cpu").run()
    decisions = {(f.alpha, f.split) for f in fs.all_frames}
    n = profile.n_layers
    assert max(fs.batch_sizes) > 1
    assert {s for _, s in decisions} == {0, n + 1}
    assert any(a > 0 and s == 0 for a, s in decisions)
    assert any(a > 0 and s == n + 1 for a, s in decisions)
    static = dataclasses.replace(spec, network=workload.NetworkConfig("synthetic", "wifi", "static"),
                                 tiers=("uniform",))
    fs = workload.build_runtime(static, profile, cfg, device="cpu").run()
    assert {(f.alpha, f.split) for f in fs.all_frames} == {(0.0, 0)}
