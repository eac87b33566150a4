"""Janus serving driver, PyTorch port of ``repro.launch.serve``.

Drives the Janus stack (profiler fit, dynamic scheduler, split execution
with LZW transport) over synthetic dynamic network traces. The timing plane
models the paper's ViT-L@384; ``--execute`` also runs the real split-model
math on the same reduced ViT the reference CLI executes, on ``--device``
(``cuda`` by default; there is no silent CPU fallback).

Single stream (the paper's §V-B policy table):

  PYTHONPATH=src python -m repro_torch.launch.serve --network 4g \
      --mobility driving --frames 60 --sla-ms 300 [--execute] [--device cpu]

Fleet mode (``--streams N`` or ``--workload spec.json``): N client streams,
each with its own seeded trace, estimator and scheduler state, sharing one
cloud tier with finite batched capacity (``repro_torch.serving.fleet``),
with the reference's workload, region, fault and telemetry flags and its
printed report:

  PYTHONPATH=src python -m repro_torch.launch.serve --streams 8 --device cpu
  python -m repro_torch.launch.serve --streams 4 --frames 5 --execute \
      --bucket-edges 2            # on a card: cloud batches on the kernels

With ``--execute``, ``--mesh dp|tp`` shards the partitions over the host
mesh (``launch.mesh.make_host_mesh``, ``--mesh-model`` ranks on its
"model" axis): one process on ``--device``, or one process a rank under
``torchrun``, where rank 0 alone prints:

  PYTHONPATH=src python -m repro_torch.launch.serve --streams 2 --execute \
      --mesh dp --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --streams 2 --execute --device cpu --mesh tp --mesh-model 2
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import time

import torch

from repro_torch.configs import janus_vit_l384
from repro_torch.core import bandwidth, bucketing as bucketing_lib, engine, planner, \
    profiler, scheduler
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import param as param_lib
from repro_torch.models import vit as vit_lib
from repro_torch.runtime.device import resolve_device
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import fleet as fleet_lib
from repro_torch.serving import sla as sla_lib
from repro_torch.serving import telemetry as telemetry_lib
from repro_torch.serving import workload as workload_lib
from repro_torch.sharding.rules import make_rules


def make_profile(cfg: vit_lib.ViTConfig) -> scheduler.ModelProfile:
    grid = range(32, cfg.num_tokens + 1, max(cfg.num_tokens // 16, 16))
    dev = profiler.profile_platform(profiler.EDGE_PLATFORM, cfg.d_model, cfg.d_ff, grid)
    cloud = profiler.profile_platform(profiler.CLOUD_PLATFORM, cfg.d_model, cfg.d_ff, grid)
    pdim = cfg.patch * cfg.patch * 3
    return scheduler.ModelProfile(
        n_layers=cfg.n_layers, x0=cfg.num_tokens,
        token_bytes=cfg.d_model * 1.0,          # int8-quantized + LZW transport
        raw_input_bytes=cfg.img_res * cfg.img_res * 3 * 0.35,  # LZW'd frame
        device=dev, cloud=cloud,
        device_embed_s=profiler.EDGE_PLATFORM.embed_latency(cfg.num_tokens, cfg.d_model, pdim),
        cloud_embed_s=profiler.CLOUD_PLATFORM.embed_latency(cfg.num_tokens, cfg.d_model, pdim),
        head_s=profiler.CLOUD_PLATFORM.head_latency(cfg.d_model, cfg.n_classes))


def _faults_from_args(args) -> faults_lib.FaultSpec | None:
    """Fault-episode shorthands: ``--fault-outage R@START+DUR`` /
    ``--fault-crash R@T`` / ``--fault-blackout S@START+DUR`` (indices are
    region/stream numbers; times in seconds of sim time)."""
    def _at(s):          # "idx@start" -> (idx, start)
        idx, t = s.split("@", 1)
        return int(idx), float(t)

    def _window(s):      # "idx@start+dur" -> (idx, start, dur)
        idx, rest = s.split("@", 1)
        start, dur = rest.split("+", 1)
        return int(idx), float(start), float(dur)

    episodes = []
    for s in args.fault_outage:
        r, start, dur = _window(s)
        episodes.append(faults_lib.FaultEpisode(
            "region_outage", start_s=start, duration_s=dur, region=r))
    for s in args.fault_crash:
        r, start = _at(s)
        episodes.append(faults_lib.FaultEpisode(
            "executor_crash", start_s=start, region=r))
    for s in args.fault_blackout:
        si, start, dur = _window(s)
        episodes.append(faults_lib.FaultEpisode(
            "blackout", start_s=start, duration_s=dur, stream=si))
    if not episodes:
        return None
    breaker = None if args.no_fault_breaker else faults_lib.BreakerConfig(
        trip_after=args.fault_breaker_k,
        open_s=args.fault_breaker_open_ms / 1e3)
    return faults_lib.FaultSpec(
        episodes=tuple(episodes),
        retry=faults_lib.RetryConfig(
            max_retries=args.fault_retries,
            backoff_base_s=args.fault_backoff_ms / 1e3,
            backoff_cap_s=args.fault_backoff_cap_ms / 1e3),
        breaker=breaker)


def spec_from_args(args) -> workload_lib.WorkloadSpec:
    """Compose a WorkloadSpec from ``--workload spec.json`` or the shorthand
    flags (``--arrivals/--tiers/--trace-csv/--autoscale`` + classic knobs)."""
    if args.workload:
        return workload_lib.WorkloadSpec.from_json(args.workload)
    arrivals = workload_lib.ArrivalConfig(
        kind=args.arrivals, rate_fps=args.rate_fps,
        burst_rate_fps=args.burst_rate_fps, period_s=args.period_ms / 1e3,
        max_inflight=args.max_inflight,
        diurnal_period_s=args.diurnal_period_s,
        diurnal_amplitude=args.diurnal_amplitude)
    if args.trace_csv:
        network = workload_lib.NetworkConfig(kind="csv", path=args.trace_csv,
                                             rtt_ms=args.trace_rtt_ms)
    else:
        network = workload_lib.NetworkConfig(network=args.network,
                                             mobility=args.mobility)
    autoscale = None
    if args.autoscale:
        autoscale = fleet_lib.AutoscaleConfig(min_capacity=args.autoscale_min,
                                              max_capacity=args.autoscale_max,
                                              policy=args.autoscale_policy)
    regions = ()
    if args.regions > 1 or args.region_rtt_ms:
        rtts = [float(v) for v in args.region_rtt_ms.split(",")] \
            if args.region_rtt_ms else []
        n = max(args.regions, len(rtts), 1)
        rtts += [0.0] * (n - len(rtts))
        regions = tuple(workload_lib.RegionConfig(name=f"r{i}", rtt_ms=rtts[i])
                        for i in range(n))
    return workload_lib.WorkloadSpec(
        n_streams=args.streams, n_frames=args.frames, policy=args.policy,
        sla_ms=args.sla_ms, seed=args.seed, arrivals=arrivals,
        tiers=tuple(args.tiers), sla_classes=tuple(args.sla_classes),
        network=network,
        capacity=args.capacity or None, max_batch=args.max_batch or None,
        max_wait_ms=args.batch_wait_ms, autoscale=autoscale,
        regions=regions, spill_slack_ms=args.spill_slack_ms,
        faults=_faults_from_args(args))


def run_fleet(args, profile, eng_cfg, model_cfg=None, params=None, images=None,
              device=None):
    """Fleet mode: a workload scenario through one shared cloud tier."""
    spec = spec_from_args(args)
    bucketing = mesh_rules = None
    if args.execute and args.bucket_edges > 0:
        bucketing = bucketing_lib.BucketingConfig(n_edges=args.bucket_edges)
    if args.execute and args.mesh:
        mesh_rules = make_rules(args.mesh, make_host_mesh(model=args.mesh_model,
                                                          device=device))
    rt = workload_lib.build_runtime(spec, profile, eng_cfg,
                                    model_cfg=model_cfg, params=params,
                                    bucketing=bucketing, mesh_rules=mesh_rules,
                                    device=device)
    cloud = rt.cloud
    tel = None
    if args.telemetry_sample > 0:
        tel = telemetry_lib.Telemetry(telemetry_lib.TelemetryConfig(
            stream_sample=args.telemetry_sample))
    t0 = time.perf_counter()
    fs = rt.run(images=images, telemetry=tel)
    sim_wall = time.perf_counter() - t0

    print(f"[fleet] workload={spec.name} streams={spec.n_streams} "
          f"frames/stream={spec.n_frames} policy={spec.policy} "
          f"arrivals={spec.arrivals.kind} sla={spec.sla_ms or args.sla_ms}ms "
          f"cloud(capacity={cloud.capacity} max_batch={cloud.max_batch} "
          f"wait={cloud.max_wait_s*1e3:.1f}ms"
          f"{' autoscale' if spec.autoscale else ''})")
    print(f"{'stream':>6s} {'class':12s} {'tier':8s} {'trace':24s} "
          f"{'viol%':>6s} {'p50_ms':>8s} {'p99_ms':>9s} {'queue_ms':>9s} "
          f"{'drop%':>6s}")
    for si, st in enumerate(fs.per_stream):
        spec_si = rt.streams[si]
        offered = len(st.frames) + fs.dropped_per_stream[si]
        drop = fs.dropped_per_stream[si] / offered if offered else 0.0
        print(f"{si:6d} {spec_si.sla_class:12s} {spec_si.tier or 'uniform':8s} "
              f"{spec_si.trace.name[:24]:24s} {100*st.violation_ratio:6.1f} "
              f"{st.p50_latency_s*1e3:8.1f} {st.p99_latency_s*1e3:9.1f} "
              f"{st.avg_queue_s*1e3:9.2f} {100*drop:6.1f}")
    if len(fs.per_class) > 1:
        print(f"[fleet per-class] admission="
              f"{'priority' if rt.priority else 'fifo'}")
        for name, cs in fs.per_class.items():
            print(f"  {name:12s} frames={cs.frames:5d} "
                  f"viol%={100*cs.violation_ratio:5.1f} "
                  f"p50={cs.p50_latency_s*1e3:7.1f}ms "
                  f"p99={cs.p99_latency_s*1e3:8.1f}ms "
                  f"queue={cs.avg_queue_s*1e3:7.2f}ms "
                  f"drop%={100*cs.drop_ratio:5.1f}")
    print(f"[fleet aggregate] frames={len(fs.all_frames)} "
          f"viol%={100*fs.violation_ratio:.1f} p50={fs.p50_latency_s*1e3:.1f}ms "
          f"p99={fs.p99_latency_s*1e3:.1f}ms queue={fs.avg_queue_s*1e3:.2f}ms "
          f"drop%={100*fs.drop_ratio:.1f} "
          f"cloud_util={100*fs.cloud_utilization:.1f}% "
          f"avg_batch={fs.avg_batch_size:.2f} fps={fs.aggregate_fps:.1f} "
          f"accuracy={fs.avg_accuracy:.4f}")
    n_done = len(fs.all_frames)
    print(f"[fleet simcore] wall={sim_wall:.3f}s "
          f"per-frame={sim_wall / n_done * 1e6 if n_done else 0.0:.1f}us "
          f"(event-heap core; see benchmarks/fleet_scale_bench.py)")
    if args.execute:
        pc = rt.plan_cache
        by_kind = " ".join(f"{k}={v}" for k, v in
                           sorted(pc.traces_by_kind.items())) or "none"
        buckets = f" bucket_cells={rt.buckets.n_cells}" if rt.buckets else ""
        mesh = f" mesh={tuple(rt.mesh_rules.shape.items())}" \
            if rt.mesh_rules is not None else ""
        print(f"[fleet execute] plan_cache hits={pc.hits} misses={pc.misses} "
              f"traces={pc.traces} ({by_kind}){buckets}{mesh}")
    if spec.autoscale is not None:
        print(f"[fleet autoscale] capacity peak={fs.peak_capacity} "
              f"final={fs.final_capacity} "
              f"capacity_seconds={fs.capacity_seconds:.2f} "
              f"changes={len(fs.capacity_timeline) - 1}")
    if fs.per_region:
        print(f"[fleet regions] cells={len(fs.per_region)} "
              f"spill%={100*fs.spill_ratio:.1f} "
              f"spill_slack={rt.spill_slack_s*1e3:.0f}ms")
        for rs in fs.per_region:
            print(f"  {rs.name:10s} cap={rs.capacity:4d} "
                  f"rtt+={rs.rtt_offset_s*1e3:5.1f}ms "
                  f"util={100*rs.utilization:5.1f}% "
                  f"offered={rs.offered:6d} served={rs.served:6d} "
                  f"spill%={100*rs.spill_ratio:5.1f} "
                  f"cap_s={rs.capacity_seconds:8.2f}")
    if fs.recovery:
        print(f"[fleet recovery] lost={fs.total_lost_offers} "
              f"retries={fs.total_retries} degraded={fs.total_degraded} "
              f"unaccounted={fs.unaccounted_frames} "
              f"mttr={fs.mean_time_to_recover_s*1e3:.1f}ms "
              f"viol%(outage)={100*fs.violation_ratio_during_outage:.1f} "
              f"viol%(steady)={100*fs.violation_ratio_steady:.1f}")
        for rec in fs.recovery:
            print(f"  {rec.name:10s} outages={rec.outages} "
                  f"dark={rec.outage_s:5.2f}s lost={rec.lost_offers:4d} "
                  f"retries={rec.retries:4d} degraded={rec.degraded:4d} "
                  f"trips={rec.breaker_trips} "
                  f"open={rec.breaker_open_s:5.2f}s "
                  f"mttr={rec.mean_time_to_recover_s*1e3:7.1f}ms")
    if tel is not None:
        print(telemetry_lib.format_window_summary(tel))
        rec = tel.reconcile(fs)
        print(f"[fleet telemetry] sample=1/{args.telemetry_sample} "
              f"spans={tel.spans_total} frame_spans={tel.frame_spans} "
              f"decisions={tel.decisions_total} "
              f"reconcile={'ok' if rec['ok'] else 'MISMATCH ' + repr(rec)}")
        if args.trace_out:
            if args.trace_out.endswith(".jsonl"):
                tel.write_jsonl(args.trace_out)
                print(f"[fleet telemetry] raw span/decision feed -> "
                      f"{args.trace_out}")
            else:
                tel.write_chrome_trace(args.trace_out)
                print(f"[fleet telemetry] Chrome trace (open in Perfetto) "
                      f"-> {args.trace_out}")
        if args.metrics_out:
            tel.write_metrics(args.metrics_out)
            print(f"[fleet telemetry] windowed metrics -> "
                  f"{args.metrics_out}")
    return fs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="4g", choices=["4g", "5g", "wifi"])
    ap.add_argument("--mobility", default="driving",
                    choices=["static", "walking", "driving"])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sla-ms", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--execute", action="store_true",
                    help="run real split-model math on a reduced ViT")
    ap.add_argument("--bucket-edges", type=int, default=0,
                    help="with --execute: bucket cloud-partition token "
                         "counts to at most N edges per split so mixed-α "
                         "frames share stacked geometries (0 = exact "
                         "geometries; see docs/execution.md)")
    ap.add_argument("--mesh", default="",
                    choices=["", "dp", "tp"],
                    help="with --execute: shard the partitions over the host "
                         "mesh (dp = data-parallel fleet batch, tp = + "
                         "tensor-parallel heads/MLP); one rank a process, "
                         "several under torchrun")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size of the --mesh host mesh")
    ap.add_argument("--streams", type=int, default=0,
                    help="fleet mode: N concurrent client streams through a "
                         "shared cloud tier (0 = classic single-stream mode)")
    ap.add_argument("--policy", default="janus",
                    choices=["janus", "device", "cloud", "mixed"],
                    help="fleet mode: per-stream scheduling policy")
    ap.add_argument("--capacity", type=int, default=0,
                    help="fleet mode: concurrent cloud batch executors "
                         "(0 = scale with stream count)")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="fleet mode: micro-batch size (0 = min(8, streams))")
    ap.add_argument("--batch-wait-ms", type=float, default=5.0,
                    help="fleet mode: micro-batch deadline window")
    ap.add_argument("--period-ms", type=float, default=0.0,
                    help="fleet mode: min frame spacing per stream")
    ap.add_argument("--workload", default="",
                    help="fleet mode: JSON WorkloadSpec scenario (overrides "
                         "the shorthand workload flags below)")
    ap.add_argument("--arrivals", default="closed",
                    choices=["closed", "poisson", "mmpp", "diurnal"],
                    help="per-stream arrival process (open-loop kinds drop "
                         "overload arrivals when --max-inflight is set; "
                         "'trace' schedules need a JSON --workload spec)")
    ap.add_argument("--rate-fps", type=float, default=10.0,
                    help="open-loop arrival rate (poisson / mmpp calm state "
                         "/ diurnal mean)")
    ap.add_argument("--burst-rate-fps", type=float, default=40.0,
                    help="mmpp burst-state arrival rate")
    ap.add_argument("--diurnal-period-s", type=float, default=60.0,
                    help="diurnal arrivals: day-cycle period (compressed)")
    ap.add_argument("--diurnal-amplitude", type=float, default=0.8,
                    help="diurnal arrivals: rate swing in [0, 1]")
    ap.add_argument("--max-inflight", type=int, default=0,
                    help="per-stream admission bound (0 = unbounded)")
    ap.add_argument("--tiers", nargs="+", default=["uniform"],
                    help="device tiers assigned round-robin to streams "
                         f"(known: {sorted(workload_lib.DEVICE_TIERS)})")
    ap.add_argument("--sla-classes", nargs="+", default=["standard"],
                    help="SLA classes assigned round-robin to streams "
                         f"(known: {sorted(sla_lib.DEFAULT_SLA_CLASSES)}); "
                         "more than one class enables priority "
                         "micro-batching in the shared cloud tier")
    ap.add_argument("--trace-csv", default="",
                    help="replay real network traces: one CSV file (shared) "
                         "or a directory of *.csv (round-robin per stream)")
    ap.add_argument("--trace-rtt-ms", type=float, default=42.2,
                    help="RTT to pair with --trace-csv traces")
    ap.add_argument("--autoscale", action="store_true",
                    help="dynamic cloud capacity scaling (see "
                         "--autoscale-policy)")
    ap.add_argument("--autoscale-min", type=int, default=1)
    ap.add_argument("--autoscale-max", type=int, default=16)
    ap.add_argument("--autoscale-policy", default="utilization",
                    choices=list(fleet_lib.AUTOSCALE_POLICIES),
                    help="reactive windowed utilization (default) or "
                         "predictive EWMA arrival-rate forecasting")
    ap.add_argument("--regions", type=int, default=1,
                    help="regional cloud cells (streams homed round-robin; "
                         "capacity split evenly unless --workload sets it; "
                         "1 = the classic single shared tier)")
    ap.add_argument("--region-rtt-ms", default="",
                    help="comma-separated extra RTT per region, e.g. "
                         "'0,20,60' (missing entries default to 0; implies "
                         "--regions len(list))")
    ap.add_argument("--spill-slack-ms", type=float, default=25.0,
                    help="home-region queue delay past which a frame spills "
                         "to the cheapest other region")
    ap.add_argument("--fault-outage", action="append", default=[],
                    metavar="R@START+DUR",
                    help="fleet mode: region R goes dark from START for DUR "
                         "seconds (capacity -> 0, in-flight batches lost); "
                         "repeatable")
    ap.add_argument("--fault-crash", action="append", default=[],
                    metavar="R@T",
                    help="fleet mode: one executor of region R crashes at T "
                         "seconds, killing its running batch; repeatable")
    ap.add_argument("--fault-blackout", action="append", default=[],
                    metavar="S@START+DUR",
                    help="fleet mode: stream S's uplink drops to 0 bandwidth "
                         "from START for DUR seconds; repeatable")
    ap.add_argument("--fault-retries", type=int, default=3,
                    help="retry budget per lost cloud offer (0 = naive: "
                         "degrade to device-only immediately)")
    ap.add_argument("--fault-backoff-ms", type=float, default=10.0,
                    help="retry backoff base (doubles per attempt)")
    ap.add_argument("--fault-backoff-cap-ms", type=float, default=160.0,
                    help="retry backoff cap")
    ap.add_argument("--fault-breaker-k", type=int, default=3,
                    help="circuit breaker trips after K consecutive losses "
                         "to a region")
    ap.add_argument("--fault-breaker-open-ms", type=float, default=250.0,
                    help="how long a tripped breaker stays open before its "
                         "half-open probe")
    ap.add_argument("--no-fault-breaker", action="store_true",
                    help="disable per-region circuit breakers")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="fleet mode: write the telemetry span trace; a "
                         ".jsonl suffix writes the raw span/decision feed, "
                         "anything else a Chrome trace-event JSON loadable "
                         "in Perfetto (ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="fleet mode: write windowed metrics (per ~1s of "
                         "sim time: queue depth, utilization, spill ratio, "
                         "exact p50/p99 per region and SLA class) as JSON")
    ap.add_argument("--telemetry-sample", type=int, default=16,
                    help="record spans/decisions for every K-th stream "
                         "(counters stay exact regardless; 0 disables "
                         "telemetry entirely, 1 records every stream)")
    ap.add_argument("--planner", default="tables", choices=["tables", "legacy"],
                    help="Algorithm-1 implementation: vectorized planner "
                         "tables (default) or the reference pure-Python loop")
    ap.add_argument("--step-planner", type=int, default=0, metavar="EDGES",
                    help="price plans on bucket-edge latency plateaus: wrap "
                         "the cloud profile in a StepProfiler at <= EDGES "
                         "bucket edges per split, so the planner snaps α to "
                         "the least-pruned member of each plateau (0 = the "
                         "paper's smooth linear model; see docs/planner.md)")
    ap.add_argument("--alpha-step", type=float, default=0.01,
                    help="Algorithm-1 α-scan step t (PlannerConfig.t)")
    ap.add_argument("--split-spacing", type=int, default=5,
                    help="fine-to-coarse split-candidate spacing k "
                         "(PlannerConfig.k)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cuda, or cpu)")
    args = ap.parse_args(argv)
    if int(os.environ.get("RANK", "0")) != 0:  # under torchrun, rank 0 alone prints
        with contextlib.redirect_stdout(io.StringIO()):
            return _serve(args, ap)
    return _serve(args, ap)


def _serve(args, ap) -> None:
    if args.streams <= 0 and not args.workload:
        # classic single-stream mode: fail loudly instead of silently
        # ignoring fleet-only workload flags
        fleet_only = [flag for flag, used in [
            ("--arrivals", args.arrivals != "closed"),
            ("--max-inflight", args.max_inflight != 0),
            ("--tiers", args.tiers != ["uniform"]),
            ("--sla-classes", args.sla_classes != ["standard"]),
            ("--trace-csv", bool(args.trace_csv)),
            ("--autoscale", args.autoscale),
            ("--regions", args.regions > 1 or bool(args.region_rtt_ms)),
            ("--fault-*", bool(args.fault_outage or args.fault_crash
                               or args.fault_blackout)),
            ("--trace-out", bool(args.trace_out)),
            ("--metrics-out", bool(args.metrics_out)),
        ] if used]
        if fleet_only:
            ap.error(f"{' '.join(fleet_only)} only work in fleet mode "
                     "(--streams N or --workload spec.json)")

    device = resolve_device(args.device)
    profile = make_profile(janus_vit_l384.CONFIG)  # timing plane: ViT-L@384
    planner_cfg = planner.PlannerConfig(t=args.alpha_step,
                                        k=args.split_spacing)
    if args.step_planner > 0:
        profile = planner.step_aware_profile(
            profile, bucketing_lib.BucketingConfig(n_edges=args.step_planner),
            planner_cfg)
    tables = planner.tables_for(profile, planner_cfg)
    if args.planner == "legacy":  # measure the implementation actually used
        dec = scheduler._reference_schedule(profile, 10e6, 0.02,
                                            args.sla_ms / 1e3,
                                            t=planner_cfg.t, k=planner_cfg.k)
    else:
        dec = tables.decide(10e6, 0.02, args.sla_ms / 1e3)  # representative state
    model_kind = f"step(<={args.step_planner}/split)" if args.step_planner \
        else "linear"
    print(f"[planner] {args.planner}: latency_model={model_kind} "
          f"alpha_grid={len(tables.alpha_grid)} "
          f"splits={len(tables.candidates)} "
          f"decide={dec.scheduler_overhead_s*1e6:.0f}us/frame")

    params = model_cfg = images = None
    if args.execute:
        model_cfg = janus_vit_l384.SMOKE
        params = param_lib.init_params(vit_lib.specs(model_cfg),
                                       torch.Generator().manual_seed(0), device)
        images = torch.randn((1, model_cfg.img_res, model_cfg.img_res, 3),
                             generator=torch.Generator().manual_seed(1)).to(device)

    eng_cfg = engine.EngineConfig(sla_s=args.sla_ms / 1e3, execute=args.execute,
                                  planner=args.planner,
                                  planner_cfg=planner_cfg)
    if args.streams > 0 or args.workload:
        run_fleet(args, profile, eng_cfg, model_cfg=model_cfg, params=params,
                  images=images, device=device)
        return

    trace = bandwidth.synthetic_trace(args.network, args.mobility,
                                      steps=args.frames, seed=args.seed)
    eng = engine.JanusEngine(profile, eng_cfg, model_cfg=model_cfg, params=params,
                             device=device)

    print(f"[serve] trace={trace.name} sla={args.sla_ms}ms frames={args.frames} "
          f"device={device}")
    print(f"{'policy':8s} {'viol%':>6s} {'fps':>7s} {'lat_ms':>8s} {'acc':>7s} {'dev%':>6s}")
    for policy in ("janus", "device", "cloud", "mixed"):
        st = eng.run_trace(trace, args.frames, policy, images=images)
        print(f"{policy:8s} {100*st.violation_ratio:6.1f} {st.avg_throughput_fps:7.2f} "
              f"{st.avg_latency_s*1e3:8.1f} {st.avg_accuracy:7.4f} "
              f"{100*st.avg_deviation:6.1f}")
    st = eng.run_trace(trace, min(args.frames, 10), "janus", images=images)
    for i, f in enumerate(st.frames[:10]):
        print(f"  frame {i}: bw={f.bandwidth_bps/1e6:6.2f}Mbps alpha={f.alpha:.2f} "
              f"split={f.split:2d} lat={f.latency_s*1e3:7.1f}ms "
              f"{'VIOLATED' if f.violated else 'ok'}")


if __name__ == "__main__":
    main()
