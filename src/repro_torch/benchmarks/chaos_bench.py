"""Chaos benchmark, PyTorch port of ``benchmarks/chaos_bench.py``: fault
injection + recovery policy on the port's fleet runtime.

One scenario, two policies, same fault trace. A 3-cell regional fleet
(capacity 8/6/5, RTT offsets 0/20/40 ms, spillover routing on) serves 96
Poisson streams of the paper's ViT-L@384 profile while the FaultSpec drives:

  * cell r0 dark for ~20% of the run (capacity -> 0, in-flight batches and
    queued offers lost),
  * one executor crash in r1 (its running batch killed mid-flight),
  * two per-stream network blackouts (uplink bandwidth -> 0 for a window).

The ``recovery`` cell runs the full policy — deadline-aware retries with
capped exponential backoff, per-region circuit breakers rerouting through
the spillover path, device-only degradation as the last resort. The
``naive`` cell replays the *identical* fault trace with ``max_retries=0``
and no breaker: every lost offer degrades immediately, and the dark cell
keeps swallowing offers for the whole outage because nothing learns to
avoid it.

The artifact lands as the ``chaos`` section of the port's
``experiments/torch/bench/BENCH_fleet_scale.json`` (merged into an existing
file, so the fleet-scale rows survive; never the repo root's) and is gated
by ``repro_torch.benchmarks.check_regression``: exact frame conservation
(served + degraded account for every offer — ``unaccounted_frames == 0``),
exact completed/dropped counts (the simulator is seeded and deterministic),
recovery-time ratio tolerance, a violation-during-outage budget, and the
structural claim that recovery beats naive on violation-during-outage.

The recovery cell also runs under full-sampling telemetry
(``repro_torch.serving.telemetry``) and exports the outage as a Chrome
trace-event file (``--trace-out``, default
``experiments/torch/bench/BENCH_chaos_trace.json`` — open it at
ui.perfetto.dev to see the fault
episode, breaker open/close, spillover reroutes, and retry backoffs). The
cell's ``telemetry`` block pins the span/frame reconciliation
(``reconcile.ok`` — the ``unaccounted_frames == 0`` discipline extended to
telemetry) and the span-kind counts the gate checks for fault visibility.

  PYTHONPATH=src python -m repro_torch.benchmarks.chaos_bench

The scenario is already smoke-sized (<1 s of simulation past the one-time
profile fit), so CI and local runs execute the identical cells. Numpy only
(the timing plane touches no tensor), so the bench takes no device flag.
Every field outside the wall clock (``wall_s``) equals the reference
bench's.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time

from repro_torch.benchmarks import common
from repro_torch.core import engine
from repro_torch.serving import faults, telemetry, workload

N_STREAMS = 96
FRAMES = 20
SLA_MS = 300.0
SEED = 7
RATE_FPS = 8.0
REGION_CAPS = (8, 6, 5)
REGION_RTTS_MS = (0.0, 20.0, 40.0)
# ~20% of the no-fault horizon (~6.8 s at this seed/load)
OUTAGE_START_S, OUTAGE_DURATION_S = 0.8, 1.36
WALL_BUDGET_S = 20.0   # per cell; ~100x measured local wall

EPISODES = (
    faults.FaultEpisode("region_outage", start_s=OUTAGE_START_S,
                        duration_s=OUTAGE_DURATION_S, region=0),
    faults.FaultEpisode("executor_crash", start_s=0.4, region=1),
    faults.FaultEpisode("blackout", start_s=0.6, duration_s=0.3, stream=5),
    faults.FaultEpisode("blackout", start_s=1.5, duration_s=0.3, stream=41),
)

POLICIES = {
    "recovery": faults.FaultSpec(episodes=EPISODES),
    "naive": faults.FaultSpec(episodes=EPISODES,
                              retry=faults.RetryConfig(max_retries=0),
                              breaker=None),
}


def scenario_spec(fault_spec: faults.FaultSpec) -> workload.WorkloadSpec:
    return workload.WorkloadSpec(
        n_streams=N_STREAMS, n_frames=FRAMES, seed=SEED, sla_ms=SLA_MS,
        network=workload.NetworkConfig(network="wifi", mobility="static"),
        arrivals=workload.ArrivalConfig(kind="poisson", rate_fps=RATE_FPS,
                                        max_inflight=8),
        regions=tuple(
            workload.RegionConfig(f"r{i}", capacity=REGION_CAPS[i],
                                  rtt_ms=REGION_RTTS_MS[i])
            for i in range(len(REGION_CAPS))),
        faults=fault_spec,
        name="chaos")


def bench_cell(profile, policy: str, trace_out: str | None = None) -> dict:
    spec = scenario_spec(POLICIES[policy])
    cfg = engine.EngineConfig(sla_s=SLA_MS / 1e3,
                              include_scheduler_overhead=False)
    rt = workload.build_runtime(spec, profile, cfg, device=common.SIM_DEVICE)
    tel = None
    if trace_out:
        # full sampling so the exported outage trace shows every stream and
        # the frame-span count reconciles exactly with FleetStats
        tel = telemetry.Telemetry(telemetry.TelemetryConfig(
            stream_sample=1, frame_sample=1))
    t0 = time.perf_counter()
    fs = rt.run(telemetry=tel)
    wall_s = time.perf_counter() - t0
    cell = {
        "policy": policy,
        "streams": N_STREAMS,
        "frames_per_stream": FRAMES,
        "completed_frames": len(fs.all_frames),
        "dropped": fs.total_dropped,
        "unaccounted_frames": fs.unaccounted_frames,
        "lost_offers": fs.total_lost_offers,
        "retries": fs.total_retries,
        "degraded": fs.total_degraded,
        "breaker_trips": sum(r.breaker_trips for r in fs.recovery),
        "mean_time_to_recover_s": fs.mean_time_to_recover_s,
        "violation_ratio": fs.violation_ratio,
        "violation_ratio_during_outage": fs.violation_ratio_during_outage,
        "violation_ratio_steady": fs.violation_ratio_steady,
        "outage_fraction": OUTAGE_DURATION_S / fs.horizon_s
        if fs.horizon_s else 0.0,
        "horizon_s": fs.horizon_s,
        "per_region": [
            {"name": r.name, "lost_offers": r.lost_offers,
             "retries": r.retries, "degraded": r.degraded,
             "breaker_trips": r.breaker_trips,
             "mean_time_to_recover_s": r.mean_time_to_recover_s}
            for r in fs.recovery],
        "wall_s": wall_s,
        "wall_budget_s": WALL_BUDGET_S,
    }
    if tel is not None:
        os.makedirs(os.path.dirname(trace_out) or ".", exist_ok=True)
        tel.write_chrome_trace(trace_out)
        kinds = collections.Counter(s[4] for s in tel.spans)
        cell["telemetry"] = {
            "trace_file": os.path.basename(trace_out),
            "reconcile": tel.reconcile(fs),
            "span_kinds": dict(sorted(kinds.items())),
        }
    return cell


def run_cells(trace_out: str | None = None) -> list[dict]:
    profile = common.paper_profile()
    cells = []
    for policy in POLICIES:
        c = bench_cell(profile, policy,
                       trace_out=trace_out if policy == "recovery" else None)
        cells.append(c)
        print(f"chaos {policy:9s} frames={c['completed_frames']:5d} "
              f"dropped={c['dropped']:3d} unacct={c['unaccounted_frames']} "
              f"lost={c['lost_offers']:4d} retries={c['retries']:3d} "
              f"degraded={c['degraded']:4d} "
              f"viol_out={c['violation_ratio_during_outage']:.3f} "
              f"viol_steady={c['violation_ratio_steady']:.3f} "
              f"mttr={c['mean_time_to_recover_s']*1e3:6.1f}ms "
              f"wall={c['wall_s']:.2f}s")
    return cells


def rows():
    """``run.py`` hook: one CSV row per policy cell."""
    return [(f"chaos/{c['policy']}",
             c["violation_ratio_during_outage"],
             f"lost={c['lost_offers']} degraded={c['degraded']} "
             f"unacct={c['unaccounted_frames']} wall={c['wall_s']:.2f}s")
            for c in run_cells()]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=common.out_path("BENCH_fleet_scale.json"),
                    help="artifact to merge the 'chaos' section into "
                         "(existing fleet-scale rows are preserved)")
    ap.add_argument("--trace-out", default=common.out_path("BENCH_chaos_trace.json"),
                    help="Chrome trace-event export of the recovery cell "
                         "(full sampling; open at ui.perfetto.dev); "
                         "'' disables")
    args = ap.parse_args(argv)

    cells = run_cells(trace_out=args.trace_out or None)
    artifact = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            artifact = json.load(f)
    artifact["chaos"] = {
        "config": {"streams": N_STREAMS, "frames": FRAMES, "sla_ms": SLA_MS,
                   "seed": SEED, "rate_fps": RATE_FPS,
                   "region_caps": list(REGION_CAPS),
                   "region_rtts_ms": list(REGION_RTTS_MS),
                   "outage_start_s": OUTAGE_START_S,
                   "outage_duration_s": OUTAGE_DURATION_S,
                   "episodes": [e.kind for e in EPISODES]},
        "cells": cells,
    }
    common.write_json(args.out, artifact, indent=2)
    print(f"[chaos_bench] wrote {len(cells)} cells -> {args.out} "
          f"(section 'chaos')")
    if args.trace_out:
        print(f"[chaos_bench] recovery-cell Chrome trace -> "
              f"{args.trace_out} (open at ui.perfetto.dev)")


if __name__ == "__main__":
    main()
