"""Workload-scenario benchmark, PyTorch port of ``benchmarks/workload_bench.py``:
scenario x load sweep over the port's fleet runtime.

Each scenario is a declarative ``WorkloadSpec`` (``repro_torch.serving.workload``)
run at several fleet sizes on the paper's ViT-L@384 profile:

  * ``closed-baseline``     — the classic closed-loop fleet (regression anchor)
  * ``poisson-overload``    — open-loop Poisson arrivals past sustainable rate
                              with admission control: overload must show up as
                              a nonzero drop ratio, not unbounded queueing
  * ``mmpp-burst-static``   — bursty (MMPP) arrivals on a static cloud tier
  * ``mmpp-burst-autoscale``— the same arrivals with the utilization-driven
                              autoscaler: capacity rises under the burst and
                              decays after it (the capacity timeline is in the
                              artifact), trading capacity-seconds for SLA
  * ``mmpp-burst-reactive`` — the same bursts with a deeper admission bound
                              (overload queues instead of dropping) on the
                              utilization-driven autoscaler: violation ratio
                              now measures the controller's reaction lag
  * ``mmpp-burst-predictive``— that same load with the *predictive* (EWMA
                              arrival-rate forecast) autoscaler: the
                              reactive-vs-predictive cell of the frontier
  * ``tiered``              — heterogeneous phone/jetson/laptop device tiers
  * ``sla-mix-fifo``        — interactive/standard/batch SLA classes at equal
                              load through the classic FIFO micro-batcher
                              (tight-SLA streams queue behind batch traffic)
  * ``sla-mix-priority``    — the same mixed-class load through the priority
                              micro-batcher (deadline-aware class admission):
                              the interactive class's violation ratio must sit
                              strictly below its FIFO cell

Rows record drop ratio, violation ratio, per-SLA-class ratios/percentiles,
p50/p99 latency, queueing delay, cloud utilization, capacity peak/final, and
capacity-seconds. Three artifact sections pair cells at equal load:
``sla_vs_capacity_frontier`` (static vs autoscaled), ``priority_vs_fifo``
(FIFO vs priority admission, per class), and ``reactive_vs_predictive``
(utilization vs forecast autoscaling). Emits ``BENCH_workload.json``, which
``repro_torch.benchmarks.check_regression`` gates against the reference's
committed ``benchmarks/baselines/BENCH_workload.json``.

Numpy only (the timing plane touches no tensor), so the bench takes no device
flag. Every field outside the wall clock (``sim_wall_s``) equals the
reference bench's at the same flags.

  PYTHONPATH=src python -m repro_torch.benchmarks.workload_bench
  PYTHONPATH=src python -m repro_torch.benchmarks.workload_bench --smoke   # seconds
  PYTHONPATH=src python -m repro_torch.benchmarks.workload_bench --smoke \
      --scenarios sla-mix-fifo,sla-mix-priority   # pin a stable subset
  (writes experiments/torch/bench/BENCH_workload.json)
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import common
from repro_torch.core import engine
from repro_torch.serving import fleet, workload

_BURST_ARRIVALS = dict(kind="mmpp", rate_fps=2.0, burst_rate_fps=60.0,
                       p_burst=0.10, p_calm=0.05, max_inflight=4)
_AUTOSCALE = dict(min_capacity=1, max_capacity=8, interval_s=0.25,
                  cooldown_s=0.25, high_util=0.70, low_util=0.25)
# reactive-vs-predictive pair: same bursts but a deeper admission bound
# (max_inflight=12) so burst overload queues instead of dropping — the
# violation ratio then measures the controller's reaction lag directly
_LAG_ARRIVALS = dict(_BURST_ARRIVALS, max_inflight=12)
_PREDICTIVE = dict(min_capacity=1, max_capacity=8, interval_s=0.10,
                   cooldown_s=0.10, policy="predictive",
                   lookahead_s=0.3, ewma_alpha=0.5)
# mixed-SLA-class load: sustained open-loop Poisson holding one executor at
# ~75% utilization — enough queueing that FIFO admission parks tight-SLA
# interactive frames behind batch traffic, short of outright collapse
_MIX_ARRIVALS = dict(kind="poisson", rate_fps=5.0, max_inflight=6)
_MIX_CLASSES = ("interactive", "standard", "batch")


def scenario_spec(name: str, n_streams: int, frames: int,
                  seed: int) -> workload.WorkloadSpec:
    base = dict(n_streams=n_streams, n_frames=frames, seed=seed)
    wifi = workload.NetworkConfig(network="wifi", mobility="static")
    if name == "closed-baseline":
        return workload.WorkloadSpec(**base)
    if name == "poisson-overload":
        return workload.WorkloadSpec(
            **base, network=wifi, capacity=1, max_batch=4,
            arrivals=workload.ArrivalConfig(kind="poisson", rate_fps=50.0,
                                            max_inflight=2))
    if name == "mmpp-burst-static":
        return workload.WorkloadSpec(
            **base, network=wifi, capacity=1, max_batch=4,
            arrivals=workload.ArrivalConfig(**_BURST_ARRIVALS))
    if name == "mmpp-burst-autoscale":
        return workload.WorkloadSpec(
            **base, network=wifi, capacity=1, max_batch=4,
            arrivals=workload.ArrivalConfig(**_BURST_ARRIVALS),
            autoscale=fleet.AutoscaleConfig(**_AUTOSCALE))
    if name == "mmpp-burst-reactive":
        return workload.WorkloadSpec(
            **base, network=wifi, capacity=1, max_batch=4,
            arrivals=workload.ArrivalConfig(**_LAG_ARRIVALS),
            autoscale=fleet.AutoscaleConfig(**_AUTOSCALE))
    if name == "mmpp-burst-predictive":
        return workload.WorkloadSpec(
            **base, network=wifi, capacity=1, max_batch=4,
            arrivals=workload.ArrivalConfig(**_LAG_ARRIVALS),
            autoscale=fleet.AutoscaleConfig(**_PREDICTIVE))
    if name == "tiered":
        return workload.WorkloadSpec(**base,
                                     tiers=("phone", "jetson", "laptop"))
    if name in ("sla-mix-fifo", "sla-mix-priority"):
        return workload.WorkloadSpec(
            # one executor per ~8 streams keeps the tier near the same
            # contention level at every sweep size (instead of collapsing
            # at N=16 where ordering can no longer matter)
            **base, network=wifi, capacity=max(1, n_streams // 8),
            max_batch=4,
            arrivals=workload.ArrivalConfig(**_MIX_ARRIVALS),
            sla_classes=_MIX_CLASSES,
            priority=(name == "sla-mix-priority"))
    raise ValueError(f"unknown scenario {name!r}")


SCENARIOS = ("closed-baseline", "poisson-overload", "mmpp-burst-static",
             "mmpp-burst-autoscale", "mmpp-burst-reactive",
             "mmpp-burst-predictive", "tiered",
             "sla-mix-fifo", "sla-mix-priority")


def bench_cell(profile, scenario: str, n_streams: int, frames: int,
               sla_s: float, seed: int) -> dict:
    spec = scenario_spec(scenario, n_streams, frames, seed)
    cfg = engine.EngineConfig(sla_s=sla_s, include_scheduler_overhead=False)
    rt = workload.build_runtime(spec, profile, cfg, device=common.SIM_DEVICE)
    t0 = time.perf_counter()
    fs = rt.run()
    wall_s = time.perf_counter() - t0
    row = {
        "scenario": scenario,
        "streams": n_streams,
        "frames_per_stream": frames,
        "arrivals": spec.arrivals.kind,
        "tiers": list(spec.tiers),
        "sla_classes": list(spec.sla_classes),
        "priority": rt.priority,
        "autoscale": spec.autoscale is not None,
        "autoscale_policy": spec.autoscale.policy if spec.autoscale else None,
        "completed_frames": len(fs.all_frames),
        "drop_ratio": fs.drop_ratio,
        "violation_ratio": fs.violation_ratio,
        "avg_accuracy": fs.avg_accuracy,
        "p50_latency_ms": fs.p50_latency_s * 1e3,
        "p99_latency_ms": fs.p99_latency_s * 1e3,
        "avg_queue_ms": fs.avg_queue_s * 1e3,
        "cloud_utilization": fs.cloud_utilization,
        "capacity_initial": fs.capacity,
        "capacity_peak": fs.peak_capacity,
        "capacity_final": fs.final_capacity,
        "capacity_seconds": fs.capacity_seconds,
        "horizon_s": fs.horizon_s,
        "sim_wall_s": wall_s,
    }
    if len(fs.per_class) > 1:
        row["per_class"] = {
            name: {"frames": cs.frames,
                   "violation_ratio": cs.violation_ratio,
                   "drop_ratio": cs.drop_ratio,
                   "p50_latency_ms": cs.p50_latency_s * 1e3,
                   "p99_latency_ms": cs.p99_latency_s * 1e3}
            for name, cs in fs.per_class.items()}
    if spec.autoscale is not None:
        row["capacity_timeline"] = [[t, c] for t, c in fs.capacity_timeline]
    return row


def frontier(rows: list[dict]) -> list[dict]:
    """SLA-vs-capacity-seconds pairs: static vs autoscaled at equal load."""
    by_key = {(r["scenario"], r["streams"]): r for r in rows}
    out = []
    for (scenario, n), r in by_key.items():
        if scenario != "mmpp-burst-autoscale":
            continue
        static = by_key.get(("mmpp-burst-static", n))
        if static is None:
            continue
        out.append({
            "streams": n,
            "static": {"violation_ratio": static["violation_ratio"],
                       "drop_ratio": static["drop_ratio"],
                       "capacity_seconds": static["capacity_seconds"]},
            "autoscaled": {"violation_ratio": r["violation_ratio"],
                           "drop_ratio": r["drop_ratio"],
                           "capacity_seconds": r["capacity_seconds"]},
        })
    return out


def _cell(row: dict) -> dict:
    cell = {"violation_ratio": row["violation_ratio"],
            "drop_ratio": row["drop_ratio"],
            "p99_latency_ms": row["p99_latency_ms"],
            "capacity_seconds": row["capacity_seconds"]}
    if "per_class" in row:
        cell["per_class"] = {
            name: {"violation_ratio": c["violation_ratio"],
                   "drop_ratio": c["drop_ratio"],
                   "p99_latency_ms": c["p99_latency_ms"]}
            for name, c in row["per_class"].items()}
    return cell


def _paired(rows: list[dict], scenario_a: str, scenario_b: str,
            key_a: str, key_b: str) -> list[dict]:
    """Equal-load comparison cells: for every fleet size where both
    scenarios ran, pair their rows as {streams, key_a: cell, key_b: cell}."""
    by_key = {(r["scenario"], r["streams"]): r for r in rows}
    out = []
    for (scenario, n), rb in sorted(by_key.items()):
        if scenario != scenario_b:
            continue
        ra = by_key.get((scenario_a, n))
        if ra is None:
            continue
        out.append({"streams": n, key_a: _cell(ra), key_b: _cell(rb)})
    return out


def priority_vs_fifo(rows: list[dict]) -> list[dict]:
    """Priority admission vs FIFO at equal mixed-class load: the headline
    cell is the interactive class's violation ratio, which priority
    admission must hold strictly below the FIFO cell."""
    return _paired(rows, "sla-mix-fifo", "sla-mix-priority",
                   "fifo", "priority")


def reactive_vs_predictive(rows: list[dict]) -> list[dict]:
    """Utilization (reactive) vs EWMA-forecast (predictive) autoscaling on
    the same bursty load: predictive should buy a lower violation ratio at
    comparable capacity-seconds by cutting the reaction lag."""
    return _paired(rows, "mmpp-burst-reactive", "mmpp-burst-predictive",
                   "reactive", "predictive")


def run_sweep(streams: list[int], frames: int, sla_ms: float, seed: int,
              scenarios=SCENARIOS) -> list[dict]:
    profile = common.paper_profile()
    rows = []
    for scenario in scenarios:
        for n in streams:
            row = bench_cell(profile, scenario, n, frames, sla_ms / 1e3, seed)
            rows.append(row)
            print(f"{scenario:22s} N={n:4d} drop={row['drop_ratio']:.3f} "
                  f"viol={row['violation_ratio']:.3f} "
                  f"p99={row['p99_latency_ms']:8.1f}ms "
                  f"util={row['cloud_utilization']:.2f} "
                  f"cap(peak={row['capacity_peak']} "
                  f"final={row['capacity_final']} "
                  f"cap_s={row['capacity_seconds']:7.2f}) "
                  f"wall={row['sim_wall_s']:.2f}s")
    return rows


def rows():
    """``run.py`` hook: one CSV row per smoke scenario."""
    profile = common.paper_profile()
    out = []
    for scenario in SCENARIOS:
        t0 = time.perf_counter()
        r = bench_cell(profile, scenario, 4, 12, 0.3, seed=0)
        us = (time.perf_counter() - t0) * 1e6
        out.append((f"workload/{scenario}",
                    us,
                    f"drop={r['drop_ratio']:.2f} viol={r['violation_ratio']:.2f} "
                    f"cap_peak={r['capacity_peak']}"))
    return out


def parse_scenarios(arg: str):
    """``--scenarios a,b`` -> validated tuple (empty/``all`` = every one).
    The CI smoke and the regression gate use this to pin a stable subset."""
    if not arg or arg == "all":
        return SCENARIOS
    picked = tuple(s.strip() for s in arg.split(",") if s.strip())
    unknown = [s for s in picked if s not in SCENARIOS]
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown}; "
                         f"known: {list(SCENARIOS)}")
    return picked


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sla-ms", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI sweep (one fleet size, few frames)")
    ap.add_argument("--scenarios", default="all",
                    help="comma-separated scenario subset to run "
                         f"(default all: {','.join(SCENARIOS)})")
    ap.add_argument("--out", default=common.out_path("BENCH_workload.json"))
    args = ap.parse_args(argv)

    scenarios = parse_scenarios(args.scenarios)
    streams = [8] if args.smoke else args.streams
    frames = 40 if args.smoke else args.frames
    bench_rows = run_sweep(streams, frames, args.sla_ms, args.seed,
                           scenarios=scenarios)

    artifact = {
        "benchmark": "workload_bench",
        "config": {"streams": streams, "frames": frames,
                   "sla_ms": args.sla_ms, "seed": args.seed,
                   "smoke": args.smoke, "scenarios": list(scenarios)},
        "rows": bench_rows,
        "sla_vs_capacity_frontier": frontier(bench_rows),
        "priority_vs_fifo": priority_vs_fifo(bench_rows),
        "reactive_vs_predictive": reactive_vs_predictive(bench_rows),
    }
    common.write_json(args.out, artifact, indent=2)
    print(f"[workload_bench] wrote {len(bench_rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
