"""Fleet-scale benchmark, PyTorch port of ``benchmarks/fleet_scale_bench.py``:
the event-heap simulator core at thousands of streams.

Sweeps the port's fleet runtime (``repro_torch.serving.simcore`` via ``FleetRuntime.run``)
over N ∈ {64, 256, 1024, 4096} streams x 50 frames, simulate-only, on the
paper's ViT-L@384 profile, for two scenarios:

  * ``closed``  — classic closed-loop streams on a shared autoscaling-free
                  tier (the pure hot-path cell: every frame plans, accounts,
                  batches, and completes)
  * ``poisson`` — open-loop Poisson arrivals with ``max_inflight`` admission
                  control (exercises the drop/pipeline-invalidation path at
                  scale)

Each cell records simulation wall time and **wall-clock per simulated
frame** — the scale metric the ROADMAP trajectory tracks. The runtime is
built outside the timer (profile fitting and planner-table construction are
one-time, value-cached costs), so the number is the simulator core itself.

A second sweep, ``region_frontier``, is the multi-region cost-vs-violation
frontier: three asymmetric regional cells (capacity split 50/30/20, RTT
offsets 0/20/60 ms, spillover routing on) under a joint capacity x SLA x
load grid — N ∈ {4k, 16k, 64k} streams, per-(N, SLA) capacity scaled to
{0.25, 0.5, 1.0} of the single-tier default. Each (N, SLA) runtime is built
once and re-swept across capacity scales by swapping the region list, so
the 64k engines/traces are constructed once. Every cell embeds its own
``wall_budget_s``; the frontier claim (more capacity → no more violations
within a (N, SLA) group) is gated structurally.

A third sweep, ``telemetry_overhead``, runs the N=1024 cell of each
scenario twice — telemetry off and with the default-sampling recorder
(``repro_torch.serving.telemetry``) attached — and records the best-of-3 wall
ratio. The recorder is a pure observer (completed-frame counts must match
exactly) and the ratio is gated at ``telemetry.OVERHEAD_BUDGET_RATIO``
(1.3x) by ``check_regression``.

``BENCH_fleet_scale.json`` is gated by ``repro_torch.benchmarks.check_regression``
against ``benchmarks/baselines/BENCH_fleet_scale.json``: per-cell
wall-per-frame at a ratio tolerance, absolute per-cell wall budgets (the
N=4096 cell must finish in seconds, not minutes; frontier cells carry their
own budgets), and exact completed-frame counts (the simulator is seeded and
deterministic).

Numpy only (the timing plane touches no tensor), so the bench takes no device
flag. Every field outside the wall clock (``wall_s``, ``wall_per_frame_us``,
the telemetry walls and their ratio) equals the reference bench's at the
same flags.

  PYTHONPATH=src python -m repro_torch.benchmarks.fleet_scale_bench
  PYTHONPATH=src python -m repro_torch.benchmarks.fleet_scale_bench --smoke   # N<=256
  (writes experiments/torch/bench/BENCH_fleet_scale.json)
"""
from __future__ import annotations

import argparse
import gc
import time

from repro_torch.benchmarks import common
from repro_torch.core import engine
from repro_torch.serving import fleet, telemetry, workload

SCENARIOS = ("closed", "poisson")
STREAMS = (64, 256, 1024, 4096)

# telemetry_overhead sweep: default-sampling recorder vs telemetry-off on
# the same cell, best-of-K walls; the ratio is gated against the recorder's
# published budget (telemetry.OVERHEAD_BUDGET_RATIO)
OVERHEAD_STREAMS = 1024
OVERHEAD_STREAMS_SMOKE = 256
OVERHEAD_REPS = 4

# region_frontier sweep: 3 asymmetric cells, capacity x SLA x load grid
REGION_WEIGHTS = (0.5, 0.3, 0.2)
REGION_RTTS_MS = (0.0, 20.0, 60.0)
CAP_SCALES = (0.25, 0.5, 1.0)
FRONTIER_CELLS = ((4096, 200.0), (4096, 300.0), (16384, 300.0),
                  (65536, 300.0))
FRONTIER_CELLS_SMOKE = ((256, 300.0),)
FRONTIER_FRAMES = 8
# absolute per-cell wall budgets (seconds), keyed by stream count — sized
# ~5x measured local wall (0.3 / 1.6 / 4.6 / 29 s at 256/4k/16k/64k) so
# slow CI machines pass while runaway regressions fail
FRONTIER_BUDGETS = {256: 10.0, 4096: 10.0, 16384: 30.0, 65536: 150.0}


def scenario_spec(name: str, n_streams: int, frames: int,
                  seed: int) -> workload.WorkloadSpec:
    wifi = workload.NetworkConfig(network="wifi", mobility="static")
    if name == "closed":
        return workload.WorkloadSpec(n_streams=n_streams, n_frames=frames,
                                     seed=seed, network=wifi)
    if name == "poisson":
        return workload.WorkloadSpec(
            n_streams=n_streams, n_frames=frames, seed=seed, network=wifi,
            arrivals=workload.ArrivalConfig(kind="poisson", rate_fps=8.0,
                                            max_inflight=4))
    raise ValueError(f"unknown scenario {name!r}")


def bench_cell(profile, scenario: str, n_streams: int, frames: int,
               sla_s: float, seed: int) -> dict:
    spec = scenario_spec(scenario, n_streams, frames, seed)
    cfg = engine.EngineConfig(sla_s=sla_s, include_scheduler_overhead=False)
    rt = workload.build_runtime(spec, profile, cfg, device=common.SIM_DEVICE)
    t0 = time.perf_counter()
    fs = rt.run()
    wall_s = time.perf_counter() - t0
    completed = len(fs.all_frames)
    return {
        "scenario": scenario,
        "streams": n_streams,
        "frames_per_stream": frames,
        "completed_frames": completed,
        "drop_ratio": fs.drop_ratio,
        "violation_ratio": fs.violation_ratio,
        "p99_latency_ms": fs.p99_latency_s * 1e3,
        "horizon_s": fs.horizon_s,
        "wall_s": wall_s,
        "wall_per_frame_us": wall_s / completed * 1e6 if completed else 0.0,
    }


def run_sweep(streams, frames: int, sla_ms: float, seed: int) -> list[dict]:
    profile = common.paper_profile()
    rows = []
    for scenario in SCENARIOS:
        for n in streams:
            row = bench_cell(profile, scenario, n, frames, sla_ms / 1e3, seed)
            rows.append(row)
            print(f"{scenario:8s} N={n:5d} frames={row['completed_frames']:7d} "
                  f"drop={row['drop_ratio']:.3f} "
                  f"viol={row['violation_ratio']:.3f} "
                  f"wall={row['wall_s']:6.2f}s "
                  f"per-frame={row['wall_per_frame_us']:6.1f}us")
    return rows


def frontier_regions(n_streams: int, cap_scale: float) -> list:
    """The three asymmetric cells at ``cap_scale`` of the single-tier
    default capacity (one executor per max_batch-worth of streams)."""
    total = max(3, round(fleet.default_cloud_config(n_streams).capacity
                         * cap_scale))
    return [fleet.RegionSpec(name=f"r{i}",
                             capacity=max(1, round(total * w)),
                             rtt_offset_s=REGION_RTTS_MS[i] / 1e3)
            for i, w in enumerate(REGION_WEIGHTS)]


def bench_region_frontier(profile, cells, seed: int) -> list[dict]:
    """The capacity x SLA x load frontier: per (N, SLA) pair the runtime
    (streams, traces with baked home-region RTT offsets, engines) is built
    once outside the timers and re-swept across capacity scales by swapping
    the region list."""
    wifi = workload.NetworkConfig(network="wifi", mobility="static")
    rows = []
    for n, sla_ms in cells:
        spec = workload.WorkloadSpec(
            n_streams=n, n_frames=FRONTIER_FRAMES, seed=seed, network=wifi,
            sla_ms=sla_ms,
            regions=tuple(
                workload.RegionConfig(f"r{i}", capacity=1,
                                      rtt_ms=REGION_RTTS_MS[i])
                for i in range(len(REGION_WEIGHTS))))
        cfg = engine.EngineConfig(sla_s=sla_ms / 1e3,
                                  include_scheduler_overhead=False)
        rt = workload.build_runtime(spec, profile, cfg, device=common.SIM_DEVICE)
        for scale in CAP_SCALES:
            rt.regions = frontier_regions(n, scale)
            t0 = time.perf_counter()
            fs = rt.run()
            wall_s = time.perf_counter() - t0
            completed = len(fs.all_frames)
            row = {
                "streams": n,
                "sla_ms": sla_ms,
                "cap_scale": scale,
                "frames_per_stream": FRONTIER_FRAMES,
                "capacity": fs.capacity,
                "completed_frames": completed,
                "violation_ratio": fs.violation_ratio,
                "p99_latency_ms": fs.p99_latency_s * 1e3,
                "spill_ratio": fs.spill_ratio,
                "capacity_seconds": fs.capacity_seconds,
                "per_region": [
                    {"name": r.name, "capacity": r.capacity,
                     "utilization": r.utilization,
                     "spill_ratio": r.spill_ratio,
                     "capacity_seconds": r.capacity_seconds}
                    for r in fs.per_region],
                "wall_s": wall_s,
                "wall_budget_s": FRONTIER_BUDGETS[n],
                "wall_per_frame_us":
                    wall_s / completed * 1e6 if completed else 0.0,
            }
            rows.append(row)
            print(f"frontier N={n:5d} sla={sla_ms:5.0f}ms "
                  f"cap={fs.capacity:5d} (x{scale:.2f}) "
                  f"viol={row['violation_ratio']:.3f} "
                  f"spill={row['spill_ratio']:.3f} "
                  f"cap_s={row['capacity_seconds']:9.1f} "
                  f"wall={wall_s:6.2f}s")
    return rows


def bench_telemetry_overhead(profile, n_streams: int, frames: int,
                             sla_s: float, seed: int) -> list[dict]:
    """Per scenario: the same cell with telemetry off and with the
    default-sampling recorder attached, best-of-``OVERHEAD_REPS`` walls.
    Telemetry is a pure observer, so completed-frame counts must match
    exactly; the wall ratio is gated at the recorder's published budget."""
    rows = []
    for scenario in SCENARIOS:
        spec = scenario_spec(scenario, n_streams, frames, seed)
        cfg = engine.EngineConfig(sla_s=sla_s,
                                  include_scheduler_overhead=False)
        walls = {"off": float("inf"), "on": float("inf")}
        completed = {}
        # interleave the modes so machine-load drift across the reps hits
        # both sides of the ratio equally
        for _ in range(OVERHEAD_REPS):
            for mode in ("off", "on"):
                rt = workload.build_runtime(spec, profile, cfg, device=common.SIM_DEVICE)
                tel = None if mode == "off" else telemetry.Telemetry()
                # drain garbage left by earlier (much larger) sweeps so a
                # stray full collection doesn't land inside one timed rep
                # and skew the on/off ratio
                gc.collect()
                t0 = time.perf_counter()
                fs = rt.run(telemetry=tel)
                walls[mode] = min(walls[mode],
                                  time.perf_counter() - t0)
                completed[mode] = len(fs.all_frames)
        row = {
            "scenario": scenario,
            "streams": n_streams,
            "frames_per_stream": frames,
            "completed_frames_off": completed["off"],
            "completed_frames_on": completed["on"],
            "wall_off_s": walls["off"],
            "wall_on_s": walls["on"],
            "overhead_ratio": walls["on"] / walls["off"],
            "budget_ratio": telemetry.OVERHEAD_BUDGET_RATIO,
        }
        rows.append(row)
        print(f"telemetry {scenario:8s} N={n_streams:5d} "
              f"off={walls['off']:6.2f}s on={walls['on']:6.2f}s "
              f"ratio={row['overhead_ratio']:.3f} "
              f"(budget {row['budget_ratio']:.2f})")
    return rows


def rows():
    """``run.py`` hook: one CSV row per scenario at N=256, plus
    the smoke-size region-frontier cells."""
    profile = common.paper_profile()
    out = []
    for scenario in SCENARIOS:
        r = bench_cell(profile, scenario, 256, 20, 0.3, seed=7)
        out.append((f"fleet_scale/{scenario}-n256",
                    r["wall_per_frame_us"],
                    f"frames={r['completed_frames']} "
                    f"drop={r['drop_ratio']:.2f} wall={r['wall_s']:.2f}s"))
    for r in bench_region_frontier(profile, FRONTIER_CELLS_SMOKE, seed=7):
        out.append((f"fleet_scale/frontier-n{r['streams']}"
                    f"-x{r['cap_scale']:.2f}",
                    r["wall_per_frame_us"],
                    f"viol={r['violation_ratio']:.3f} "
                    f"spill={r['spill_ratio']:.3f} wall={r['wall_s']:.2f}s"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, nargs="+", default=list(STREAMS))
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--sla-ms", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--smoke", action="store_true",
                    help="N <= 256 only (quick local iteration; CI runs the "
                         "full sweep — the N=4096 cell is the point)")
    ap.add_argument("--out", default=common.out_path("BENCH_fleet_scale.json"))
    args = ap.parse_args(argv)

    streams = [n for n in args.streams if n <= 256] if args.smoke \
        else args.streams
    profile = common.paper_profile()
    # overhead cells run FIRST: the 16k/64k frontier sweeps below leave the
    # process heap huge, which slows allocation-heavy code and would skew
    # the on/off ratio by run order rather than by recorder cost
    overhead_n = OVERHEAD_STREAMS_SMOKE if args.smoke else OVERHEAD_STREAMS
    overhead_rows = bench_telemetry_overhead(
        profile, overhead_n, args.frames, args.sla_ms / 1e3, args.seed)
    bench_rows = run_sweep(streams, args.frames, args.sla_ms, args.seed)
    frontier_cells = FRONTIER_CELLS_SMOKE if args.smoke else FRONTIER_CELLS
    frontier_rows = bench_region_frontier(profile, frontier_cells, args.seed)
    artifact = {
        "benchmark": "fleet_scale_bench",
        "config": {"streams": streams, "frames": args.frames,
                   "sla_ms": args.sla_ms, "seed": args.seed,
                   "smoke": args.smoke},
        "rows": bench_rows,
        "region_frontier": frontier_rows,
        "telemetry_overhead": overhead_rows,
    }
    common.write_json(args.out, artifact, indent=2)
    print(f"[fleet_scale_bench] wrote {len(bench_rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
