"""Fleet-scale serving benchmark, PyTorch port of ``benchmarks/fleet_bench.py``:
stream count x network kind sweep.

Sweeps the port's multi-stream runtime (``repro_torch.serving.fleet``) over stream counts
(1 -> 128 by default) and network kinds, recording aggregate violation ratio,
p50/p99 latency, mean queueing delay, cloud utilization, mean batch size, and
simulation wall time per cell. Emits a JSON perf artifact.

  PYTHONPATH=src python -m repro_torch.benchmarks.fleet_bench \
      --streams 1 4 16 64 128 --networks 4g 5g wifi --frames 30
  (writes experiments/torch/bench/fleet_bench.json)

``--trace-csv FILE_OR_DIR`` replays real traces instead of the synthetic
generator: one CSV shared by every stream, or a directory of ``*.csv``
assigned round-robin (the ``network`` column then reports the source name). Numpy only (the
timing plane touches no tensor), so the bench takes no device flag. Every
field outside the wall clock (``sim_wall_s``) equals the reference bench's
at the same flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.benchmarks import common
from repro_torch.core import engine
from repro_torch.serving import fleet, workload


def build_streams(profile, n_streams: int, network: str, mobility: str,
                  frames: int, seed: int, trace_csv: str = "",
                  trace_rtt_ms: float = 42.2) -> list[fleet.StreamSpec]:
    """Streams via the workload layer's own closed-loop spec, so this bench
    sees exactly the traces ``serve.py --streams N`` / ``--workload`` would
    (same spawned-seed derivation, same CSV file/dir round-robin)."""
    if trace_csv:
        net = workload.NetworkConfig(kind="csv", path=trace_csv,
                                     rtt_ms=trace_rtt_ms)
    else:
        net = workload.NetworkConfig(network=network, mobility=mobility)
    spec = workload.WorkloadSpec(n_streams=n_streams, n_frames=frames,
                                 seed=seed, network=net)
    return spec.build_streams(profile)


def bench_cell(profile, n_streams: int, network: str, mobility: str,
               frames: int, sla_s: float, capacity: int, seed: int,
               planner: str = "tables", trace_csv: str = "",
               trace_rtt_ms: float = 42.2) -> dict:
    streams = build_streams(profile, n_streams, network, mobility, frames,
                            seed, trace_csv, trace_rtt_ms)
    cloud = dataclasses.replace(fleet.default_cloud_config(n_streams),
                                capacity=capacity)
    # deterministic artifact: don't bill wall-clock scheduler time
    cfg = engine.EngineConfig(sla_s=sla_s, include_scheduler_overhead=False,
                              planner=planner)
    rt = fleet.FleetRuntime(profile, cfg, streams, cloud=cloud, device=common.SIM_DEVICE)
    t0 = time.perf_counter()
    fs = rt.run()
    wall_s = time.perf_counter() - t0
    return {
        "streams": n_streams,
        "planner": planner,
        "network": f"csv:{trace_csv}" if trace_csv else network,
        "mobility": mobility,
        "frames_per_stream": frames,
        "capacity": capacity,
        "max_batch": cloud.max_batch,
        "violation_ratio": fs.violation_ratio,
        "p50_latency_ms": fs.p50_latency_s * 1e3,
        "p99_latency_ms": fs.p99_latency_s * 1e3,
        "avg_queue_ms": fs.avg_queue_s * 1e3,
        "cloud_utilization": fs.cloud_utilization,
        "avg_batch_size": fs.avg_batch_size,
        "aggregate_fps": fs.aggregate_fps,
        "sim_wall_s": wall_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 4, 16, 64, 128])
    ap.add_argument("--networks", nargs="+", default=["4g", "5g", "wifi"],
                    choices=["4g", "5g", "wifi"])
    ap.add_argument("--mobility", default="driving",
                    choices=["static", "walking", "driving"])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--sla-ms", type=float, default=300.0)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planner", default="tables", choices=["tables", "legacy"],
                    help="Algorithm-1 implementation (legacy = reference loop, "
                         "for before/after wall-clock comparison)")
    ap.add_argument("--trace-csv", default="",
                    help="replay real traces: a CSV file (shared) or a "
                         "directory of *.csv (round-robin per stream)")
    ap.add_argument("--trace-rtt-ms", type=float, default=42.2)
    ap.add_argument("--out", default=common.out_path("fleet_bench.json"))
    args = ap.parse_args(argv)

    profile = common.paper_profile()
    rows = []
    networks = ["csv"] if args.trace_csv else args.networks
    for network in networks:
        for n in args.streams:
            row = bench_cell(profile, n, network, args.mobility, args.frames,
                             args.sla_ms / 1e3, args.capacity, args.seed,
                             planner=args.planner, trace_csv=args.trace_csv,
                             trace_rtt_ms=args.trace_rtt_ms)
            rows.append(row)
            print(f"{network:5s} N={n:4d} viol={row['violation_ratio']:.3f} "
                  f"p50={row['p50_latency_ms']:7.1f}ms "
                  f"p99={row['p99_latency_ms']:8.1f}ms "
                  f"queue={row['avg_queue_ms']:6.2f}ms "
                  f"util={row['cloud_utilization']:.2f} "
                  f"fps={row['aggregate_fps']:7.1f} "
                  f"wall={row['sim_wall_s']:.2f}s")

    artifact = {
        "benchmark": "fleet_bench",
        "config": {"mobility": args.mobility, "frames": args.frames,
                   "sla_ms": args.sla_ms, "capacity": args.capacity,
                   "seed": args.seed, "planner": args.planner},
        "rows": rows,
    }
    common.write_json(args.out, artifact, indent=2)
    print(f"[fleet_bench] wrote {len(rows)} rows -> {args.out}")


if __name__ == "__main__":
    main()
