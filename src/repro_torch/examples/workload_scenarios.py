"""Workload-scenario tour, PyTorch port of ``examples/workload_scenarios.py``:
the declarative layer over the fleet runtime, on the paper's ViT-L@384
timing profile.

  1. closed loop (the classic fleet, regression anchor),
  2. open-loop Poisson overload with admission control (drops, not queues),
  3. heterogeneous phone/jetson/laptop device tiers,
  4. a bursty MMPP fleet with cloud autoscaling (capacity follows load),
  5. mixed SLA classes with priority deadline-aware micro-batching,
  6. diurnal arrivals with predictive (EWMA-forecast) autoscaling,
  7. a priority + predictive scenario loaded from a JSON ``WorkloadSpec``
     through the serving CLI's ``--workload`` flag,
  8. city-scale multi-region cloud: three cells at different RTTs, streams
     homed round-robin, bursty load spilling over between cells,
  9. cell blackout with failover: retries, the circuit breaker, spillover
     and device-only degradation keep frames flowing.

  PYTHONPATH=src python -m repro_torch.examples.workload_scenarios --device cpu

Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile

from repro_torch.launch import serve


def spec(frames: int = 30) -> dict:
    """Scenario 7's ``WorkloadSpec``."""
    return {
        "name": "classes-predictive-demo",
        "n_streams": 8, "n_frames": frames, "sla_ms": 300.0, "seed": 3,
        "network": {"network": "wifi", "mobility": "static"},
        "arrivals": {"kind": "mmpp", "rate_fps": 2.0, "burst_rate_fps": 60.0,
                     "max_inflight": 4},
        "sla_classes": ["interactive", "standard", "batch"],
        "sla_class_defs": {"interactive": {"sla_multiplier": 0.6}},
        "capacity": 1,
        "autoscale": {"min_capacity": 1, "max_capacity": 8,
                      "policy": "predictive", "interval_s": 0.1,
                      "cooldown_s": 0.1, "lookahead_s": 0.3},
    }


def runs(frames: int = 30, spec_path: str = "") -> list[tuple[str, list[str]]]:
    """(title, serve CLI arguments) of each scenario; scenario 7 reads its
    spec from ``spec_path``."""
    base = ["--frames", str(frames), "--sla-ms", "300", "--seed", "3"]
    wifi = ["--network", "wifi", "--mobility", "static"]
    cells = ["--regions", "3", "--region-rtt-ms", "0,15,40", "--spill-slack-ms", "10"]
    return [
        ("1. closed loop, 8 driving-4G streams",
         ["--streams", "8", "--network", "4g", "--mobility", "driving", *base]),
        ("2. open-loop Poisson overload (admission drops)",
         ["--streams", "8", *wifi, "--arrivals", "poisson", "--rate-fps", "50",
          "--max-inflight", "2", "--capacity", "1", *base]),
        ("3. heterogeneous device tiers",
         ["--streams", "6", "--network", "5g", "--mobility", "walking",
          "--tiers", "phone", "jetson", "laptop", *base]),
        ("4. bursty arrivals + cloud autoscaling",
         ["--streams", "8", *wifi, "--arrivals", "mmpp", "--rate-fps", "2",
          "--burst-rate-fps", "60", "--max-inflight", "4", "--capacity", "1",
          "--autoscale", "--autoscale-max", "8", *base]),
        ("5. SLA classes: priority micro-batching + per-class stats",
         ["--streams", "8", *wifi, "--arrivals", "poisson", "--rate-fps", "5",
          "--max-inflight", "6", "--sla-classes", "interactive", "standard", "batch",
          "--capacity", "1", "--max-batch", "4", *base]),
        ("6. diurnal arrivals + predictive autoscaling",
         ["--streams", "8", *wifi, "--arrivals", "diurnal", "--rate-fps", "6",
          "--diurnal-period-s", "4", "--diurnal-amplitude", "0.9", "--max-inflight", "8",
          "--capacity", "1", "--autoscale", "--autoscale-policy", "predictive",
          "--autoscale-max", "8", *base]),
        ("7. priority + predictive, as a JSON WorkloadSpec", ["--workload", spec_path]),
        ("8. city-scale multi-region cloud (affinity + spillover)",
         ["--streams", "24", *wifi, "--arrivals", "mmpp", "--rate-fps", "5",
          "--burst-rate-fps", "80", "--max-inflight", "4", "--capacity", "3",
          "--max-batch", "4", *cells, *base]),
        ("9. cell blackout with failover (faults + recovery)",
         ["--streams", "24", *wifi, "--arrivals", "poisson", "--rate-fps", "8",
          "--max-inflight", "6", "--capacity", "3", "--max-batch", "4", *cells,
          "--fault-outage", "0@1.0+1.5", "--fault-blackout", "5@0.6+0.3", *base]),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "spec.json"
        path.write_text(json.dumps(spec(args.frames)))
        for title, run in runs(args.frames, str(path)):
            print(f"\n=== {title} ===")
            serve.main(run + device)


if __name__ == "__main__":
    main()
