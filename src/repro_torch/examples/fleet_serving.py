"""Fleet serving demo, PyTorch port of ``examples/fleet_serving.py``: many
concurrent Janus client streams, one shared cloud tier with finite batched
capacity.

Each stream gets its own seeded network trace and bandwidth estimator; cloud
partitions are micro-batched onto a small pool of executors, so stream count
vs capacity shows up directly as queueing delay in the per-frame latency.

  PYTHONPATH=src python -m repro_torch.examples.fleet_serving --device cpu

Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve


def runs(frames: int = 30) -> list[tuple[str, list[str]]]:
    """(title, serve CLI arguments) of each run: a comfortable fleet, then
    the same fleet on a single cloud executor."""
    return [(f"16 driving-4G streams, cloud capacity={capacity}",
             ["--streams", "16", "--network", "4g", "--mobility", "driving",
              "--frames", str(frames), "--sla-ms", "300", "--capacity", str(capacity)])
            for capacity in (4, 1)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    for title, run in runs(args.frames):
        print(f"\n=== {title} ===")
        serve.main(run + device)


if __name__ == "__main__":
    main()
