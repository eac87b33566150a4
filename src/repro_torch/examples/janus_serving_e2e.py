"""End-to-end serving, PyTorch port of ``examples/janus_serving_e2e.py``:
frame requests through the full Janus stack under three network scenarios,
with real split model math on a reduced ViT (``--execute``) and the
paper-calibrated timing plane.

  PYTHONPATH=src python -m repro_torch.examples.janus_serving_e2e --device cpu

Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve

SCENARIOS = (("4g", "driving"), ("5g", "walking"), ("wifi", "static"))


def runs(frames: int = 40) -> list[tuple[str, list[str]]]:
    """(title, serve CLI arguments) of each scenario."""
    return [(f"{net}/{mob}", ["--network", net, "--mobility", mob, "--frames", str(frames),
                              "--sla-ms", "300", "--execute"])
            for net, mob in SCENARIOS]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    for title, run in runs(args.frames):
        print(f"\n=== {title} ===")
        serve.main(run + device)


if __name__ == "__main__":
    main()
