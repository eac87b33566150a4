"""Training end to end, PyTorch port of ``examples/train_e2e.py``: an
architecture trained on synthetic data through ``launch.train.main``
(AdamW, microbatching, async checkpointing), a simulated restart, and the
resume from the latest checkpoint, which continues the same stream.

  PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 20 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.train_e2e \\
      --steps 20 --device cpu                    # data-parallel on the (4, 1) gloo mesh

Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
For tensor parallelism, ``torchrun --nproc-per-node 4 -m
repro_torch.launch.train --device cpu --mesh-model 2`` trains on (2, 2).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.launch import train


def main(argv=None) -> tuple[train.TrainResult, train.TrainResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vit-b16")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_e2e"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25"]
    common += ["--device", args.device] if args.device else []
    # phase 1: train, checkpointing along the way
    first = train.main(common + ["--steps", str(args.steps // 2)])
    # phase 2: kill/restart simulation: resume from the latest checkpoint
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("\n--- simulated restart: resuming from checkpoint ---")
    second = train.main(common + ["--steps", str(args.steps - args.steps // 2), "--resume"])
    return first, second


if __name__ == "__main__":
    main()
