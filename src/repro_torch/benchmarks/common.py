"""Shared helpers for the per-paper-table benchmarks, PyTorch port of
``benchmarks/common.py``: the paper's ViT-L@384 and video ViT-L model
dimensions and the fitted latency profile every numpy bench plans against.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.core import profiler, scheduler

# where the port's benches write their artifacts (git-ignored): never the
# repo root, which holds the reference's own BENCH_*.json
OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "bench"

# The numpy benches run the timing plane only: they make no tensor, and the
# engines' device (where executed partitions would run) is never used. They
# name the CPU so that they need no card.
SIM_DEVICE = "cpu"

# LZW on natural images compresses poorly (~0.7; it often stores near-raw),
# unlike the ~0.35 PNG-class ratio — the raw-frame term matters for when
# cloud-only stops being viable (Fig. 9).
LZW_PHOTO_RATIO = 0.7
VITL384 = dict(d=1024, dff=4096, x0=577, n=24, patch_dim=16 * 16 * 3,
               raw_bytes=384 * 384 * 3 * LZW_PHOTO_RATIO, fixed_r=23)
VIDEO_MAE = dict(d=1024, dff=4096, x0=1569, n=24, patch_dim=2 * 16 * 16 * 3,
                 raw_bytes=16 * 224 * 224 * 3 * LZW_PHOTO_RATIO, fixed_r=65)
# video ViT-L (ST-MAE): clip 16x224x224, patch 2x16x16 -> 8*14*14 = 1568 + cls


def out_path(name: str) -> str:
    """Default artifact path of a bench: ``experiments/torch/bench/<name>``."""
    return str(OUT_DIR / name)


def write_json(path: str, artifact: dict, **dump_kw) -> None:
    """Write an artifact, creating its directory."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(artifact, f, **dump_kw)


def paper_profile(model=None, schedule_kind="exponential") -> scheduler.ModelProfile:
    m = model or VITL384
    grid = range(32, m["x0"] + 1, 32)
    dev = profiler.profile_platform(profiler.EDGE_PLATFORM, m["d"], m["dff"], grid)
    cloud = profiler.profile_platform(profiler.CLOUD_PLATFORM, m["d"], m["dff"], grid)
    return scheduler.ModelProfile(
        n_layers=m["n"], x0=m["x0"], token_bytes=m["d"] * 1.0,
        raw_input_bytes=m["raw_bytes"],
        device=dev, cloud=cloud,
        device_embed_s=profiler.EDGE_PLATFORM.embed_latency(m["x0"], m["d"], m["patch_dim"]),
        cloud_embed_s=profiler.CLOUD_PLATFORM.embed_latency(m["x0"], m["d"], m["patch_dim"]),
        head_s=profiler.CLOUD_PLATFORM.head_latency(m["d"], 1000),
        schedule_kind=schedule_kind)
