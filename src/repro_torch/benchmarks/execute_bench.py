"""Real-execution benchmark, PyTorch port of ``benchmarks/execute_bench.py``:
continuous batching of the cloud partition under mixed pruning levels
(``BENCH_execute.json``).

A fleet of N streams (N >= 16) all split at the same layer while the
per-frame scheduler hands each one a different pruning level α — the
worst case for partition reuse: every α reaches the cloud with a
different token count, so the naive path builds one cloud partition per
α and dispatches them one by one. The bench measures three ways of
executing the identical set of pending ``ExecPlan``s through the port's
``engine.CompiledPlanCache`` and ``engine.run_cloud_batch``:

  * ``per_stream``     — one ``run_cloud_batch`` call per plan: one geometry
                         *and* one dispatch per distinct token count.
  * ``stacked_exact``  — one call over all plans, no bucket table: plans
                         batch only on exact (schedule, split, count)
                         geometry, so mixed-α traffic still builds one
                         partition per count but dispatches each stack once.
  * ``bucketed_e{K}``  — one call with a ``BucketTable`` (n_edges=K):
                         plans sharing the schedule *suffix* past the
                         split are padded to a common bucket edge and
                         share one geometry; builds are bounded by the edge
                         count, not by |α|.

The default geometry is the reference's 50-token ViT (img_res=56/patch=8,
6 layers, f32) at split=4, where all eight α ∈ {0.2..0.9} share the cloud
schedule suffix (1, 1) while entering with 8 distinct token counts.
``--model vit-l384`` runs ``repro_torch.configs.janus_vit_l384`` in bf16 at
split 18 with α ∈ {0.05..0.19}, which all share the cloud suffix there (the
geometry of ``chip_smoke.py``'s ``[batch]`` phase): at 50 tokens a card
measures launch overhead only.

Each mode row records two throughputs over identical pending plans:

  * ``episode_frames_per_s`` — a fresh-cache serving episode: the first
    round, then ``reps`` further rounds that reuse the cache.
  * ``steady_frames_per_s``  — best-of-reps warm-cache dispatch wall.

``compile_s`` keeps the reference's name. PyTorch runs eagerly, so here it
is the first round's wall: the partition closures built plus the first
dispatch, with no XLA compile. Each row also has the cache's
``traces_by_kind`` (first builds of a geometry), ``dispatches_per_round``
(stacked cloud forwards a round), and the max-abs-diff of its logits
against the per-stream path (join-vs-stack parity; ``parity_ok`` holds it
to ``parity_atol`` + ``parity_rtol`` x |per-stream logits|).

The bench runs on the card unless ``--device cpu`` is given; without a card
it fails rather than fall back. ``config.backend`` reads ``cpu`` or the
card's name.

  PYTHONPATH=src python -m repro_torch.benchmarks.execute_bench --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.execute_bench --smoke --model vit-l384
  (writes experiments/torch/bench/BENCH_execute.json)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.configs import janus_vit_l384
from repro_torch.core import engine, pruning
from repro_torch.core.bucketing import BucketingConfig, BucketTable
from repro_torch.models import param as param_lib
from repro_torch.models import vit as vit_lib
from repro_torch.runtime.device import parity_numerics, resolve_device

# all eight α share the cloud schedule suffix (1, 1) at SPLIT on the
# 50-token config while entering the cloud with 8 distinct token counts
ALPHAS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
SPLIT = 4
# padded-vs-unpadded logits: masking is exact, the residual diff is
# reduction reassociation at different extents
PARITY_ATOL = 2e-6
# bucketed vs exact logits in bf16 at ViT-L@384's 6 cloud layers
BATCH_BF16 = dict(atol=0.1, rtol=0.05)


def _cfg50() -> vit_lib.ViTConfig:
    return vit_lib.ViTConfig(img_res=56, patch=8, n_layers=6, d_model=32,
                             n_heads=2, d_ff=64, n_classes=8)


@dataclasses.dataclass(frozen=True)
class BenchModel:
    """One geometry of the bench: the model, the fleet's α grid, the shared
    split, and the join-vs-stack tolerance."""
    cfg: vit_lib.ViTConfig
    alphas: tuple[float, ...]
    split: int
    parity_atol: float
    parity_rtol: float = 0.0


MODELS = {
    "vit50": BenchModel(_cfg50(), ALPHAS, SPLIT, PARITY_ATOL),
    "vit-l384": BenchModel(janus_vit_l384.CONFIG, (0.05, 0.07, 0.09, 0.11, 0.13, 0.15, 0.17, 0.19),
                           18, BATCH_BF16["atol"], BATCH_BF16["rtol"]),
}


def _make_plans(cfg, params, n_streams: int, model: BenchModel,
                device: torch.device) -> list[engine.ExecPlan]:
    """Device partitions for N streams, α cycling over the grid, each with
    its own input image. Device forwards are setup, not the thing measured."""
    plans = []
    for i in range(n_streams):
        alpha = model.alphas[i % len(model.alphas)]
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        img = torch.randn((1, cfg.img_res, cfg.img_res, 3), generator=gen, device=device)
        sched = tuple(pruning.make_schedule("exponential", alpha,
                                            cfg.n_layers, cfg.num_tokens))
        x, sizes = engine.device_forward(params, cfg, img, sched, model.split)
        plans.append(engine.ExecPlan(sched, model.split, x=x, sizes=sizes))
    return plans


def _reset(plans) -> None:
    for p in plans:
        p.logits = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(dispatch, plans, reps: int, device: torch.device) -> dict:
    """Fresh-cache episode (first round + reps warm rounds) and the
    best-of-reps steady-state dispatch wall."""
    _reset(plans)
    _sync(device)
    t0 = time.perf_counter()
    dispatch()
    _sync(device)
    compile_s = time.perf_counter() - t0
    best, episode_s = float("inf"), compile_s
    for _ in range(reps):
        _reset(plans)
        t0 = time.perf_counter()
        dispatch()
        _sync(device)
        wall = time.perf_counter() - t0
        episode_s += wall
        best = min(best, wall)
    return {"compile_s": compile_s,
            "episode_wall_s": episode_s,
            "episode_frames_per_s": len(plans) * (reps + 1) / episode_s,
            "steady_wall_s": best,
            "steady_frames_per_s": len(plans) / best}


def _logits(plans) -> np.ndarray:
    return torch.cat([p.logits for p in plans], dim=0).float().cpu().numpy()


def _parity(logits: np.ndarray, ref: np.ndarray, model: BenchModel) -> dict:
    diff = np.abs(logits - ref)
    return {"parity_max_abs_diff": float(diff.max()),
            "parity_ok": bool(np.all(diff <= model.parity_atol
                                     + model.parity_rtol * np.abs(ref)))}


def _backend(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(n_streams: int, reps: int, edge_sweep: tuple[int, ...],
        model_name: str = "vit50", device: str | None = None) -> dict:
    dev = resolve_device(device)
    parity_numerics()  # f32 parity must not ride on TF32 products
    model = MODELS[model_name]
    cfg = model.cfg
    split = model.split
    params = param_lib.init_params(vit_lib.specs(cfg),
                                   torch.Generator(device=dev).manual_seed(0), dev)
    plans = _make_plans(cfg, params, n_streams, model, dev)
    _sync(dev)
    counts = sorted({p.x.shape[1] for p in plans})
    suffixes = {p.schedule[split:] for p in plans}
    print(f"[execute] {model_name} on {_backend(dev)}: N={n_streams} split={split} "
          f"cloud-entry counts={counts} suffixes={sorted(suffixes)}")

    rows = []

    cache = engine.CompiledPlanCache()
    row = {"mode": "per_stream", **_measure(
        lambda: [engine.run_cloud_batch(cache, cfg, params, [p])
                 for p in plans], plans, reps, dev)}
    row["traces"] = dict(cache.traces_by_kind)
    row["dispatches_per_round"] = len(plans)
    ref = _logits(plans)
    row["parity_max_abs_diff"] = 0.0  # per_stream IS the parity reference
    row["parity_ok"] = True
    rows.append(row)

    cache = engine.CompiledPlanCache()
    row = {"mode": "stacked_exact", **_measure(
        lambda: engine.run_cloud_batch(cache, cfg, params, plans),
        plans, reps, dev)}
    row["traces"] = dict(cache.traces_by_kind)
    row["dispatches_per_round"] = len({(p.schedule, p.x.shape[1]) for p in plans})
    row.update(_parity(_logits(plans), ref, model))
    rows.append(row)

    for k in edge_sweep:
        table = BucketTable.build(cfg, model.alphas,
                                  config=BucketingConfig(n_edges=k))
        cache = engine.CompiledPlanCache()
        row = {"mode": f"bucketed_e{k}", "n_edges": k,
               "edges_at_split": list(table.edges_by_split[split]),
               "bucket_cells": table.n_cells, **_measure(
                   lambda: engine.run_cloud_batch(cache, cfg, params, plans,
                                                  buckets=table),
                   plans, reps, dev)}
        row["traces"] = dict(cache.traces_by_kind)
        row["dispatches_per_round"] = len({table.edge_for(split, p.x.shape[1])
                                           for p in plans})
        row.update(_parity(_logits(plans), ref, model))
        rows.append(row)

    for r in rows:
        print(f"[execute] {r['mode']:>14}: episode "
              f"{r['episode_frames_per_s']:7.1f} f/s, steady "
              f"{r['steady_frames_per_s']:8.1f} f/s "
              f"(first round {r['compile_s']:.3f}s) traces={r['traces']} "
              f"parity={r['parity_max_abs_diff']:.2e}")

    table = BucketTable.build(cfg, model.alphas,
                              config=BucketingConfig(n_edges=max(edge_sweep)))
    return {
        "config": {"streams": n_streams, "reps": reps, "split": split,
                   "alphas": list(model.alphas), "edge_sweep": list(edge_sweep),
                   "model": {"img_res": cfg.img_res, "patch": cfg.patch,
                             "n_layers": cfg.n_layers, "d_model": cfg.d_model},
                   "model_name": model_name, "dtype": str(cfg.dtype).removeprefix("torch."),
                   "backend": _backend(dev)},
        "cloud_entry_counts": counts,
        "shared_suffixes": sorted(list(s) for s in suffixes),
        "parity_atol": model.parity_atol,
        "parity_rtol": model.parity_rtol,
        "bucket_table": table.as_json(),
        "modes": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=common.out_path("BENCH_execute.json"))
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--smoke", action="store_true",
                    help="N=16, 2 reps (CI-speed; still mixed-α)")
    ap.add_argument("--model", default="vit50", choices=sorted(MODELS),
                    help="vit50: the reference's 50-token ViT in f32; vit-l384: "
                         "ViT-L@384 in bf16 at split 18, for the card")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    n = 16 if args.smoke else args.streams
    reps = 2 if args.smoke else args.reps
    out = run(n, reps, edge_sweep=(1, 2, 4), model_name=args.model,
              device=args.device)
    out["config"]["smoke"] = bool(args.smoke)
    common.write_json(args.out, out, indent=1, sort_keys=True)
    print(f"[execute] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
