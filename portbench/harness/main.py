"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the reference, and the result line.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
prints, as its last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``) and, last, ``checks``: each number compared
with its limit, which also close standard error.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from harness import check, flops, hostref, modules, serve, spec, trace as trace_lib
from harness.traffic import Source, validate
from harness.weights import dtype_of, make_images, make_params


def vit_config(cfg: dict):
    """The program's configuration object, built from the configuration file."""
    from repro_torch.models import vit
    if cfg["model"] != "vit" or not cfg["prop_attn"] or cfg["hidden_act"] != "gelu_tanh":
        raise ValueError(f"{cfg['name']}: not a configuration of the ViT path")
    vc = vit.ViTConfig(img_res=cfg["img_res"], patch=cfg["patch"],
                       n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                       n_heads=cfg["num_attention_heads"], d_ff=cfg["intermediate_size"],
                       n_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
                       dtype=dtype_of(cfg), prop_attn=True)
    if vc.head_dim != cfg["head_dim"] or vc.num_tokens != cfg["num_tokens"]:
        raise ValueError(f"{cfg['name']}: head_dim or num_tokens disagree with the widths")
    return vc


def _finite(v):
    return v if isinstance(v, (int, str)) or math.isfinite(v) else str(v)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_obs(window: serve.Window, tier: serve.CloudTier, cfg: dict) -> dict:
    done = [f for f in window.frames if f.done_s is not None and f.done_s <= window.close]
    sched_flops = [flops.frame_flops(cfg, s) for s in tier.schedules]
    return {"window_s": window.seconds, "frames_done": len(done),
            "cloud_batch_s": list(tier.cloud_batch_s),
            "forwards": list(tier.forwards),
            "useful_flops": float(sum(sched_flops[f.kind] for f in done))}


def traced_stretch(tier: serve.CloudTier, traffic: dict, seed: int, cfg: dict,
                   device: torch.device) -> dict:
    """A second, profiled stretch of the same traffic (after one discarded
    profiled micro-batch that starts the profiler): the device's busy time,
    kernels and idle gaps, and the kernels' bounds at the calls it made."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    warm = Source(traffic, seed, stream=6)
    with profile(activities=acts):
        tier.dispatch([warm.next(0.0) for _ in range(min(8, traffic["max_batch"]))])
        _sync(device)
    tier.reset_log()
    tier.traced = True
    with profile(activities=acts) as prof:
        with record_function(trace_lib.PHASE + "window"):
            serve.run_window(tier, traffic, Source(traffic, seed, stream=5),
                             traffic["trace_seconds"])
            _sync(device)
    tier.traced = False
    dt = trace_lib.summarize(prof.events())
    flash = tome = 0.0
    for kind, n in tier.groups:
        f, t = flops.group_bounds(cfg, tier.schedules[kind], n)
        flash, tome = flash + f, tome + t
    return {"trace": dt, "trace_frames": sum(n for _, n in tier.groups),
            "flash_bound_s": flash, "tome_bound_s": tome}


def run(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, cfg: dict | None = None,
        traffic: dict | None = None, log=print) -> tuple[dict, list[str]]:
    """Run one cell; returns (result, the check lines). ``cfg`` and
    ``traffic`` replace the cell's files (tests at a small size)."""
    cell = spec.workload(bench, cell_name)
    cfg = cfg or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    validate(traffic, cfg)
    vit_cfg = vit_config(cfg)
    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        log(hostref.line(device))
        marks.append(("cuda_and_host_reference", time.perf_counter()))
    torch.set_grad_enabled(False)

    params = make_params(cfg, seed, device)
    pool = make_images(cfg, traffic["image_pool"], seed, device)
    _sync(device)
    marks.append(("weights_and_images", time.perf_counter()))
    tier = serve.CloudTier(vit_cfg, params, pool, traffic)
    warm = Source(traffic, seed, stream=4)
    for n in traffic["warmup_batches"]:
        tier.dispatch([warm.next(0.0) for _ in range(n)])
    _sync(device)
    tier.reset_log()
    marks.append(("kernels_and_warmup", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    log("[setup] " + " ".join(f"{name}_s={t - prev:.3f}" for (name, t), (_, prev)
                              in zip(marks, [("start", t_start)] + marks[:-1])))

    window = serve.run_window(tier, traffic, Source(traffic, seed), seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    obs = window_obs(window, tier, cfg)
    obs["setup_s"] = setup_s
    if traced:
        obs.update(traced_stretch(tier, traffic, seed, cfg, device))

    dispatched = sum(f.dispatch_s is not None for f in window.frames)
    returned = len(window.logits)
    picked = check.sample(window.frames, window.logits, traffic["check"]["frames"], seed)
    schedules = tier.schedules
    del tier
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = check.reference_logits(cfg, params, pool, schedules, picked,
                                  traffic["check"]["block"])
    ok, checks = check.judge(dispatched, returned, {f.fid: window.logits[f.fid] for f in picked},
                             want, traffic["check"]["rel_err_limit"])

    metrics = {}
    for m in spec.metrics_for(bench, cell_name, traced):
        value = spec.reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted, failed = dispatched, dispatched - returned
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if traced and obs.get("trace") is not None:
        dev["busy_s"] = obs["trace"].busy_s
        dev["window_s"] = obs["trace"].window_s
        result["breakdown"] = trace_lib.breakdown(obs["trace"])
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    lines = [f"[check] {k} = {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    return result, lines


def main(argv: list[str] | None = None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), t_start, log=print)
    bad = modules.forbidden_loaded()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
