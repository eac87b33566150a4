"""Janus serving driver, PyTorch port of ``repro.launch.serve`` (single stream).

Drives the Janus stack (profiler fit, dynamic scheduler, split execution
with LZW transport) over a synthetic dynamic network trace and prints the
paper's §V-B policy table:

  PYTHONPATH=src python -m repro_torch.launch.serve --network 4g \
      --mobility driving --frames 60 --sla-ms 300 [--execute] [--device cpu]

The timing plane models the paper's ViT-L@384; ``--execute`` also runs the
real split-model math on the same reduced ViT the reference CLI executes,
on ``--device`` (``cuda`` by default; there is no silent CPU fallback).
Fleet mode (``--streams``) waits for the serving slice of the port.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import janus_vit_l384
from repro_torch.core import bandwidth, engine, planner, profiler, scheduler
from repro_torch.models import param as param_lib
from repro_torch.models import vit as vit_lib
from repro_torch.runtime.device import resolve_device


def make_profile(cfg: vit_lib.ViTConfig) -> scheduler.ModelProfile:
    grid = range(32, cfg.num_tokens + 1, max(cfg.num_tokens // 16, 16))
    dev = profiler.profile_platform(profiler.EDGE_PLATFORM, cfg.d_model, cfg.d_ff, grid)
    cloud = profiler.profile_platform(profiler.CLOUD_PLATFORM, cfg.d_model, cfg.d_ff, grid)
    pdim = cfg.patch * cfg.patch * 3
    return scheduler.ModelProfile(
        n_layers=cfg.n_layers, x0=cfg.num_tokens,
        token_bytes=cfg.d_model * 1.0,          # int8-quantized + LZW transport
        raw_input_bytes=cfg.img_res * cfg.img_res * 3 * 0.35,  # LZW'd frame
        device=dev, cloud=cloud,
        device_embed_s=profiler.EDGE_PLATFORM.embed_latency(cfg.num_tokens, cfg.d_model, pdim),
        cloud_embed_s=profiler.CLOUD_PLATFORM.embed_latency(cfg.num_tokens, cfg.d_model, pdim),
        head_s=profiler.CLOUD_PLATFORM.head_latency(cfg.d_model, cfg.n_classes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="4g", choices=["4g", "5g", "wifi"])
    ap.add_argument("--mobility", default="driving",
                    choices=["static", "walking", "driving"])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sla-ms", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--execute", action="store_true",
                    help="run real split-model math on a reduced ViT")
    ap.add_argument("--planner", default="tables", choices=["tables", "legacy"],
                    help="Algorithm-1 implementation: vectorized planner "
                         "tables (default) or the reference pure-Python loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda, or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    profile = make_profile(janus_vit_l384.CONFIG)  # timing plane: ViT-L@384
    planner_cfg = planner.PlannerConfig()
    tables = planner.tables_for(profile, planner_cfg)
    if args.planner == "legacy":  # measure the implementation actually used
        dec = scheduler._reference_schedule(profile, 10e6, 0.02, args.sla_ms / 1e3,
                                            t=planner_cfg.t, k=planner_cfg.k)
    else:
        dec = tables.decide(10e6, 0.02, args.sla_ms / 1e3)  # representative state
    print(f"[planner] {args.planner}: latency_model=linear "
          f"alpha_grid={len(tables.alpha_grid)} splits={len(tables.candidates)} "
          f"decide={dec.scheduler_overhead_s*1e6:.0f}us/frame")

    params = model_cfg = images = None
    if args.execute:
        model_cfg = janus_vit_l384.SMOKE
        params = param_lib.init_params(vit_lib.specs(model_cfg),
                                       torch.Generator().manual_seed(0), device)
        images = torch.randn((1, model_cfg.img_res, model_cfg.img_res, 3),
                             generator=torch.Generator().manual_seed(1)).to(device)

    eng_cfg = engine.EngineConfig(sla_s=args.sla_ms / 1e3, execute=args.execute,
                                  planner=args.planner, planner_cfg=planner_cfg)
    trace = bandwidth.synthetic_trace(args.network, args.mobility,
                                      steps=args.frames, seed=args.seed)
    eng = engine.JanusEngine(profile, eng_cfg, model_cfg=model_cfg, params=params,
                             device=device)

    print(f"[serve] trace={trace.name} sla={args.sla_ms}ms frames={args.frames} "
          f"device={device}")
    print(f"{'policy':8s} {'viol%':>6s} {'fps':>7s} {'lat_ms':>8s} {'acc':>7s} {'dev%':>6s}")
    for policy in ("janus", "device", "cloud", "mixed"):
        st = eng.run_trace(trace, args.frames, policy, images=images)
        print(f"{policy:8s} {100*st.violation_ratio:6.1f} {st.avg_throughput_fps:7.2f} "
              f"{st.avg_latency_s*1e3:8.1f} {st.avg_accuracy:7.4f} "
              f"{100*st.avg_deviation:6.1f}")
    st = eng.run_trace(trace, min(args.frames, 10), "janus", images=images)
    for i, f in enumerate(st.frames[:10]):
        print(f"  frame {i}: bw={f.bandwidth_bps/1e6:6.2f}Mbps alpha={f.alpha:.2f} "
              f"split={f.split:2d} lat={f.latency_s*1e3:7.1f}ms "
              f"{'VIOLATED' if f.violated else 'ok'}")


if __name__ == "__main__":
    main()
