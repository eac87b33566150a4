"""Quickstart, PyTorch port of ``examples/quickstart.py``: the whole Janus
loop on a small ViT.

1. Build a ViT and fit the linear latency profiler (paper §III-C).
2. Ask the dynamic scheduler (Algorithm 1) for (alpha, split) under a
   fluctuating 4G trace.
3. Execute the chosen config as a real split inference (the device runs
   the head layers, the pruned activations cross the "network"
   LZW-compressed, the cloud finishes) and check that it matches the
   monolithic run.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Without ``--device cpu`` it runs on ``cuda`` and raises if there is no card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import bandwidth, pruning, profiler, scheduler
from repro_torch.core.engine import split_inference
from repro_torch.models import param as param_lib
from repro_torch.models import vit as vit_lib
from repro_torch.runtime.device import resolve_device

CFG = vit_lib.ViTConfig(img_res=64, patch=8, n_layers=8, d_model=128, n_heads=4, d_ff=256,
                        n_classes=10)


def model_profile(cfg: vit_lib.ViTConfig = CFG) -> scheduler.ModelProfile:
    """The scheduler's profile of ``cfg`` from the analytical platforms."""
    grid = range(8, cfg.num_tokens + 1, 8)
    return scheduler.ModelProfile(
        n_layers=cfg.n_layers, x0=cfg.num_tokens, token_bytes=cfg.d_model,
        raw_input_bytes=cfg.img_res * cfg.img_res * 3 * 0.7,
        device=profiler.profile_platform(profiler.EDGE_PLATFORM, cfg.d_model, cfg.d_ff, grid),
        cloud=profiler.profile_platform(profiler.CLOUD_PLATFORM, cfg.d_model, cfg.d_ff, grid))


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. model + profiler
    cfg = CFG
    gen = torch.Generator(device=device).manual_seed(0)
    params = param_lib.init_params(vit_lib.specs(cfg), gen, device)
    images = torch.randn((1, cfg.img_res, cfg.img_res, 3), generator=gen, device=device)
    profile = model_profile(cfg)
    print(f"profiler fit: device r={profile.device.r:.4f} cloud r={profile.cloud.r:.4f}")

    # -- 2. schedule under a dynamic network
    trace = bandwidth.synthetic_trace("4g", "driving", steps=5, seed=0)
    for step in range(5):
        bw = trace.at(step)
        dec = scheduler.schedule(profile, bw, trace.rtt_s, sla_s=0.05)
        print(f"step {step}: bw={bw/1e6:6.2f} Mbps -> alpha={dec.alpha:.2f} "
              f"split={dec.split} predicted={dec.predicted_latency_s*1e3:.1f} ms "
              f"(SLA {'ok' if dec.meets_sla else 'MISS'})")

    # -- 3. real split execution == monolithic
    sched = pruning.make_schedule("exponential", dec.alpha, cfg.n_layers, cfg.num_tokens)
    mono = vit_lib.forward_janus(params, cfg, images, sched)
    split_logits, payload = split_inference(params, cfg, images, sched, dec.split)
    err = float((mono - split_logits).abs().max())
    print(f"split-vs-monolithic max |delta| = {err:.2e}"
          + (f"; wire payload = {payload.nbytes} bytes" if payload else " (no transfer)"))
    assert err < 1e-3
    print("quickstart OK")
    return err


if __name__ == "__main__":
    main()
