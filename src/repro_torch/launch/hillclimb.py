"""Hill-climb runner, PyTorch port of ``repro.launch.hillclimb``: count
(cell x variant) on the fake 256-rank world of ``launch.dryrun`` and record
the H100 roofline terms of each. Nothing runs on any device; the records
go under ``experiments/torch/hillclimb/``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell vit-l16/serve_b128
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --all
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_bundle

OUT = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "hillclimb"

# (variant name, build_bundle kwargs) per hill-climbed cell: the reference's
# table (its variants' hypotheses are documented with it).
VARIANTS: dict[str, list[tuple[str, dict]]] = {
    # C: paper-representative — ViT-L throughput serving
    "vit-l16/serve_b128": [
        ("v0_baseline", {}),
        ("v1_tome_a0.10", {"janus_alpha": 0.10}),
        ("v2_tome_a0.20", {"janus_alpha": 0.20}),
        ("v3_fused_qkv", {"config_patch": {"fused_qkv": True}}),
        ("v4_fused_qkv_tome0.20", {"config_patch": {"fused_qkv": True},
                                   "janus_alpha": 0.20}),
        ("v5_tome0.20_constrained", {"janus_alpha": 0.20}),
        ("v6_tome_amax_constrained", {"janus_alpha": 0.30}),
    ],
    # B: most collective-bound — conv channel-TP vs alternatives
    "resnet-152/serve_b128": [
        ("v0_baseline", {}),
        ("v1_spatial", {"profile_override": "spatial"}),
        ("v2_dp_replicated", {"profile_override": "dp"}),
    ],
    # A: worst roofline fraction — MoE decode
    "qwen3-moe-30b-a3b/decode_32k": [
        ("v0_baseline", {}),
        ("v1_int8_cache", {"config_patch": {"cache_quant_scale": 0.05}}),
        ("v2_int8_cache_fsdp_serve", {"config_patch": {"cache_quant_scale": 0.05},
                                      "profile_override": "fsdp_ep_tp"}),
        ("v3_per_layer_cache", {"config_patch": {"cache_layout": "per_layer"}}),
        ("v4_per_layer_int8", {"config_patch": {"cache_layout": "per_layer",
                                                "cache_quant_scale": 0.05}}),
    ],
    # D: most collective-bound overall — MoE prefill
    "qwen3-moe-30b-a3b/prefill_32k": [
        ("v0_baseline_reshard_per_layer",
         {"config_patch": {"cache_reshard_per_layer": True}}),
        ("v1_single_final_reshard", {}),
        ("v2_plus_int8_cache", {"config_patch": {"cache_quant_scale": 0.05}}),
        ("v3_no_dus_prefill", {}),
        ("v4_no_dus_int8", {"config_patch": {"cache_quant_scale": 0.05}}),
        ("v5_ep_noact", {"profile_override": "ep_tp_noact"}),
        ("v6_a2a_dispatch", {"config_patch": {"moe_impl": "a2a"}}),
        ("v7_a2a_int8", {"config_patch": {"moe_impl": "a2a",
                                          "cache_quant_scale": 0.05}}),
    ],
}


def run_variant(cell: str, variant: str, kwargs: dict, multi_pod=False) -> dict:
    arch, shape = cell.split("/")
    mesh = dryrun.make_mesh(multi_pod)
    t0 = time.time()
    bundle = build_bundle(arch, shape, mesh, **kwargs)
    rl, counter = dryrun.analyze_bundle(f"{cell}#{variant}", bundle, mesh)
    rec = {"cell": cell, "variant": variant, "status": "ok", "kwargs": repr(kwargs),
           "compile_s": time.time() - t0, "notes": bundle.notes,
           "kernel_calls": dict(counter.kernels), **rl.to_dict()}
    mem = rec["memory_per_device"]
    print(f"[hc] {cell}#{variant}: comp={rl.t_compute*1e3:8.3f}ms "
          f"mem={rl.t_memory*1e3:8.3f}ms coll={rl.t_collective*1e3:8.3f}ms "
          f"-> {rl.bottleneck}, frac={rl.roofline_fraction:.4f} "
          f"(peak {mem.get('peak_size_in_bytes', 0)/1e9:.2f} GB)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)
    cells = list(VARIANTS) if (args.all or not args.cell) else [args.cell]
    for cell in cells:
        for variant, kwargs in VARIANTS[cell]:
            if args.variant and variant != args.variant:
                continue
            try:
                rec = run_variant(cell, variant, kwargs)
            except Exception as e:  # record failures too — refuted hypotheses
                traceback.print_exc()
                rec = {"cell": cell, "variant": variant, "status": "error",
                       "error": repr(e)}
            fn = f"{cell.replace('/', '_')}__{variant}.json"
            (OUT / fn).write_text(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
