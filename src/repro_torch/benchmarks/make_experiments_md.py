"""Render the port's experiments page from its dry-run and hill-climb
records, PyTorch port of ``benchmarks/make_experiments_md.py``. Writes
``experiments/torch/EXPERIMENTS.generated.md``. Every number in it is
counted on a fake world with the H100's data-sheet constants, not measured.

  PYTHONPATH=src python -m repro_torch.benchmarks.make_experiments_md
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.runtime import roofline

ROOT = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch"
DRY = ROOT / "dryrun"
HC = ROOT / "hillclimb"


def _load(d: pathlib.Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def _ms(x):
    return f"{x*1e3:.2f}"


def _gb(mem: dict) -> float:
    return mem.get("peak_size_in_bytes", 0) / 1e9


def dryrun_section(recs):
    lines = ["## Dry-run", "",
             "Every (architecture x shape) run as rank 0 of a fake world of "
             "BOTH meshes (single pod 16x16 = 256 ranks; multi-pod 2x16x16 = "
             "512), fake tensors, no device. `peak/dev` = the rank's peak "
             "memory (`MemTracker`; an H100 holds 80 GB). Collectives column = "
             "the collective calls the rank issued.", ""]
    lines += ["| cell | mesh | count time | peak/dev | collectives (count) | wire/dev |",
              "|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") == "skipped":
            lines.append(f"| {r['cell']} | — | SKIPPED | — | {r['reason'][:60]}… | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['cell']} | — | ERROR | — | {r.get('error', '')[:60]} | — |")
            continue
        colls = " ".join(f"{k.replace('collective-', 'c-')}:{v}"
                         for k, v in sorted(r["collective_counts"].items()))
        lines.append(f"| {r['cell'].split('@')[0]} | {r['mesh']} "
                     f"| {r['compile_s']:.0f}s | {_gb(r['memory_per_device']):.2f} GB | {colls} "
                     f"| {r['wire_bytes_per_device']/1e9:.3f} GB |")
    lines.append("")
    return lines


def roofline_section(recs):
    lines = [f"## Roofline (single pod 16x16, H100 SXM: {roofline.PEAK_FLOPS/1e12:.0f} TF/s "
             f"bf16, {roofline.HBM_BW/1e12:.2f} TB/s HBM3, NVLink "
             f"{roofline.NVLINK_BW/1e9:.0f} GB/s in a node, {roofline.NET_BW/1e9:.0f} GB/s "
             "a GPU between nodes; counted, not measured)", "",
             "`useful` = MODEL_FLOPS / (counted FLOPs x ranks); `frac` = "
             "roofline fraction (useful compute time / dominant-term time).", ""]
    lines += ["| cell | t_compute | t_memory | t_collective | bound | useful | frac |",
              "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != "16x16" or r.get("status") != "ok":
            continue
        lines.append(
            f"| {r['cell'].split('@')[0]} | {_ms(r['t_compute_s'])} ms "
            f"| {_ms(r['t_memory_s'])} ms | {_ms(r['t_collective_s'])} ms "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    lines.append("")
    return lines


def perf_section(hc):
    by_cell: dict[str, list[dict]] = {}
    for r in hc:
        by_cell.setdefault(r["cell"], []).append(r)
    lines = ["## Hill-climb log", "",
             "The reference's cells and variants (`launch/hillclimb.py`), counted "
             "on the fake 256-rank world.", ""]
    for cell, rows in by_cell.items():
        lines.append(f"### {cell}")
        lines += ["| variant | t_compute | t_memory | t_collective | bound | frac | peak/dev |",
                  "|---|---|---|---|---|---|---|"]
        for r in rows:
            if r.get("status") == "error":
                lines.append(f"| {r['variant']} | — | — | — | ERROR | — | {r['error'][:60]} |")
                continue
            lines.append(
                f"| {r['variant']} | {_ms(r['t_compute_s'])} ms "
                f"| {_ms(r['t_memory_s'])} ms | {_ms(r['t_collective_s'])} ms "
                f"| {r['bottleneck']} | {r['roofline_fraction']:.4f} "
                f"| {_gb(r['memory_per_device']):.2f} GB |")
        lines.append("")
    return lines


def main():
    dr = _load(DRY) if DRY.exists() else []
    hc = _load(HC) if HC.exists() else []
    out = ["# Experiments (PyTorch port, counted)", "",
           "All records regenerate via `python -m repro_torch.launch.dryrun --all` "
           "and `python -m repro_torch.launch.hillclimb --all`, then this script.", ""]
    out += dryrun_section(dr)
    out += roofline_section(dr)
    out += perf_section(hc)
    md = "\n".join(out)
    ROOT.mkdir(parents=True, exist_ok=True)
    target = ROOT / "EXPERIMENTS.generated.md"
    target.write_text(md)
    print(f"wrote {target} ({len(md.splitlines())} lines)")


if __name__ == "__main__":
    main()
