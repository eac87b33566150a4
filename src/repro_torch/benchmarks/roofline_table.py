"""Aggregate ``experiments/torch/dryrun/*.json`` into the roofline table,
PyTorch port of ``benchmarks/roofline_table.py``. The terms are counted on
a fake world with the H100's data-sheet constants (``runtime.roofline``),
not measured. Run after ``python -m repro_torch.launch.dryrun --all``:

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""
from __future__ import annotations

import json
import pathlib

DRYRUN = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "dryrun"


def load_records(root: pathlib.Path = DRYRUN) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(root.glob("*.json"))]


def rows(root: pathlib.Path = DRYRUN):
    """(name, bound in µs, roofline fraction) of every ok record."""
    out = []
    for r in load_records(root):
        if r.get("status") != "ok":
            continue
        bound_ms = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) * 1e3
        out.append((f"roofline/{r['cell']}", bound_ms * 1e3,
                    round(r["roofline_fraction"], 4)))
    return out


def markdown_table(mesh_filter: str = "16x16", root: pathlib.Path = DRYRUN) -> str:
    recs = [r for r in load_records(root)
            if r.get("mesh") == mesh_filter or r.get("status") in ("skipped", "error")]
    lines = [
        "| cell | t_compute | t_memory | t_collective | bottleneck | "
        "useful (MODEL/counted) | roofline frac | peak/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    seen = set()
    for r in recs:
        cell = r["cell"].split("@")[0]
        if r.get("status") in ("skipped", "error"):
            if not r["cell"].endswith("@" + mesh_filter) or cell in seen:
                continue
            seen.add(cell)
            lines.append(f"| {cell} | — | — | — | {r['status'].upper()} | — | — | — |")
            continue
        mem = r.get("memory_per_device", {})
        lines.append(
            f"| {cell} "
            f"| {r['t_compute_s']*1e3:.2f} ms | {r['t_memory_s']*1e3:.2f} ms "
            f"| {r['t_collective_s']*1e3:.2f} ms | {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.3f} "
            f"| {mem.get('peak_size_in_bytes', 0) / 1e9:.2f} GB |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table())
