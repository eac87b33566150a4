"""Per-decision planner benchmark, PyTorch port of
``benchmarks/planner_bench.py``: legacy Algorithm-1 loop vs vectorized
tables (``repro_torch.core.planner``), plus a fleet-simulation wall-clock
cell and the step-aware frontier (``planner_buckets``).

Emits ``BENCH_planner.json`` so the perf trajectory of the decision hot path
is tracked across PRs. The headline metric is per-decision wall time on the
ViT-L@384 profile (the paper's deployment), measured in the worst case for
both implementations (unreachable SLA -> full α scan; the legacy loop's
early-exit best case is reported too). Decision parity is asserted over every
sampled network state before timing.

The ``planner_buckets`` section measures the frontier shift from step-aware
bucketed pruning: bucket-padded accelerators run latency *plateaus*, so the
"true" cost of a plan is its smooth cost at the padded token counts
(``planner.step_aware_profile``). Each (network state, SLA) cell compares
the plan picked by the paper's smooth linear model against the plan picked
by the step-aware planner, both billed at the true plateau pricing — the
step planner is exact Algorithm-1 on the true costs, so its frontier weakly
dominates per cell, with strict wins near bucket edges.
``repro_torch.benchmarks.check_regression`` re-derives and gates both claims.

Numpy only: the planner and the fleet's timing plane touch no tensor, so the
bench takes no device flag. Every field outside the wall clock equals the
reference bench's at the same flags.

  PYTHONPATH=src python -m repro_torch.benchmarks.planner_bench
  (writes experiments/torch/bench/BENCH_planner.json)
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import bandwidth, bucketing, engine, planner, pruning, scheduler
from repro_torch.serving import fleet


def _network_states(n: int, seed: int = 0) -> list[tuple[float, float]]:
    """(bandwidth, rtt) samples spanning blocked -> fibre."""
    rng = np.random.default_rng(seed)
    return [(float(10 ** rng.uniform(4, 9)), float(rng.uniform(0.0, 0.08)))
            for _ in range(n)]


def check_parity(profile, states, sla_s: float) -> None:
    tables = planner.tables_for(profile)
    for bw, rtt in states:
        ref = scheduler._reference_schedule(profile, bw, rtt, sla_s)
        dec = tables.decide(bw, rtt, sla_s)
        assert (dec.alpha == ref.alpha and dec.split == ref.split
                and dec.meets_sla == ref.meets_sla
                and dec.schedule == ref.schedule
                and abs(dec.predicted_latency_s - ref.predicted_latency_s) < 1e-9), \
            f"parity violation at bw={bw:.3g} rtt={rtt:.4f}: {dec} != {ref}"


def time_per_decision(fn, states, reps: int) -> float:
    """Mean seconds per decision across the sampled network states."""
    fn(*states[0])  # warm any caches outside the timed region
    t0 = time.perf_counter()
    for _ in range(reps):
        for bw, rtt in states:
            fn(bw, rtt)
    return (time.perf_counter() - t0) / (reps * len(states))


def bench_decisions(profile, states, sla_s: float, reps: int) -> dict:
    tables = planner.tables_for(profile)
    legacy = time_per_decision(
        lambda bw, rtt: scheduler._reference_schedule(profile, bw, rtt, sla_s),
        states, reps)
    vectorized = time_per_decision(
        lambda bw, rtt: tables.decide(bw, rtt, sla_s), states, reps)
    return {
        "sla_s": sla_s,
        "alpha_grid": len(tables.alpha_grid),
        "split_candidates": len(tables.candidates),
        "legacy_us_per_decision": legacy * 1e6,
        "vectorized_us_per_decision": vectorized * 1e6,
        "speedup": legacy / vectorized,
    }


def bench_planner_buckets(profile, states, reps: int, n_edges: int,
                          sla_grid_ms=tuple(float(ms)
                                            for ms in range(20, 420, 20))) -> dict:
    """Frontier shift from step-aware planning on the ViT-L@384 profile.

    Per (state, SLA) cell: ``smooth`` is the plan of the linear-model planner
    *re-billed* at the true plateau pricing (what bucket-padded hardware
    would actually charge it); ``step`` is the step-aware planner's plan
    (its predicted latency IS the true pricing). Cells where both planners
    pick the *same* (α, split) are ties — identical plan, identical true
    billing — so only the differing cells are emitted (with
    ``n_tie_cells`` bookkeeping); ``check_regression.py`` re-derives weak
    dominance and the strict-improvement count from them instead of
    trusting a summary bit.

    Strict wins concentrate where the smooth plan sits just past a bucket
    edge (under-billed by less than one plateau height), so the SLA grid is
    deliberately dense: a handful of coarse SLA points lands between the
    flip boundaries and sees only ties.
    """
    step_prof = planner.step_aware_profile(
        profile, bucketing.BucketingConfig(n_edges=n_edges))
    smooth_tab = planner.tables_for(profile)
    step_tab = planner.tables_for(step_prof)
    acc_model = pruning.AccuracyModel()
    acc = [acc_model.accuracy(profile.x0, sched)
           for sched in step_tab.schedules]
    cand_index = {int(s): j for j, s in enumerate(step_tab.candidates)}

    cells = []
    n_cells = 0
    ties = 0
    strict = 0
    dominated = 0
    for sla_ms in sla_grid_ms:
        sla_s = sla_ms / 1e3
        for bw, rtt in states:
            n_cells += 1
            d_sm = smooth_tab.decide(bw, rtt, sla_s)
            d_st = step_tab.decide(bw, rtt, sla_s)
            if d_sm.alpha == d_st.alpha and d_sm.split == d_st.split:
                # same plan -> same true billing -> trivially dominated
                ties += 1
                dominated += 1
                continue
            true_lat = step_tab.latency_matrix(bw, rtt)
            a_sm = smooth_tab.alpha_index(d_sm.alpha)
            sm_true = float(true_lat[a_sm, cand_index[d_sm.split]])
            a_st = step_tab.alpha_index(d_st.alpha)
            cell = {
                "sla_ms": sla_ms, "bandwidth_bps": bw, "rtt_s": rtt,
                "smooth": {"alpha": d_sm.alpha, "split": d_sm.split,
                           "true_latency_s": sm_true,
                           "meets_true": bool(sm_true <= sla_s),
                           "accuracy": acc[a_sm]},
                "step": {"alpha": d_st.alpha, "split": d_st.split,
                         "true_latency_s": d_st.predicted_latency_s,
                         "meets_sla": bool(d_st.meets_sla),
                         "accuracy": acc[a_st]},
            }
            cells.append(cell)
            sm, st = cell["smooth"], cell["step"]
            if sm["meets_true"]:
                ok = st["meets_sla"] and st["accuracy"] >= sm["accuracy"]
            else:
                ok = st["meets_sla"] \
                    or st["true_latency_s"] <= sm["true_latency_s"]
            dominated += bool(ok)
            if (st["meets_sla"] and not sm["meets_true"]) \
                    or (st["meets_sla"] and sm["meets_true"]
                        and st["accuracy"] > sm["accuracy"]) \
                    or (not st["meets_sla"] and not sm["meets_true"]
                        and st["true_latency_s"] < sm["true_latency_s"]):
                strict += 1

    step_us = time_per_decision(
        lambda bw, rtt: step_tab.decide(bw, rtt, 0.3), states, reps) * 1e6
    return {
        "n_edges": n_edges,
        "n_step_edges": len(step_prof.cloud.edges),
        "sla_grid_ms": list(sla_grid_ms),
        "n_cells": n_cells,
        "n_tie_cells": ties,
        "dominated_cells": dominated,
        "weak_dominance": dominated == n_cells,
        "strict_improvements": strict,
        "step_us_per_decision": step_us,
        "cells": cells,
    }


def bench_fleet_wall(profile, planner_impl: str, n_streams: int, frames: int,
                     seed: int = 0) -> float:
    streams = [
        fleet.StreamSpec(
            trace=bandwidth.synthetic_trace("4g", "driving", steps=frames,
                                            seed=seed + si),
            n_frames=frames)
        for si in range(n_streams)
    ]
    cfg = engine.EngineConfig(sla_s=0.3, include_scheduler_overhead=False,
                              planner=planner_impl)
    rt = fleet.FleetRuntime(profile, cfg, streams, device=common.SIM_DEVICE)
    t0 = time.perf_counter()
    rt.run()
    return time.perf_counter() - t0


def rows(states_n: int = 20, reps: int = 3):
    """CSV rows for ``run.py``: (name, us_per_call, derived)."""
    profile = common.paper_profile()
    states = _network_states(states_n)
    out = []
    for sla_s, tag in ((1e-9, "full_scan"), (0.3, "sla300ms")):
        r = bench_decisions(profile, states, sla_s, reps)
        out.append((f"planner/legacy/{tag}", r["legacy_us_per_decision"],
                    round(r["speedup"], 1)))
        out.append((f"planner/vectorized/{tag}", r["vectorized_us_per_decision"],
                    round(r["speedup"], 1)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--states", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fleet-streams", type=int, default=16)
    ap.add_argument("--fleet-frames", type=int, default=20)
    ap.add_argument("--bucket-edges", type=int, default=4,
                    help="bucket edges per split for the planner_buckets "
                         "frontier section")
    ap.add_argument("--out", default=common.out_path("BENCH_planner.json"))
    args = ap.parse_args(argv)

    profile = common.paper_profile()
    states = _network_states(args.states)
    for sla_s in (1e-9, 0.3):
        check_parity(profile, states, sla_s)
    print(f"[planner_bench] parity OK over {args.states} network states x 2 SLAs")

    decisions = []
    for sla_s, tag in ((1e-9, "full_scan"), (0.3, "sla300ms")):
        r = bench_decisions(profile, states, sla_s, args.reps)
        r["case"] = tag
        decisions.append(r)
        print(f"{tag:10s} legacy={r['legacy_us_per_decision']:8.1f}us "
              f"vectorized={r['vectorized_us_per_decision']:6.1f}us "
              f"speedup={r['speedup']:.1f}x")

    buckets = bench_planner_buckets(profile, states, args.reps,
                                    args.bucket_edges)
    # regenerating a baseline that stopped making the frontier claim should
    # fail here, loudly, not in CI later
    assert buckets["weak_dominance"], \
        "step-aware frontier must weakly dominate the smooth frontier"
    assert buckets["strict_improvements"] >= 1, \
        "expected at least one strict frontier improvement"
    print(f"planner_buckets: edges<={args.bucket_edges}/split "
          f"({buckets['n_step_edges']} union) cells={buckets['n_cells']} "
          f"({buckets['n_tie_cells']} ties) "
          f"strict_improvements={buckets['strict_improvements']} "
          f"step_decide={buckets['step_us_per_decision']:.1f}us")

    fleet_rows = {}
    for impl in ("legacy", "tables"):
        wall = bench_fleet_wall(profile, impl, args.fleet_streams,
                                args.fleet_frames)
        fleet_rows[impl] = wall
        print(f"fleet({args.fleet_streams}x{args.fleet_frames}, {impl:6s}) "
              f"wall={wall:.2f}s")

    artifact = {
        "benchmark": "planner_bench",
        "model": "vit-l384",
        "config": {"states": args.states, "reps": args.reps,
                   "fleet_streams": args.fleet_streams,
                   "fleet_frames": args.fleet_frames,
                   "bucket_edges": args.bucket_edges},
        "per_decision": decisions,
        "planner_buckets": buckets,
        "fleet_wall_s": fleet_rows,
        "fleet_speedup": fleet_rows["legacy"] / fleet_rows["tables"],
    }
    common.write_json(args.out, artifact, indent=2)
    print(f"[planner_bench] wrote {args.out} "
          f"(fleet speedup {artifact['fleet_speedup']:.1f}x)")


if __name__ == "__main__":
    main()
