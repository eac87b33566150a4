"""Janus §III-D: dynamic scheduler (Algorithm 1).

Scans declining rates α from 0 upward (accuracy high→low); for each α derives
the per-layer token counts, predicts device/cloud per-layer latency with the
linear profilers and the transfer latency from the estimated bandwidth, picks
the split point minimizing E2E latency over the fine-to-coarse candidate set,
and returns the first configuration meeting the SLA — or, if none does, the
(α_max, best-split) fallback.

The public entry points (``schedule`` / ``sweep_alpha``) are backed by the
table-driven vectorized planner (``repro_torch.core.planner``): all model-dependent
state is precomputed once per profile, so a per-frame decision is O(A·S)
array math instead of the O(A·S·N) pure-Python scan. The original loop is
kept verbatim as ``_reference_schedule`` — the parity oracle for
``tests/test_planner.py`` and the baseline for
``benchmarks/planner_bench.py`` (which tracks the measured per-decision
overhead; the paper's Table-2-style claim is that this overhead is negligible
per frame).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from repro_torch.core import pruning, splitter
from repro_torch.core.profiler import LatencyModel


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Everything the scheduler needs to know about one ViT deployment.

    ``device`` / ``cloud`` are any :class:`~repro_torch.core.profiler.LatencyModel`
    (the paper's ``LinearProfiler`` fit, or a ``StepProfiler`` plateau model
    for bucket-padded accelerators — see ``planner.step_aware_profile``)."""
    n_layers: int
    x0: int                      # initial token count (patches + cls)
    token_bytes: float           # D_M: bytes per token after compression
    raw_input_bytes: float       # compressed raw frame size (s=0 transfer)
    device: LatencyModel         # per-layer latency on the device tier
    cloud: LatencyModel          # per-layer latency on the cloud tier
    device_embed_s: float = 0.0  # embedding cost on device (s >= 1)
    cloud_embed_s: float = 0.0   # embedding cost on cloud (s == 0)
    head_s: float = 0.0          # head cost (wherever the tail runs)
    schedule_kind: str = "exponential"


@dataclasses.dataclass(frozen=True)
class Decision:
    alpha: float
    split: int
    predicted_latency_s: float
    meets_sla: bool
    schedule: tuple[int, ...]
    scheduler_overhead_s: float = 0.0


def _e2e_latency(profile: ModelProfile, counts: Sequence[int], split: int,
                 bandwidth_bps: float, rtt_s: float) -> float:
    n = profile.n_layers
    dev = cloud = comm = 0.0
    if split == 0:  # cloud-only
        comm = profile.raw_input_bytes * 8 / bandwidth_bps + rtt_s
        cloud = profile.cloud_embed_s + sum(profile.cloud.predict(counts[l]) for l in range(n))
        cloud += profile.head_s
    elif split == n + 1:  # device-only
        dev = profile.device_embed_s + sum(profile.device.predict(counts[l]) for l in range(n))
        dev += profile.head_s
    else:
        dev = profile.device_embed_s + sum(profile.device.predict(counts[l]) for l in range(split))
        comm = counts[split] * profile.token_bytes * 8 / bandwidth_bps + rtt_s
        cloud = sum(profile.cloud.predict(counts[l]) for l in range(split, n)) + profile.head_s
    return dev + comm + cloud


def _reference_schedule(profile: ModelProfile, bandwidth_bps: float, rtt_s: float,
                        sla_s: float, *, t: float = 0.01, k: int = 5,
                        alpha_grid: Sequence[float] | None = None) -> Decision:
    """The original per-frame Algorithm-1 loop, kept as the parity oracle for
    the vectorized planner (tests/test_planner.py, benchmarks/planner_bench.py).
    O((α_max/t)·S·N) pure Python per call — do not use on hot paths."""
    t0 = time.perf_counter()
    n, x0 = profile.n_layers, profile.x0
    candidates = splitter.candidate_split_points(n, k)
    if alpha_grid is None:
        amax = pruning.alpha_max(n, x0, t)
        steps = int(round(amax / t))
        alpha_grid = [round(i * t, 10) for i in range(steps + 1)]

    best: tuple[float, float, int, tuple[int, ...]] | None = None  # (lat, α, s, sched)
    for alpha in alpha_grid:
        sched = pruning.make_schedule(profile.schedule_kind, alpha, n, x0)
        counts = pruning.token_counts(x0, sched)
        lat_s = [( _e2e_latency(profile, counts, s, bandwidth_bps, rtt_s), s)
                 for s in candidates]
        lat, s = min(lat_s)
        if best is None or lat < best[0]:
            best = (lat, alpha, s, tuple(sched))
        if lat <= sla_s:
            return Decision(alpha, s, lat, True, tuple(sched),
                            time.perf_counter() - t0)
    lat, alpha, s, sched = best
    return Decision(alpha, s, lat, False, sched, time.perf_counter() - t0)


def schedule(profile: ModelProfile, bandwidth_bps: float, rtt_s: float, sla_s: float,
             config=None, *, t: float | None = None, k: int | None = None,
             alpha_grid: Sequence[float] | None = None) -> Decision:
    """Algorithm 1. Returns the chosen (α, split).

    Table-driven: the first call for a given profile builds the planner
    tables (``planner.tables_for`` LRU caches them by profile value); every
    subsequent decision is vectorized array math. ``config`` is a
    ``planner.PlannerConfig``; the bare ``t=/k=/alpha_grid=`` keywords are
    the deprecated pre-PlannerConfig call shape, kept for one release."""
    from repro_torch.core import planner
    return planner.tables_for(profile, config, t=t, k=k, alpha_grid=alpha_grid) \
        .decide(bandwidth_bps, rtt_s, sla_s)


def sweep_alpha(profile: ModelProfile, bandwidth_bps: float, rtt_s: float,
                sla_s: float = float("inf"), config=None, *,
                t: float | None = None, k: int | None = None) -> list[Decision]:
    """Full (α → best split) map — used by sensitivity benchmarks (Fig 9).

    Shares the planner tables with ``schedule`` (no duplicated schedule/count
    derivation), and ``meets_sla`` is evaluated against ``sla_s`` instead of
    the old hardcoded ``False`` (the default ∞ marks every point feasible).
    ``config``/keyword compatibility as in :func:`schedule`."""
    from repro_torch.core import planner
    return planner.tables_for(profile, config, t=t, k=k) \
        .sweep(bandwidth_bps, rtt_s, sla_s)
