"""Table-driven vectorized Algorithm-1 planner (Janus §III-D, hot path).

``scheduler.schedule`` semantics, precomputed. Everything Algorithm 1 derives
per call that only depends on the *model* — the α grid, the per-α pruning
schedules, the ``(A, L+1)`` token-count matrix, per-layer device/cloud latency
prefix sums, the fine-to-coarse split candidates, and per-(α, split) transfer
payloads — is computed **once per ModelProfile** into a :class:`PlannerTables`.
A per-frame decision then collapses to one vectorized evaluation of the
``(A, S)`` latency matrix

    lat[a, j] = dev[a, j] + (bits[a, j] / bandwidth + rtt·mask[j]) + cloud[a, j]

plus two argmins that preserve *exact* Algorithm-1 semantics:

  * within one α, the best split is the latency argmin over the candidate set
    (ties → smallest split, matching the legacy ``min((lat, s))`` tuple order);
  * across α the decision is the FIRST (lowest) α whose best split meets the
    SLA — α scans accuracy high→low, so first-feasible maximizes accuracy;
  * if no α is feasible, the fallback is the globally best (lat, α, split)
    with ties broken toward the smallest α (the legacy strict ``<`` update).

Decision parity with the legacy loop (kept as
``scheduler._reference_schedule``) is property-tested in
``tests/test_planner.py``; per-decision wall time is tracked by
``benchmarks/planner_bench.py`` (BENCH_planner.json).

The latency columns are priced through the profile's
:class:`~repro_torch.core.profiler.LatencyModel`\\ s — any vectorized predictor,
not just the paper's linear fit. With a :class:`~repro_torch.core.profiler.
StepProfiler` cloud model (``step_aware_profile``) the cloud columns become
bucket-edge *plateaus*: α rows whose padded token counts coincide cost
identically, and the argmin tie-breaks above resolve every plateau tie
toward the lowest α — the least-pruned, highest-accuracy member of the
bucket cell. That α-snapping is exactly the "pruning one more token is
enough" frontier move (docs/planner.md; gated by the ``planner_buckets``
section of BENCH_planner.json).

Tables are cached by *profile value* (not identity) in a small LRU, so the
fleet runtime's N engines sharing one fitted profile share one tables
instance, and repeated profile construction (benchmarks, tests) stays cheap.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core import bucketing as bucketing_lib
from repro_torch.core import profiler, pruning, splitter
from repro_torch.core.scheduler import Decision, ModelProfile


def default_alpha_grid(n_layers: int, x0: int, t: float) -> tuple[float, ...]:
    """The Algorithm-1 α scan: multiples of ``t`` from 0 to α_max (Eq. 2)."""
    amax = pruning.alpha_max(n_layers, x0, t)
    steps = int(round(amax / t))
    return tuple(round(i * t, 10) for i in range(steps + 1))


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Algorithm-1 knobs, previously sprawled as ``tables_for(profile, t=,
    k=, alpha_grid=)`` keywords. One value object, JSON round-trippable like
    ``BucketingConfig``/``AutoscaleConfig``, threaded through ``scheduler``,
    ``engine.EngineConfig``, and the serve CLI.

    ``t`` is the α-scan step (Eq. 2), ``k`` the fine-to-coarse split-candidate
    spacing, ``alpha_grid`` an explicit α grid overriding the default scan.
    """
    t: float = 0.01
    k: int = 5
    alpha_grid: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.t <= 0:
            raise ValueError(f"t must be > 0, got {self.t}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.alpha_grid is not None:
            object.__setattr__(self, "alpha_grid",
                               tuple(float(a) for a in self.alpha_grid))

    def to_json(self) -> dict:
        d = {"t": self.t, "k": self.k}
        if self.alpha_grid is not None:
            d["alpha_grid"] = list(self.alpha_grid)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "PlannerConfig":
        grid = d.get("alpha_grid")
        return cls(t=float(d.get("t", 0.01)), k=int(d.get("k", 5)),
                   alpha_grid=None if grid is None else tuple(grid))


def _resolve_config(config: PlannerConfig | None, t: float | None,
                    k: int | None,
                    alpha_grid: Sequence[float] | None) -> PlannerConfig:
    """One release of compatibility: accept either a PlannerConfig or the
    pre-PlannerConfig bare ``t=/k=/alpha_grid=`` keywords (deprecated — the
    keywords will be dropped once callers migrate), never both."""
    if config is not None:
        if t is not None or k is not None or alpha_grid is not None:
            raise TypeError("pass a PlannerConfig or bare t=/k=/alpha_grid= "
                            "keywords, not both")
        return config
    return PlannerConfig(
        t=0.01 if t is None else t, k=5 if k is None else k,
        alpha_grid=None if alpha_grid is None else tuple(alpha_grid))


@dataclasses.dataclass(frozen=True)
class PlannerTables:
    """Precomputed Algorithm-1 state for one (profile, t, k, α-grid).

    Shapes: A = len(alpha_grid), S = len(candidates), L = profile.n_layers.
    All float arrays are float64 so the vectorized math matches the legacy
    pure-Python float sums to ~1 ulp.
    """
    profile: ModelProfile
    t: float
    k: int
    alpha_grid: np.ndarray          # (A,) float
    schedules: tuple[tuple[int, ...], ...]   # A × L clamped merge schedules
    counts: np.ndarray              # (A, L+1) int — tokens entering each layer
    candidates: np.ndarray          # (S,) int — fine-to-coarse split points
    dev_s: np.ndarray               # (A, S) device compute (embed + prefix [+ head])
    cloud_s: np.ndarray             # (A, S) cloud compute (suffix + head [+ embed])
    bits: np.ndarray                # (A, S) wire bits (raw frame at s=0)
    rtt_mask: np.ndarray            # (S,) 1.0 except device-only
    payload: np.ndarray             # (A, S) activation payload bytes (0 at endpoints)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, profile: ModelProfile, config: PlannerConfig | None = None,
              *, t: float | None = None, k: int | None = None,
              alpha_grid: Sequence[float] | None = None) -> "PlannerTables":
        """Precompute the tables for ``profile`` under ``config`` (the bare
        ``t=/k=/alpha_grid=`` keywords are the deprecated pre-PlannerConfig
        call shape, kept working for one release).

        ``profile.device`` / ``profile.cloud`` may be any ``LatencyModel``
        with a vectorized ``predict`` — the linear fit and the step-plateau
        model run through the identical float pipeline below."""
        config = _resolve_config(config, t, k, alpha_grid)
        t, k = config.t, config.k
        n, x0 = profile.n_layers, profile.x0
        alpha_grid = config.alpha_grid
        if alpha_grid is None:
            alpha_grid = default_alpha_grid(n, x0, t)
        alphas = np.asarray(alpha_grid, dtype=np.float64)
        cand = np.asarray(splitter.candidate_split_points(n, k), dtype=np.int64)
        a_n, s_n = len(alphas), len(cand)

        schedules = tuple(
            tuple(pruning.make_schedule(profile.schedule_kind, float(a), n, x0))
            for a in alphas)
        counts = np.empty((a_n, n + 1), dtype=np.int64)
        counts[:, 0] = x0
        sched_mat = np.asarray(schedules, dtype=np.int64).reshape(a_n, n)
        np.cumsum(-sched_mat, axis=1, out=counts[:, 1:])
        counts[:, 1:] += x0

        # per-layer latency and sequential prefix sums (cumsum matches the
        # legacy left-to-right Python float accumulation)
        dev_lat = profile.device.predict(counts[:, :n].astype(np.float64))
        cloud_lat = profile.cloud.predict(counts[:, :n].astype(np.float64))
        zeros = np.zeros((a_n, 1))
        dev_prefix = np.concatenate([zeros, np.cumsum(dev_lat, axis=1)], axis=1)
        cloud_prefix = np.concatenate([zeros, np.cumsum(cloud_lat, axis=1)], axis=1)

        inner = (cand >= 1) & (cand <= n)       # device runs [0, s), cloud [s, N)
        dev_s = np.zeros((a_n, s_n))
        cloud_s = np.zeros((a_n, s_n))
        bits = np.zeros((a_n, s_n))
        payload = np.zeros((a_n, s_n))
        rtt_mask = np.ones(s_n)
        for j, s in enumerate(cand):
            s = int(s)
            if s == 0:               # cloud-only: ship the compressed raw frame
                cloud_s[:, j] = (profile.cloud_embed_s + cloud_prefix[:, n]) \
                    + profile.head_s
                bits[:, j] = profile.raw_input_bytes * 8.0
            elif s == n + 1:         # device-only: no transfer, head on device
                dev_s[:, j] = (profile.device_embed_s + dev_prefix[:, n]) \
                    + profile.head_s
                rtt_mask[j] = 0.0
            else:
                dev_s[:, j] = profile.device_embed_s + dev_prefix[:, s]
                cloud_s[:, j] = (cloud_prefix[:, n] - cloud_prefix[:, s]) \
                    + profile.head_s
                payload[:, j] = counts[:, s] * profile.token_bytes
                bits[:, j] = payload[:, j] * 8.0
        assert inner.sum() == s_n - 2
        return cls(profile=profile, t=t, k=k, alpha_grid=alphas,
                   schedules=schedules, counts=counts, candidates=cand,
                   dev_s=dev_s, cloud_s=cloud_s, bits=bits, rtt_mask=rtt_mask,
                   payload=payload)

    # -- vectorized Algorithm 1 ---------------------------------------------
    def latency_matrix(self, bandwidth_bps: float, rtt_s: float) -> np.ndarray:
        """E2E latency for every (α, split) candidate at one network state."""
        if bandwidth_bps <= 0.0:
            # dead link: every transfer column is unreachable, the device-only
            # column (rtt_mask == 0, bits == 0) stays finite — argmin resolves
            # deterministically to split = L instead of tripping on 0/0 = nan
            comm = np.where(self.rtt_mask > 0.0, np.inf, 0.0)
        else:
            comm = self.bits / bandwidth_bps + rtt_s * self.rtt_mask
        return (self.dev_s + comm) + self.cloud_s

    def decide(self, bandwidth_bps: float, rtt_s: float, sla_s: float) -> Decision:
        """Algorithm 1 over the precomputed tables (exact legacy semantics).

        α-snapping under a step latency model: when the cloud columns are
        plateau-priced (``step_aware_profile``), every α whose padded counts
        land in the same bucket cell produces *identical* latency floats, and
        both argmin paths below — first-feasible α, and the fallback's
        first-occurrence ``np.argmin`` — resolve such ties toward the lowest
        α: the least-pruned, highest-accuracy member of the plateau. The
        snapped choice is never worse than any other tie-break in
        (latency, accuracy) lexicographic order (tests/test_step_planner.py).
        """
        t0 = time.perf_counter()
        lat = self.latency_matrix(bandwidth_bps, rtt_s)
        best_j = np.argmin(lat, axis=1)          # first min → smallest split
        best_lat = lat[np.arange(len(best_j)), best_j]
        feasible = best_lat <= sla_s
        if feasible.any():
            a = int(np.argmax(feasible))         # first feasible = lowest α
            meets = True
        else:
            a = int(np.argmin(best_lat))         # global fallback, lowest α wins ties
            meets = False
        return Decision(float(self.alpha_grid[a]), int(self.candidates[best_j[a]]),
                        float(best_lat[a]), meets, self.schedules[a],
                        time.perf_counter() - t0)

    def sweep(self, bandwidth_bps: float, rtt_s: float,
              sla_s: float = float("inf")) -> list[Decision]:
        """Full (α → best split) map; ``meets_sla`` honest against ``sla_s``."""
        lat = self.latency_matrix(bandwidth_bps, rtt_s)
        best_j = np.argmin(lat, axis=1)
        best_lat = lat[np.arange(len(best_j)), best_j]
        return [Decision(float(a), int(self.candidates[j]), float(l),
                         bool(l <= sla_s), sched)
                for a, j, l, sched in zip(self.alpha_grid, best_j, best_lat,
                                          self.schedules)]

    # -- row lookups (engine accounting) ------------------------------------
    def alpha_index(self, alpha: float) -> int:
        i = int(np.searchsorted(self.alpha_grid, alpha))
        if i >= len(self.alpha_grid) or self.alpha_grid[i] != alpha:
            raise KeyError(f"alpha {alpha} not on the planner grid")
        return i

    def counts_row(self, alpha: float) -> np.ndarray:
        """Token-count row for a grid α (read-only view; don't mutate)."""
        return self.counts[self.alpha_index(alpha)]


# ---------------------------------------------------------------------------
# value-keyed tables cache
# ---------------------------------------------------------------------------

_CACHE: OrderedDict[tuple, PlannerTables] = OrderedDict()
_CACHE_MAX = 64


def _model_signature(model) -> tuple:
    """Hashable value identity for one LatencyModel. Models expose it via
    the protocol's ``signature()``; anything predating the protocol falls
    back to the linear fit's (a, b)."""
    sig = getattr(model, "signature", None)
    if sig is not None:
        return sig()
    return (type(model).__name__, model.a, model.b)


def _profile_signature(profile: ModelProfile) -> tuple:
    """Hashable value identity for a ModelProfile (the LatencyModel
    signatures are tuples of plain floats; the dataclass itself is
    unhashable because the models are mutable)."""
    return (profile.n_layers, profile.x0, profile.token_bytes,
            profile.raw_input_bytes,
            _model_signature(profile.device),
            _model_signature(profile.cloud),
            profile.device_embed_s, profile.cloud_embed_s, profile.head_s,
            profile.schedule_kind)


def tables_for(profile: ModelProfile, config: PlannerConfig | None = None,
               *, t: float | None = None, k: int | None = None,
               alpha_grid: Sequence[float] | None = None) -> PlannerTables:
    """Cached :class:`PlannerTables` for a profile (LRU by profile *value*).

    Prefer ``tables_for(profile, PlannerConfig(...))``; the bare
    ``t=/k=/alpha_grid=`` keywords are the deprecated pre-PlannerConfig call
    shape, kept for one release (both shapes hit the same cache entry)."""
    config = _resolve_config(config, t, k, alpha_grid)
    key = (_profile_signature(profile), config.t, config.k, config.alpha_grid)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        return hit
    tables = PlannerTables.build(profile, config)
    _CACHE[key] = tables
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return tables


# ---------------------------------------------------------------------------
# step-aware profiles (bucketed pruning)
# ---------------------------------------------------------------------------


def step_aware_profile(profile: ModelProfile,
                       bucketing: bucketing_lib.BucketingConfig | None = None,
                       config: PlannerConfig | None = None) -> ModelProfile:
    """The profile with its cloud model snapped to bucket-edge plateaus.

    Enumerates the same per-split edge table the execution path builds
    (``BucketTable.build_for`` over the planner's α grid), unions the edges
    across splits, and replaces ``profile.cloud`` with a
    :class:`~repro_torch.core.profiler.StepProfiler` priced at the padded counts —
    so the planner (and, through ``AcctTables``, the fleet simulator) sees
    the plateaus the bucketed ``--execute`` path actually runs. The device
    model is left smooth: the device partition runs exact geometry on the
    client, only the cloud partition is padded.
    """
    cfg = config or PlannerConfig()
    alphas = cfg.alpha_grid
    if alphas is None:
        alphas = default_alpha_grid(profile.n_layers, profile.x0, cfg.t)
    table = bucketing_lib.BucketTable.build_for(
        profile.n_layers, profile.x0, alphas, kind=profile.schedule_kind,
        config=bucketing)
    edges = sorted({e for es in table.edges_by_split.values() for e in es})
    return dataclasses.replace(
        profile, cloud=profiler.StepProfiler.from_model(profile.cloud, edges))
