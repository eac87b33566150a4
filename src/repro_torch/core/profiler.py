"""Janus §III-C: lightweight latency profilers.

The paper observes per-layer ViT latency is strongly linear in the input token
count (r > 0.85) on both the edge device and the cloud server, and fits one
least-squares linear model per (model, platform).

We reproduce that exactly (``fit_linear`` / ``LinearProfiler``). Because this
container has no TPU to time, platform *samples* come from either:

  * ``AnalyticalPlatform`` — a roofline latency model (FLOPs/peak vs bytes/bw
    with a fixed launch overhead). Note the true per-layer cost has a quadratic
    attention term; the *linear* profiler fits it anyway — reproducing the
    paper's "strong positive linear relationship" observation (Fig. 5), and the
    residual is visible in benchmarks/fig5_linearity.py.
  * measured wall-clock of the layer on its device (used by tests to show
    the fit quality on real timings too).

Everything downstream of a fitted profile (the planner tables, the engine's
phase accounting, the fleet simulator) talks to it through the
:class:`LatencyModel` protocol, so the linear fit is one implementation, not
an assumption. :class:`StepProfiler` is the other: a *plateau* model for
bucket-padded accelerators — latency is a step function of token count,
constant between padding-bucket edges ("Pruning One More Token is Enough",
PAPERS.md) — fitted by binning a token→latency sample grid at the
``core/bucketing.py`` edge table. See ``docs/planner.md``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np
import torch


def fit_linear(samples: Sequence[tuple[float, float]]) -> tuple[float, float, float]:
    """Least-squares fit latency = a*tokens + b. Returns (a, b, pearson_r).

    Degenerate inputs — a single sample, or a zero-variance token grid —
    have no defined slope (``np.polyfit`` would divide by zero); they fall
    back to the flat fit through the mean latency, a = 0.
    """
    if not samples:
        raise ValueError("fit_linear needs at least one (tokens, latency) sample")
    x = np.asarray([s[0] for s in samples], dtype=np.float64)
    y = np.asarray([s[1] for s in samples], dtype=np.float64)
    if len(x) < 2 or float(np.std(x)) == 0.0:
        return 0.0, float(np.mean(y)), 1.0
    a, b = np.polyfit(x, y, 1)
    if len(x) > 2 and np.std(x) > 0 and np.std(y) > 0:
        r = float(np.corrcoef(x, y)[0, 1])
    else:
        r = 1.0
    return float(a), float(b), r


@runtime_checkable
class LatencyModel(Protocol):
    """What the planner/engine/simulator need from a latency predictor.

    ``predict`` must be vectorized: given an ndarray of token counts it
    returns an ndarray of the same shape (the planner evaluates whole
    ``(A, L)`` count matrices in one call); given a scalar it returns a
    float. ``scaled`` returns a copy with every predicted latency multiplied
    by ``s`` (device-tier heterogeneity, ``workload.tier_profile``).
    ``signature`` is a hashable value identity — it keys the planner-tables
    LRU, so two value-equal models must collide. ``to_json`` round-trips
    through :func:`latency_model_from_json`.
    """

    def predict(self, tokens: int | np.ndarray) -> float | np.ndarray: ...

    def scaled(self, s: float) -> "LatencyModel": ...

    def signature(self) -> tuple: ...

    def to_json(self) -> dict: ...


@dataclasses.dataclass
class LinearProfiler:
    """Per-(model, platform) linear latency predictor (seconds per layer)."""
    a: float
    b: float
    r: float = 1.0

    @classmethod
    def from_samples(cls, samples: Sequence[tuple[float, float]]) -> "LinearProfiler":
        a, b, r = fit_linear(samples)
        return cls(a, b, r)

    def predict(self, tokens: int | np.ndarray) -> float | np.ndarray:
        return self.a * tokens + self.b

    def scaled(self, s: float) -> "LinearProfiler":
        return LinearProfiler(self.a * s, self.b * s, self.r)

    def signature(self) -> tuple:
        return ("linear", self.a, self.b)

    def to_json(self) -> dict:
        return {"kind": "linear", "a": self.a, "b": self.b, "r": self.r}

    @classmethod
    def from_json(cls, d: dict) -> "LinearProfiler":
        return cls(float(d["a"]), float(d["b"]), float(d.get("r", 1.0)))


@dataclasses.dataclass
class StepProfiler:
    """Per-layer *step* (plateau) latency predictor for bucket-padded
    accelerators.

    ``edges`` are the sorted token-count plateau boundaries (the padding
    buckets of ``core/bucketing.py``); ``levels[i]`` is the latency of any
    token count in ``(edges[i-1], edges[i]]`` — the cost of running at the
    padded geometry. Counts above the last edge clamp to the last level
    (the fit grid always includes the maximum count, so in-domain queries
    never clamp). Between two edges the predicted latency is *constant*:
    pruning to just below an edge buys a full plateau drop, pruning further
    within a plateau buys nothing — exactly the structure the step-aware
    planner exploits (``docs/planner.md``).
    """
    edges: tuple[int, ...]
    levels: tuple[float, ...]
    r: float = 1.0

    def __post_init__(self):
        self.edges = tuple(int(e) for e in self.edges)
        self.levels = tuple(float(v) for v in self.levels)
        if not self.edges or len(self.edges) != len(self.levels):
            raise ValueError(f"need matching non-empty edges/levels, got "
                             f"{len(self.edges)}/{len(self.levels)}")
        if any(a >= b for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError(f"edges must be strictly increasing: {self.edges}")
        self._edges_arr = np.asarray(self.edges, dtype=np.float64)
        self._levels_arr = np.asarray(self.levels, dtype=np.float64)

    @classmethod
    def from_samples(cls, samples: Sequence[tuple[float, float]],
                     edges: Sequence[int]) -> "StepProfiler":
        """Bin a token→latency sample grid into plateau levels at ``edges``.

        Each sample belongs to the smallest edge >= its token count (samples
        past the last edge clamp onto it); a level is the mean latency of its
        bin. Empty bins fall back to the linear fit of the full grid
        evaluated at the edge, so a sparse grid still yields a total model.
        """
        edges = tuple(sorted({int(e) for e in edges}))
        if not edges:
            raise ValueError("need at least one bucket edge")
        bins: dict[int, list[float]] = {e: [] for e in edges}
        arr = np.asarray(edges, dtype=np.float64)
        for t, lat in samples:
            i = min(int(np.searchsorted(arr, t, side="left")), len(edges) - 1)
            bins[edges[i]].append(float(lat))
        a, b, r = fit_linear(samples)
        levels = tuple(float(np.mean(bins[e])) if bins[e] else a * e + b
                       for e in edges)
        return cls(edges, levels, r)

    @classmethod
    def from_model(cls, model: LatencyModel,
                   edges: Sequence[int]) -> "StepProfiler":
        """Plateau view of an underlying smooth model: running ``t`` tokens
        on bucket-padded hardware costs the smooth model's latency at the
        *padded* count, so ``level[i] = model.predict(edges[i])``."""
        edges = tuple(sorted({int(e) for e in edges}))
        if not edges:
            raise ValueError("need at least one bucket edge")
        return cls(edges, tuple(float(model.predict(float(e))) for e in edges),
                   float(getattr(model, "r", 1.0)))

    def predict(self, tokens: int | np.ndarray) -> float | np.ndarray:
        idx = np.minimum(np.searchsorted(self._edges_arr, tokens, side="left"),
                         len(self.edges) - 1)
        out = self._levels_arr[idx]
        if np.ndim(tokens) == 0:
            return float(out)
        return out

    def scaled(self, s: float) -> "StepProfiler":
        return StepProfiler(self.edges, tuple(v * s for v in self.levels), self.r)

    def signature(self) -> tuple:
        return ("step", self.edges, self.levels)

    def to_json(self) -> dict:
        return {"kind": "step", "edges": list(self.edges),
                "levels": list(self.levels), "r": self.r}

    @classmethod
    def from_json(cls, d: dict) -> "StepProfiler":
        return cls(tuple(d["edges"]), tuple(d["levels"]),
                   float(d.get("r", 1.0)))


_MODEL_KINDS = {"linear": LinearProfiler, "step": StepProfiler}


def latency_model_from_json(d: dict) -> LatencyModel:
    """Inverse of ``LatencyModel.to_json`` (dispatches on ``kind``)."""
    try:
        cls = _MODEL_KINDS[d["kind"]]
    except KeyError:
        raise ValueError(f"unknown latency model kind {d.get('kind')!r}; "
                         f"known: {sorted(_MODEL_KINDS)}") from None
    return cls.from_json(d)


@dataclasses.dataclass(frozen=True)
class AnalyticalPlatform:
    """Roofline latency model for one platform tier.

    Defaults for the two tiers used in benchmarks (loosely calibrated to the
    paper's hardware so Table-I/Fig-2-scale numbers come out comparable):
      edge  ~ Jetson Orin Nano-class:  ~20 TFLOP/s fp16 peak, 0.4 efficiency,
              68 GB/s LPDDR5
      cloud ~ V100-class:             ~112 TFLOP/s fp16 peak, 0.5 efficiency,
              900 GB/s HBM2
    """
    name: str
    peak_flops: float
    mem_bw: float
    efficiency: float = 0.4
    overhead_s: float = 2e-4  # per-layer launch overhead

    def layer_latency(self, tokens: int, d_model: int, d_ff: int) -> float:
        """One transformer block at ``tokens`` input tokens."""
        x = float(tokens)
        proj_flops = 2 * x * (4 * d_model * d_model + 2 * d_model * d_ff)
        attn_flops = 2 * 2 * x * x * d_model
        flops = proj_flops + attn_flops
        bytes_moved = 2.0 * (4 * d_model * d_model + 2 * d_model * d_ff)  # weights (fp16)
        bytes_moved += 2.0 * 8 * x * d_model  # activations in/out of sub-ops
        t = max(flops / (self.peak_flops * self.efficiency), bytes_moved / self.mem_bw)
        return t + self.overhead_s

    def embed_latency(self, tokens: int, d_model: int, patch_dim: int) -> float:
        flops = 2 * tokens * patch_dim * d_model
        return flops / (self.peak_flops * self.efficiency) + self.overhead_s

    def head_latency(self, d_model: int, n_classes: int) -> float:
        return 2 * d_model * n_classes / (self.peak_flops * self.efficiency) + self.overhead_s


# Calibrated so ViT-L@384 (24L, d=1024, ff=4096, 577 tokens) reproduces the
# paper's measurements: edge no-pruning 653.3 ms (Table I), cloud 32.3 ms;
# and ViT-B@224 cloud ~3.9 ms (Fig. 2). See tests/test_profiler_calibration.py.
EDGE_PLATFORM = AnalyticalPlatform("jetson-orin-nano", peak_flops=5e12, mem_bw=68e9,
                                   efficiency=0.119, overhead_s=5e-4)
CLOUD_PLATFORM = AnalyticalPlatform("v100", peak_flops=112e12, mem_bw=900e9,
                                    efficiency=0.114, overhead_s=1e-4)
# TPU tiers for the framework deployment story (DESIGN.md §2)
TPU_EDGE_SLICE = AnalyticalPlatform("v5e-1chip", peak_flops=197e12, mem_bw=819e9,
                                    efficiency=0.5, overhead_s=5e-5)
TPU_POD_SLICE = AnalyticalPlatform("v5e-16chip", peak_flops=16 * 197e12, mem_bw=16 * 819e9,
                                   efficiency=0.45, overhead_s=1e-4)


def profile_platform(platform: AnalyticalPlatform, d_model: int, d_ff: int,
                     token_grid: Sequence[int]) -> LinearProfiler:
    samples = [(t, platform.layer_latency(t, d_model, d_ff)) for t in token_grid]
    return LinearProfiler.from_samples(samples)


def profile_measured(layer_fn: Callable[[int], None], token_grid: Sequence[int],
                     repeats: int = 3) -> LinearProfiler:
    """Fit from wall-clock measurements of ``layer_fn(tokens)``.

    CUDA launches return before the card finishes, so once CUDA is in use
    in this process the timer is bracketed by ``torch.cuda.synchronize()``."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    samples = []
    for t in token_grid:
        layer_fn(t)  # warmup (first launch builds the kernels)
        times = []
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            layer_fn(t)
            sync()
            times.append(time.perf_counter() - t0)
        samples.append((t, min(times)))
    return LinearProfiler.from_samples(samples)
