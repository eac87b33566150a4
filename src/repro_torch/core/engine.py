"""Janus §IV execution engine (Jdevice / Jcloud runtime), PyTorch port of
``repro.core.engine``.

Per frame: estimate bandwidth (harmonic mean of past observations) -> the
dynamic scheduler picks (α, split) from the numpy planner tables -> the
device partition runs embed + layers [0, s) with the ToMe merge schedule ->
the activation is int8-quantized and LZW-compressed for the wire -> the
cloud partition runs layers [s, N) + head. The latency plane is the fitted
profilers plus the measured payload over the trace bandwidth, exactly as
the reference; with ``execute=True`` the model math really runs, eagerly on
the engine's device, with every attention and ToMe matching going through
the Hopper kernels on a card.

``CompiledPlanCache`` keeps the reference's geometry keys and counters, but
PyTorch runs eagerly: it is a memo of partition callables, and ``traces``
counts first builds of a geometry. ``run_cloud_batch`` stacks same-geometry
cloud partitions of a micro-batch into one forward, optionally padding them
to bucket edges (``core.bucketing``). ``shard_params`` and ``rules=`` wait
for the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression, planner, pruning, scheduler as sched_lib
from repro_torch.core.bandwidth import HarmonicMeanEstimator, NetworkTrace
from repro_torch.core.bucketing import BucketTable
from repro_torch.core.pruning import AccuracyModel
from repro_torch.core.scheduler import Decision, ModelProfile
from repro_torch.models import vit as vit_lib
from repro_torch.models.param import flatten
from repro_torch.runtime.device import require_on, resolve_device


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sla_s: float
    t: float = 0.01
    k: int = 5
    quantize_payload: bool = True
    execute: bool = False
    baseline_fixed_r: int = 23  # ToMe max fixed pruning (ViT-L@384; §V-B)
    include_scheduler_overhead: bool = True  # bill Algorithm-1 wall time
    planner: str = "tables"  # "tables" (vectorized) | "legacy" (reference loop)
    # capture-quality multiplier on the accuracy term; 1.0 is the identity
    accuracy_scale: float = 1.0
    # Algorithm-1 knobs as one value object; when set it overrides ``t``/``k``
    planner_cfg: planner.PlannerConfig | None = None

    def __post_init__(self):
        if self.accuracy_scale <= 0:
            raise ValueError(
                f"accuracy_scale must be > 0, got {self.accuracy_scale}")

    @property
    def planner_config(self) -> planner.PlannerConfig:
        """Resolved planner knobs: ``planner_cfg`` when set, else ``t``/``k``."""
        if self.planner_cfg is not None:
            return self.planner_cfg
        return planner.PlannerConfig(t=self.t, k=self.k)


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    """Per-frame latency split into the three serving phases."""
    device_s: float
    comm_s: float
    cloud_s: float

    @property
    def total_s(self) -> float:
        return self.device_s + self.comm_s + self.cloud_s


@dataclasses.dataclass
class FrameResult:
    latency_s: float
    violated: bool
    deviation: float
    alpha: float
    split: int
    accuracy: float
    payload_bytes: float
    bandwidth_bps: float
    queue_s: float = 0.0  # extra delay beyond the standalone frame latency
    logits: Any = None    # real-math output when execute=True (else None)


@dataclasses.dataclass
class ExecPlan:
    """Pending real-math execution state for one frame (execute=True): the
    post-wire activation entering the cloud partition, and its logits once
    the cloud partition ran."""
    schedule: tuple[int, ...]   # exec-geometry merge schedule
    split: int                  # exec-geometry split (0..n_exec+1)
    x: Any = None
    sizes: Any = None
    logits: Any = None


@dataclasses.dataclass(frozen=True)
class FrameStep:
    """One planned/accounted frame, before it is stamped into a FrameResult."""
    decision: Decision
    breakdown: LatencyBreakdown
    payload_bytes: float
    bandwidth_bps: float
    accuracy: float
    exec_plan: ExecPlan | None = None


@dataclasses.dataclass
class RunStats:
    """Frame-level statistics, total on the empty frame list."""
    frames: list[FrameResult]

    def _mean(self, values: list[float]) -> float:
        return float(np.mean(values)) if values else 0.0

    @property
    def violation_ratio(self) -> float:
        return self._mean([f.violated for f in self.frames])

    @property
    def avg_throughput_fps(self) -> float:
        if not self.frames:
            return 0.0
        total = sum(f.latency_s for f in self.frames)
        return len(self.frames) / total if total > 0 else float("inf")

    @property
    def avg_latency_s(self) -> float:
        return self._mean([f.latency_s for f in self.frames])

    @property
    def p50_latency_s(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.percentile([f.latency_s for f in self.frames], 50))

    @property
    def p99_latency_s(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.percentile([f.latency_s for f in self.frames], 99))

    @property
    def avg_accuracy(self) -> float:
        return self._mean([f.accuracy for f in self.frames])

    @property
    def avg_deviation(self) -> float:
        return self._mean([f.deviation for f in self.frames])

    @property
    def avg_queue_s(self) -> float:
        return self._mean([f.queue_s for f in self.frames])


# ---------------------------------------------------------------------------
# split execution (the real math path)
# ---------------------------------------------------------------------------


def device_forward(params: dict, cfg: vit_lib.ViTConfig, images: torch.Tensor,
                   schedule: Sequence[int], split: int):
    """Jdevice: embed + layers [0, split). Returns (x, sizes)."""
    x = vit_lib.embed_tokens(params, cfg, images)
    sizes = torch.ones(x.shape[:2], dtype=cfg.dtype, device=x.device)
    return vit_lib.run_blocks(params, cfg, x, sizes, schedule, 0, split)


def cloud_forward(params: dict, cfg: vit_lib.ViTConfig, x: torch.Tensor,
                  sizes: torch.Tensor, schedule: Sequence[int], split: int) -> torch.Tensor:
    """Jcloud: layers [split, N) + head."""
    x, _ = vit_lib.run_blocks(params, cfg, x, sizes, schedule, split, cfg.n_layers)
    return vit_lib.head_apply(params, cfg, x)


def wire_roundtrip(x: torch.Tensor, dtype: torch.dtype, quantize: bool):
    """Encode the activation for the wire (quantize + LZW on the host) and
    decode it back onto x's device in ``dtype``. Returns (x', payload)."""
    payload = compression.activation_payload(x, quantize=quantize)
    decoded = torch.from_numpy(compression.decode_activation(payload))
    return decoded.to(device=x.device, dtype=dtype), payload


def split_inference(params: dict, cfg: vit_lib.ViTConfig, images: torch.Tensor,
                    schedule: Sequence[int], split: int, *, quantize: bool = False):
    """Full Jdevice -> wire -> Jcloud round trip. Returns (logits, payload|None)."""
    n = cfg.n_layers
    split = min(max(split, 0), n + 1)
    s = n if split == n + 1 else split
    x, sizes = device_forward(params, cfg, images, schedule, s)
    payload = None
    if split not in (0, n + 1):
        x, payload = wire_roundtrip(x, cfg.dtype, quantize)
    return cloud_forward(params, cfg, x, sizes, schedule, s), payload


class CompiledPlanCache:
    """Partition callables keyed by (partition, model config, schedule,
    split, input geometry), with the reference's counters: ``hits`` /
    ``misses`` count lookups, ``traces`` (and ``traces_by_kind`` per
    partition program) count first builds of a geometry. PyTorch runs
    eagerly, so a build is a closure over its geometry, not a compiled
    program; the counters keep the reference's retrace bounds testable."""

    def __init__(self):
        self._fns: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.traces_by_kind: dict[str, int] = {}

    def _get(self, kind: str, key: tuple, build: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            self.traces += 1
            self.traces_by_kind[kind] = self.traces_by_kind.get(kind, 0) + 1
            fn = self._fns[key] = build()
        else:
            self.hits += 1
        return fn

    @staticmethod
    def _shape_key(t: torch.Tensor) -> tuple:
        return (tuple(t.shape), str(t.dtype))

    def device_fn(self, cfg: vit_lib.ViTConfig, schedule: tuple[int, ...],
                  split: int, images: torch.Tensor) -> Callable:
        key = ("device", cfg, schedule, split, self._shape_key(images))
        return self._get("device", key, lambda: lambda params, images: device_forward(
            params, cfg, images, schedule, split))

    def cloud_fn(self, cfg: vit_lib.ViTConfig, schedule: tuple[int, ...],
                 split: int, x: torch.Tensor) -> Callable:
        key = ("cloud", cfg, schedule, split, self._shape_key(x))
        return self._get("cloud", key, lambda: lambda params, x, sizes: cloud_forward(
            params, cfg, x, sizes, schedule, split))

    def cloud_padded_fn(self, cfg: vit_lib.ViTConfig, suffix: tuple[int, ...],
                        split: int, x: torch.Tensor) -> Callable:
        """Bucketed cloud partition: one callable for every plan that shares
        (schedule suffix past the split, split, bucket edge)."""
        key = ("cloud_padded", cfg, suffix, split, self._shape_key(x))
        schedule = (0,) * split + tuple(suffix)

        def build():
            def run(params, x, sizes):
                x2, _ = vit_lib.run_blocks_padded(params, cfg, x, sizes, schedule,
                                                  split, cfg.n_layers)
                return vit_lib.head_apply(params, cfg, x2)
            return run

        return self._get("cloud_padded", key, build)


def _pad_tokens(x: torch.Tensor, sizes: torch.Tensor, edge: int):
    """Pad the token dim up to ``edge`` with zero-value, zero-size tokens.
    Size 0 is the whole masking contract: ``log(0) = -inf`` proportional-
    attention bias excludes pads from every softmax exactly, and the
    pad-aware merge keys off ``sizes <= 0``."""
    pad = edge - x.shape[1]
    if pad == 0:
        return x, sizes
    return F.pad(x, (0, 0, 0, pad)), F.pad(sizes, (0, pad))


def _cat(ts: list[torch.Tensor]) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=0)


def run_cloud_batch(cache: CompiledPlanCache, cfg: vit_lib.ViTConfig,
                    params: dict, plans: Sequence[ExecPlan],
                    buckets: BucketTable | None = None) -> None:
    """Execute pending cloud partitions, stacking same-geometry plans into
    one forward. Fills each plan's ``logits`` in place.

    Without ``buckets``, plans batch only when their full (schedule, split,
    token-count) geometry matches. With a ``BucketTable``, plans that share
    the schedule suffix past the split are padded up to a common bucket edge
    and batch together through ``cloud_padded_fn``."""
    n = cfg.n_layers
    groups: dict[tuple, list[ExecPlan]] = {}
    for plan in plans:
        if plan is None or plan.logits is not None:
            continue
        s = n if plan.split == n + 1 else plan.split
        if buckets is None:
            key = (plan.schedule, s, tuple(plan.x.shape[1:]), str(plan.x.dtype))
        else:
            edge = buckets.edge_for(s, plan.x.shape[1])
            key = (plan.schedule[s:], s, edge, plan.x.shape[2], str(plan.x.dtype))
        groups.setdefault(key, []).append(plan)
    for key, members in groups.items():
        if buckets is None:
            schedule, s = key[0], key[1]
            x = _cat([m.x for m in members])
            sizes = _cat([m.sizes for m in members])
            fn = cache.cloud_fn(cfg, schedule, s, x)
        else:
            suffix, s, edge = key[0], key[1], key[2]
            # pad once per distinct token count, not once per member
            by_count: dict[int, list[ExecPlan]] = {}
            for m in members:
                by_count.setdefault(m.x.shape[1], []).append(m)
            chunks, members = [], []
            for t in sorted(by_count):
                ms = by_count[t]
                chunks.append(_pad_tokens(_cat([m.x for m in ms]),
                                          _cat([m.sizes for m in ms]), edge))
                members.extend(ms)
            x = _cat([c[0] for c in chunks])
            sizes = _cat([c[1] for c in chunks])
            fn = cache.cloud_padded_fn(cfg, suffix, s, x)
        logits = fn(params, x, sizes)
        off = 0
        for m in members:
            b = m.x.shape[0]
            m.logits = logits[off:off + b]
            off += b


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class JanusEngine:
    """Single-stream Janus engine. Runs on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``; raises if no card is there). ``params``
    and the images of executed frames must already lie on that device."""

    def __init__(self, profile: ModelProfile, engine_cfg: EngineConfig,
                 acc_model: AccuracyModel | None = None,
                 model_cfg: vit_lib.ViTConfig | None = None,
                 params: dict | None = None,
                 plan_cache: CompiledPlanCache | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if params is not None:
            require_on(self.device, {f"params[{k!r}]": v for k, v in flatten(params).items()})
        self.profile = profile
        self.cfg = engine_cfg
        self.acc = acc_model or AccuracyModel()
        self.model_cfg = model_cfg
        self.params = params
        self._estimator = HarmonicMeanEstimator()
        self.tables = planner.tables_for(profile, engine_cfg.planner_config)
        self.plan_cache = plan_cache or CompiledPlanCache()
        self._fixed_schedule = tuple(pruning.clamp_schedule(
            pruning.fixed_schedule(engine_cfg.baseline_fixed_r, profile.n_layers),
            profile.x0))
        self._fixed_counts = np.asarray(
            pruning.token_counts(profile.x0, self._fixed_schedule), dtype=np.int64)
        self._counts_memo: dict[tuple[int, ...], np.ndarray] = {
            self._fixed_schedule: self._fixed_counts}

    # -- latency accounting -------------------------------------------------
    def _counts_for(self, schedule: tuple[int, ...]) -> np.ndarray:
        counts = self._counts_memo.get(schedule)
        if counts is None:
            counts = self._counts_memo[schedule] = np.asarray(
                pruning.token_counts(self.profile.x0, schedule), dtype=np.int64)
        return counts

    def account_breakdown(self, counts: Sequence[int], split: int,
                          payload_bytes: float, bandwidth_bps: float,
                          rtt_s: float) -> LatencyBreakdown:
        """Phase-separated latency for one frame at the given split."""
        p = self.profile
        n = p.n_layers
        counts = np.asarray(counts, dtype=np.float64)
        if split == 0:
            comm = p.raw_input_bytes * 8 / bandwidth_bps + rtt_s
            cloud = p.cloud_embed_s + float(p.cloud.predict(counts[:n]).sum()) + p.head_s
            return LatencyBreakdown(0.0, comm, cloud)
        if split == n + 1:
            dev = p.device_embed_s + float(p.device.predict(counts[:n]).sum()) + p.head_s
            return LatencyBreakdown(dev, 0.0, 0.0)
        dev = p.device_embed_s + float(p.device.predict(counts[:split]).sum())
        comm = payload_bytes * 8 / bandwidth_bps + rtt_s
        cloud = float(p.cloud.predict(counts[split:n]).sum()) + p.head_s
        return LatencyBreakdown(dev, comm, cloud)

    def _account(self, counts: Sequence[int], split: int, payload_bytes: float,
                 bandwidth_bps: float, rtt_s: float) -> float:
        return self.account_breakdown(counts, split, payload_bytes,
                                      bandwidth_bps, rtt_s).total_s

    def _payload_bytes(self, counts: Sequence[int], split: int) -> float:
        if split in (0, self.profile.n_layers + 1):
            return 0.0
        return float(counts[split]) * self.profile.token_bytes

    def _decide(self, policy: str, bandwidth_est: float, rtt_s: float) -> Decision:
        p, c = self.profile, self.cfg
        n = p.n_layers
        if policy == "janus":
            if c.planner == "legacy":
                pc = c.planner_config
                return sched_lib._reference_schedule(p, bandwidth_est, rtt_s,
                                                     c.sla_s, t=pc.t, k=pc.k,
                                                     alpha_grid=pc.alpha_grid)
            return self.tables.decide(bandwidth_est, rtt_s, c.sla_s)
        fixed, counts = self._fixed_schedule, self._fixed_counts
        if policy == "device":
            return Decision(0.0, n + 1, self._account(counts, n + 1, 0, bandwidth_est, rtt_s),
                            True, fixed)
        if policy == "cloud":
            return Decision(0.0, 0, self._account(counts, 0, 0, bandwidth_est, rtt_s),
                            True, fixed)
        if policy == "mixed":  # NeuroSurgeon-for-ViT: pick the better endpoint
            lat_d = self._account(counts, n + 1, 0, bandwidth_est, rtt_s)
            lat_c = self._account(counts, 0, 0, bandwidth_est, rtt_s)
            s = n + 1 if lat_d <= lat_c else 0
            return Decision(0.0, s, min(lat_d, lat_c), True, fixed)
        raise ValueError(policy)

    # -- real-math execution -------------------------------------------------
    def _execute_device(self, dec: Decision,
                        images: torch.Tensor) -> tuple[ExecPlan, float | None]:
        """Run the device partition and encode the wire payload. The timing
        plane may model a bigger ViT than the executed one: (alpha, split) is
        remapped onto the executed geometry. Returns the pending ExecPlan and
        the measured payload size (None = no transfer)."""
        n_exec = self.model_cfg.n_layers
        sched_exec = tuple(pruning.make_schedule(
            self.profile.schedule_kind, dec.alpha, n_exec, self.model_cfg.num_tokens))
        n_prof = self.profile.n_layers
        if dec.split >= n_prof + 1:
            split_exec = n_exec + 1
        else:
            split_exec = min(round(dec.split * n_exec / n_prof), n_exec)
        s = n_exec if split_exec == n_exec + 1 else split_exec
        dev_fn = self.plan_cache.device_fn(self.model_cfg, sched_exec, s, images)
        x, sizes = dev_fn(self.params, images)
        payload_bytes = None
        if split_exec not in (0, n_exec + 1):
            x, payload = self._wire(x)
            payload_bytes = payload.nbytes
        return ExecPlan(sched_exec, split_exec, x=x, sizes=sizes), payload_bytes

    def _wire(self, x: torch.Tensor):
        """Device activation -> wire payload -> cloud activation."""
        return wire_roundtrip(x, self.model_cfg.dtype, self.cfg.quantize_payload)

    def finish_execution(self, plan: ExecPlan) -> None:
        """Run a pending cloud partition inline (single-stream path)."""
        if plan.logits is not None:
            return
        run_cloud_batch(self.plan_cache, self.model_cfg, self.params, [plan])

    # -- per-frame step -------------------------------------------------------
    def plan_frame(self, frame_idx: int, trace: NetworkTrace, policy: str,
                   estimator: HarmonicMeanEstimator,
                   images: torch.Tensor | None = None,
                   defer_cloud: bool = False) -> FrameStep:
        """``decide -> account`` for one frame; the caller owns the estimator
        and must ``observe`` the returned ``bandwidth_bps`` after the frame.
        With ``defer_cloud=True`` an executed frame's cloud partition is left
        pending in ``step.exec_plan`` for batched dispatch."""
        b_est = estimator.estimate()
        dec = self._decide(policy, b_est, trace.rtt_s)
        counts = self._counts_for(dec.schedule)
        b_true = trace.at(frame_idx)

        payload_bytes = self._payload_bytes(counts, dec.split)
        exec_plan = None
        if self.cfg.execute and self.params is not None and images is not None:
            require_on(self.device, {"images": images})
            exec_plan, measured = self._execute_device(dec, images)
            if measured is not None:
                payload_bytes = measured
            n_exec = self.model_cfg.n_layers
            if not defer_cloud or exec_plan.split == n_exec + 1:
                # device-only frames never enter the shared cloud tier
                self.finish_execution(exec_plan)

        bd = self.account_breakdown(counts, dec.split, payload_bytes, b_true,
                                    trace.rtt_s)
        acc = self.acc.accuracy(self.profile.x0, dec.schedule) * self.cfg.accuracy_scale
        return FrameStep(decision=dec, breakdown=bd, payload_bytes=payload_bytes,
                         bandwidth_bps=b_true, accuracy=acc, exec_plan=exec_plan)

    def overhead_s(self, step: FrameStep) -> float:
        return step.decision.scheduler_overhead_s \
            if self.cfg.include_scheduler_overhead else 0.0

    def frame_result(self, step: FrameStep, queue_s: float = 0.0) -> FrameResult:
        """Stamp a planned frame into a result; ``queue_s`` is any extra delay
        a shared cloud tier added on top of the standalone latency."""
        lat = step.breakdown.total_s + self.overhead_s(step) + queue_s
        logits = step.exec_plan.logits if step.exec_plan is not None else None
        return FrameResult(
            latency_s=lat, violated=lat > self.cfg.sla_s,
            deviation=max(0.0, (lat - self.cfg.sla_s) / self.cfg.sla_s),
            alpha=step.decision.alpha, split=step.decision.split,
            accuracy=step.accuracy, payload_bytes=step.payload_bytes,
            bandwidth_bps=step.bandwidth_bps, queue_s=queue_s, logits=logits)

    # -- main loop ------------------------------------------------------------
    def run_trace(self, trace: NetworkTrace, n_frames: int, policy: str = "janus",
                  images: torch.Tensor | None = None) -> RunStats:
        self._estimator = HarmonicMeanEstimator(
            cold_start_bps=float(np.mean(trace.bps)))
        frames: list[FrameResult] = []
        for i in range(n_frames):
            step = self.plan_frame(i, trace, policy, self._estimator, images=images)
            frames.append(self.frame_result(step))
            self._estimator.observe(step.bandwidth_bps)
        return RunStats(frames)
