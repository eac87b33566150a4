"""Multi-stream Janus serving runtime: N clients, one shared cloud tier.
PyTorch port of ``repro.serving.fleet``: the same numpy simulator, with
the port's engine executing the partitions on ``device`` (``cuda`` unless
the caller passes ``device="cpu"``).

The paper's evaluation (§V-B) runs a single client stream; the regime the
ROADMAP cares about — and the one DeViT-style collaborative inference and
near-edge "serve many edge clients" systems study — is many concurrent streams
contending for a shared cloud. This module drives N closed-loop client
streams, each with

  * its own ``NetworkTrace`` (its radio conditions),
  * its own ``HarmonicMeanEstimator`` (bandwidth belief never leaks across
    clients),
  * its own SLA / policy / per-stream Janus scheduler state
    (a dedicated ``JanusEngine`` sharing the fitted ``ModelProfile``),

through a shared cloud tier with *finite batched capacity*: cloud-partition
work items are grouped by a ``MicroBatcher`` (deadline window ``max_wait_s`` or
``max_batch``, whichever first — expiry via the ``poll`` path), then executed
on one of ``capacity`` batch executors. When every executor is busy a batch
queues, and the queueing delay lands in the affected frames' latency
(``FrameResult.queue_s``).

The per-frame physics is exactly the single-stream engine's
``plan_frame`` (decide -> account -> observe), so with one stream,
``max_batch=1`` and free capacity the fleet reproduces ``JanusEngine.
run_trace`` numbers identically — tested in ``tests/test_serving_fleet.py``.

``run()`` executes on the event-heap simulator core
(``repro_torch.serving.simcore``): the same discrete-event semantics with planner
decisions batched per (tier, profile) group and per-stream state in
preallocated arrays, so simulation cost scales with *events* rather than
``streams x frames x Python overhead`` (thousands of streams per sweep;
``benchmarks/fleet_scale_bench.py``). The retired per-frame loop survives as
``run_reference()``, the bit-exactness oracle for ``tests/test_simcore.py``
— it is not a production path.

Simulation model (discrete-event, one heap):

  frame start t0 (closed loop: previous frame done, or the stream period)
    -> scheduler overhead + device partition + uplink transfer on the
       client's own resources: ready at t0 + overhead + device_s + comm_s
    -> if the decision has cloud work: offer to the shared MicroBatcher;
       a flushed batch runs for ``max(cloud_s) * (1 + batch_growth*(B-1))``
       on the earliest-free executor
    -> frame completes; latency = completion - t0; next frame starts.

Device-only decisions (split = N+1, the blocked-network failover) never touch
the cloud tier, so a saturated cloud pushes Janus streams toward local
execution exactly as the paper's scheduler would under a slow network.

With ``execute=True`` the real model math follows the same topology: the
device partition runs (eagerly, through the fleet-shared
``CompiledPlanCache`` and the Hopper kernels on a card) at plan time, and
the pending cloud partitions of a dispatched micro-batch execute as one
stacked batched forward per geometry group
(``engine.run_cloud_batch``) instead of serially per frame.

Workload hooks (driven declaratively by ``repro_torch.serving.workload``):

  * **open-loop arrivals** — a stream with ``arrival_times`` launches frame i
    at the given absolute time instead of waiting for frame i-1 (closed loop
    remains the default). Overlapping frames of one stream serialize their
    scheduler+device phase on the client's single device (comm pipelines on
    the radio). ``max_inflight`` is the per-stream admission controller: an
    arrival finding that many frames still in flight is *dropped* (counted in
    ``FleetStats.dropped_per_stream``), so overload shows up as a drop ratio
    instead of unbounded queueing.
  * **heterogeneous device tiers** — ``StreamSpec.profile`` overrides the
    fleet-wide ``ModelProfile`` for that stream's engine, so a phone-class
    client plans against phone-class device latencies. Tier profiles are
    value-equal per tier, so ``planner.tables_for`` shares one planner-tables
    instance per *tier*, not per stream.
  * **cloud autoscaling** — an ``Autoscaler`` samples the shared tier every
    ``interval_s`` and grows/shrinks the executor count between
    ``min_capacity``/``max_capacity`` (with cooldown), either reactively from
    windowed utilization or predictively from an EWMA arrival-rate forecast
    (``AutoscaleConfig.policy="predictive"``); the capacity timeline and
    capacity-seconds cost land in ``FleetStats``.
  * **cloud regions** — the "shared cloud tier" generalizes to R regional
    *cells* (``RegionSpec``): each region owns its own executor pool,
    micro-batcher, and (optional) autoscaler, plus an RTT offset on top of
    the stream's network trace (a stream homed on a far region pays that
    region's distance). Streams carry a home-region affinity
    (``StreamSpec.region``); when the home region's executor queue exceeds
    ``spill_slack_s``, the frame *spills over* to the cheapest other region
    — estimated queue delay plus the extra round-trip RTT
    (``max(0, offset_r - offset_home)``) — and pays that extra RTT before
    entering the remote batcher. ``FleetStats.per_region`` reports each
    cell's utilization, spillover ratio, and capacity-seconds. A one-region
    fleet (the default) reproduces the classic shared tier bit for bit.
  * **SLA classes** — each stream names an ``SlaClass``
    (``repro_torch.serving.sla``): the class scales the stream's SLA budget, and a
    fleet with more than one class (or ``priority=True``) swaps the FIFO
    micro-batcher for ``PriorityMicroBatcher`` — admission ordered by (aged
    class priority, deadline slack), per-class deadline windows, preemptive
    lane draining — so tight-SLA interactive frames stop queueing behind
    batch traffic exactly when the network degrades. ``FleetStats.per_class``
    reports per-class violation/drop ratios and latency percentiles. An
    all-default-class fleet keeps the FIFO batcher and reproduces the
    classic runtime bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools

import numpy as np

from repro_torch.core.bandwidth import HarmonicMeanEstimator, NetworkTrace
from repro_torch.core.bucketing import BucketingConfig, BucketTable
from repro_torch.core.engine import (CompiledPlanCache, EngineConfig, FrameResult,
                                     FrameStep, JanusEngine, RunStats,
                                     run_cloud_batch)
from repro_torch.core.pruning import AccuracyModel
from repro_torch.core.scheduler import ModelProfile
from repro_torch.serving import sla as sla_lib
from repro_torch.serving.batcher import MicroBatcher, PriorityMicroBatcher, Request
from repro_torch.serving.faults import FaultSpec, RecoveryStats

__all__ = ["FleetRuntime", "FleetStats", "RegionStats", "RegionSpec",
           "StreamSpec", "CloudTierConfig", "Autoscaler", "AutoscaleConfig",
           "ClassStats", "FaultSpec", "RecoveryStats",
           "default_cloud_config"]


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One client stream of the fleet."""
    trace: NetworkTrace
    n_frames: int
    policy: str = "janus"
    sla_s: float | None = None   # per-stream SLA override (None = fleet default)
    period_s: float = 0.0        # min frame spacing; 0 = back-to-back closed loop
    # -- workload hooks (all default to the classic closed-loop behavior) --
    arrival_times: tuple[float, ...] | None = None
    # open-loop: absolute arrival time per frame (None = closed loop)
    max_inflight: int = 0        # admission: drop arrivals beyond this many
    # in-flight frames (0 = unbounded; closed loop never exceeds 1)
    profile: ModelProfile | None = None  # device-tier override (None = fleet-wide)
    tier: str = ""               # tier label for reporting only
    sla_class: str = sla_lib.DEFAULT_CLASS
    # SLA class (repro_torch.serving.sla): scales the stream's SLA budget and
    # drives priority admission in the shared tier's micro-batcher
    accuracy_scale: float = 1.0  # capture-quality multiplier on the accuracy
    # term (set from the device tier: a phone-class camera degrades accuracy,
    # not just latency); 1.0 reproduces the unscaled model bit-exact
    region: int = 0              # home cloud region (index into the fleet's
    # RegionSpec list; 0 — the only region — for classic single-cell fleets).
    # The home region's RTT offset is baked into the stream's trace by the
    # workload layer, so planning accounts it in the engine's float order.


@dataclasses.dataclass(frozen=True)
class CloudTierConfig:
    """Shared cloud tier: ``capacity`` concurrent batch executors fed by a
    deadline-window micro-batcher. ``batch_growth`` models the sub-linear cost
    of batched execution: a B-frame batch runs for
    ``max(cloud_s) * (1 + batch_growth * (B - 1))``."""
    capacity: int = 4
    max_batch: int = 8
    max_wait_s: float = 0.005
    batch_growth: float = 0.15

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"cloud capacity must be >= 1, got {self.capacity}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.batch_growth < 0:
            raise ValueError(f"batch_growth must be >= 0, got {self.batch_growth}")


def default_cloud_config(n_streams: int) -> CloudTierConfig:
    """Sensible shared-tier defaults for N streams: one batch executor per
    ``max_batch``-worth of streams. Capacity scales with fleet size all the
    way up — the old hard 32-executor cap made every closed-loop fleet past
    ~256 streams pin near-total SLA violation (the simulator outran the
    scenario model); city-scale fleets now split this pool across regional
    cells instead (``RegionSpec`` / ``workload.RegionConfig``). With one
    stream the batcher is transparent (``max_batch=1`` flushes every offer
    immediately) and capacity is irrelevant, which is what makes the N=1
    fleet bit-identical to the single-stream engine."""
    max_batch = max(1, min(8, n_streams))
    capacity = max(1, -(-n_streams // max_batch))
    return CloudTierConfig(capacity=capacity, max_batch=max_batch)


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One regional cloud cell: a resolved executor pool the fleet runtime
    can instantiate directly (the JSON-facing layer with defaults lives in
    ``workload.RegionConfig``). ``rtt_offset_s`` is the extra round-trip to
    this region on top of a stream's trace RTT — the workload layer bakes
    the *home* region's offset into each stream's trace, so here it only
    prices spillover routing (``max(0, offset_target - offset_home)``) and
    labels the report."""
    name: str = "cloud"
    capacity: int = 4
    rtt_offset_s: float = 0.0
    autoscale: AutoscaleConfig | None = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(
                f"region capacity must be >= 1, got {self.capacity}")
        if self.rtt_offset_s < 0:
            raise ValueError(
                f"rtt_offset_s must be >= 0, got {self.rtt_offset_s}")


AUTOSCALE_POLICIES = ("utilization", "predictive")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Scaling policy for the shared tier's executor count.

    ``policy="utilization"`` (reactive, the default): every ``interval_s``
    the runtime samples windowed utilization (cloud busy seconds dispatched
    in the window / ``capacity * interval_s``) and grows by ``step`` above
    ``high_util``, shrinks by ``step`` below ``low_util``, clamped to
    [``min_capacity``, ``max_capacity``]; after a change no further change
    happens for ``cooldown_s``.

    ``policy="predictive"`` (queue-depth feed-forward): every ``interval_s``
    the runtime updates an EWMA (``ewma_alpha``) of the cloud-bound arrival
    rate and of per-frame cloud service time, then provisions for the
    forecast work over the next ``lookahead_s`` —

        target = ceil((backlog_s + rate * lookahead_s * service_s)
                      / lookahead_s)

    where ``backlog_s`` is the service already queued or running. The
    controller jumps straight to the clamped target (no ``step`` limit):
    the point of forecasting is to cut the reaction lag a step-limited
    utilization controller pays climbing through intermediate capacities.
    """
    min_capacity: int = 1
    max_capacity: int = 16
    interval_s: float = 0.25
    cooldown_s: float = 0.5
    high_util: float = 0.85
    low_util: float = 0.30
    step: int = 1
    policy: str = "utilization"
    lookahead_s: float = 0.5     # predictive: provisioning horizon
    ewma_alpha: float = 0.4      # predictive: forecast smoothing (0, 1]

    def __post_init__(self):
        if self.min_capacity < 1:
            raise ValueError(f"min_capacity must be >= 1, got {self.min_capacity}")
        if self.max_capacity < self.min_capacity:
            raise ValueError("max_capacity must be >= min_capacity, got "
                             f"{self.max_capacity} < {self.min_capacity}")
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        if not 0.0 <= self.low_util < self.high_util:
            raise ValueError("need 0 <= low_util < high_util, got "
                             f"{self.low_util} / {self.high_util}")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")
        if self.policy not in AUTOSCALE_POLICIES:
            raise ValueError(f"policy must be one of {AUTOSCALE_POLICIES}, "
                             f"got {self.policy!r}")
        if self.lookahead_s <= 0:
            raise ValueError(f"lookahead_s must be > 0, got {self.lookahead_s}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")


class Autoscaler:
    """Stateful controller for one fleet run (tracks the cooldown clock and,
    for the predictive policy, the EWMA forecast state)."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._last_change_s = -float("inf")
        self.ewma_rate_fps: float | None = None      # cloud arrivals / s
        self.ewma_service_s: float | None = None     # per-frame cloud service

    def initial_capacity(self, configured: int) -> int:
        return min(max(configured, self.cfg.min_capacity), self.cfg.max_capacity)

    def decide(self, now: float, utilization: float, capacity: int) -> int:
        c = self.cfg
        if now - self._last_change_s < c.cooldown_s:
            return capacity
        if utilization > c.high_util and capacity < c.max_capacity:
            self._last_change_s = now
            return min(capacity + c.step, c.max_capacity)
        if utilization < c.low_util and capacity > c.min_capacity:
            self._last_change_s = now
            return max(capacity - c.step, c.min_capacity)
        return capacity

    def observe_rate(self, arrivals: int, window_s: float) -> float:
        """Fold one control window's cloud-bound arrival count into the EWMA
        rate forecast; returns the updated rate (arrivals / s)."""
        inst = arrivals / window_s
        a = self.cfg.ewma_alpha
        self.ewma_rate_fps = inst if self.ewma_rate_fps is None \
            else a * inst + (1.0 - a) * self.ewma_rate_fps
        return self.ewma_rate_fps

    def observe_service(self, per_frame_service_s: float) -> float:
        """Fold one dispatched batch's per-frame service time into the EWMA
        service estimate; returns the updated estimate."""
        a = self.cfg.ewma_alpha
        self.ewma_service_s = per_frame_service_s \
            if self.ewma_service_s is None \
            else a * per_frame_service_s + (1.0 - a) * self.ewma_service_s
        return self.ewma_service_s

    def decide_predictive(self, now: float, backlog_s: float,
                          capacity: int) -> int:
        """Provision for forecast work over the lookahead window (see
        ``AutoscaleConfig``); jumps straight to the clamped target."""
        c = self.cfg
        if now - self._last_change_s < c.cooldown_s:
            return capacity
        rate = self.ewma_rate_fps or 0.0
        service = self.ewma_service_s or 0.0
        work_s = backlog_s + rate * c.lookahead_s * service
        target = int(np.ceil(work_s / c.lookahead_s)) if work_s > 0 else 0
        target = min(max(target, c.min_capacity), c.max_capacity)
        if target != capacity:
            self._last_change_s = now
        return target


@dataclasses.dataclass
class ClassStats:
    """Frame statistics for one SLA class across the fleet. Safe on an empty
    class (a class named by a stream that completed zero frames reports
    0.0 ratios, not a division by zero)."""
    name: str
    stats: RunStats
    dropped: int = 0

    @property
    def frames(self) -> int:
        return len(self.stats.frames)

    @property
    def violation_ratio(self) -> float:
        return self.stats.violation_ratio

    @property
    def p50_latency_s(self) -> float:
        return self.stats.p50_latency_s

    @property
    def p99_latency_s(self) -> float:
        return self.stats.p99_latency_s

    @property
    def avg_queue_s(self) -> float:
        return self.stats.avg_queue_s

    @property
    def avg_accuracy(self) -> float:
        return self.stats.avg_accuracy

    @property
    def drop_ratio(self) -> float:
        offered = self.frames + self.dropped
        return self.dropped / offered if offered else 0.0


@dataclasses.dataclass
class RegionStats:
    """One regional cell's slice of a fleet run: its capacity cost, load,
    and how much of its home traffic spilled elsewhere."""
    name: str
    rtt_offset_s: float
    capacity: int                # configured (initial) executor count
    busy_s: float
    horizon_s: float
    # this region's executor-count step function [(t, capacity), ...]
    capacity_timeline: list[tuple[float, int]] = \
        dataclasses.field(default_factory=list)
    offered: int = 0             # cloud-bound frames homed on this region
    spilled_out: int = 0         # of those, routed to another region
    served: int = 0              # frames this region's executors ran
    batches: int = 0             # micro-batches this region dispatched

    @property
    def capacity_seconds(self) -> float:
        if self.horizon_s <= 0:
            return 0.0
        tl = self.capacity_timeline or [(0.0, self.capacity)]
        total = 0.0
        for (t0, c), (t1, _) in zip(tl, tl[1:] + [(self.horizon_s, 0)]):
            t1 = min(t1, self.horizon_s)
            if t1 > t0:
                total += c * (t1 - t0)
        return total

    @property
    def utilization(self) -> float:
        cap_s = self.capacity_seconds
        if cap_s <= 0:
            return 0.0
        return min(1.0, self.busy_s / cap_s)

    @property
    def spill_ratio(self) -> float:
        """Home-region frames routed elsewhere / home-region cloud offers."""
        return self.spilled_out / self.offered if self.offered else 0.0


@dataclasses.dataclass
class FleetStats:
    per_stream: list[RunStats]
    cloud_busy_s: float
    horizon_s: float
    capacity: int                # configured (initial) executor count
    batch_sizes: list[int]
    dropped_per_stream: list[int] = dataclasses.field(default_factory=list)
    # executor-count step function [(t, capacity), ...]; static runs hold the
    # single entry (0, capacity). Multi-region runs merge the per-region
    # timelines into a fleet-total step function here.
    capacity_timeline: list[tuple[float, int]] = \
        dataclasses.field(default_factory=list)
    # SLA class of stream i (parallel to per_stream; empty = all default)
    stream_classes: list[str] = dataclasses.field(default_factory=list)
    # one entry per regional cell, in RegionSpec order (single-cell runs get
    # one "cloud" entry); home region of stream i parallels per_stream
    per_region: list[RegionStats] = dataclasses.field(default_factory=list)
    stream_regions: list[int] = dataclasses.field(default_factory=list)
    # per-region failure/recovery accounting (parallel to per_region); empty
    # unless the runtime ran with a FaultSpec
    recovery: list[RecoveryStats] = dataclasses.field(default_factory=list)

    @functools.cached_property
    def aggregate(self) -> RunStats:
        """All streams' frames as one RunStats (single source for the frame-
        level statistics; fleet-level extras like utilization live here)."""
        return RunStats(self.all_frames)

    @functools.cached_property
    def all_frames(self) -> list[FrameResult]:
        return [f for st in self.per_stream for f in st.frames]

    @property
    def violation_ratio(self) -> float:
        return self.aggregate.violation_ratio

    @property
    def p50_latency_s(self) -> float:
        return self.aggregate.p50_latency_s

    @property
    def p99_latency_s(self) -> float:
        return self.aggregate.p99_latency_s

    @property
    def avg_latency_s(self) -> float:
        return self.aggregate.avg_latency_s

    @property
    def avg_queue_s(self) -> float:
        return self.aggregate.avg_queue_s

    @property
    def avg_accuracy(self) -> float:
        """Mean accuracy over all completed frames — per-tier capture-quality
        multipliers (``workload.DeviceTier.accuracy_scale``) land here."""
        return self.aggregate.avg_accuracy

    @property
    def capacity_seconds(self) -> float:
        """Integral of the executor count over the horizon — the provisioning
        cost side of the SLA-vs-capacity frontier. Static runs degenerate to
        ``capacity * horizon_s``."""
        if self.horizon_s <= 0:
            return 0.0
        tl = self.capacity_timeline or [(0.0, self.capacity)]
        total = 0.0
        for (t0, c), (t1, _) in zip(tl, tl[1:] + [(self.horizon_s, 0)]):
            t1 = min(t1, self.horizon_s)
            if t1 > t0:
                total += c * (t1 - t0)
        return total

    @property
    def cloud_utilization(self) -> float:
        cap_s = self.capacity_seconds
        if cap_s <= 0:
            return 0.0
        return min(1.0, self.cloud_busy_s / cap_s)

    @property
    def peak_capacity(self) -> int:
        tl = self.capacity_timeline or [(0.0, self.capacity)]
        return max(c for _, c in tl)

    @property
    def final_capacity(self) -> int:
        tl = self.capacity_timeline or [(0.0, self.capacity)]
        return tl[-1][1]

    @property
    def total_dropped(self) -> int:
        return sum(self.dropped_per_stream)

    @property
    def drop_ratio(self) -> float:
        """Dropped arrivals / offered arrivals (offered = completed + dropped).
        Closed-loop fleets never drop, so this is 0.0 there."""
        offered = len(self.all_frames) + self.total_dropped
        return self.total_dropped / offered if offered else 0.0

    @property
    def avg_batch_size(self) -> float:
        return float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0

    @functools.cached_property
    def per_class(self) -> dict[str, ClassStats]:
        """Per-SLA-class violation/drop ratios and latency percentiles, keyed
        by class name in first-appearance order. Every class named by a
        stream appears, even with zero completed frames."""
        classes = self.stream_classes or \
            [sla_lib.DEFAULT_CLASS] * len(self.per_stream)
        out: dict[str, ClassStats] = {}
        dropped = self.dropped_per_stream or [0] * len(self.per_stream)
        by_cls_frames: dict[str, list[FrameResult]] = {}
        by_cls_dropped: dict[str, int] = {}
        for cls, st, dr in zip(classes, self.per_stream, dropped):
            by_cls_frames.setdefault(cls, []).extend(st.frames)
            by_cls_dropped[cls] = by_cls_dropped.get(cls, 0) + dr
        for cls in classes:
            if cls not in out:
                out[cls] = ClassStats(cls, RunStats(by_cls_frames[cls]),
                                      by_cls_dropped[cls])
        return out

    def class_violation_ratio(self, name: str) -> float:
        """Violation ratio of one class; 0.0 when the class served nothing
        (or is absent entirely)."""
        cs = self.per_class.get(name)
        return cs.violation_ratio if cs is not None else 0.0

    @property
    def aggregate_fps(self) -> float:
        return len(self.all_frames) / self.horizon_s if self.horizon_s > 0 else 0.0

    @property
    def total_spilled(self) -> int:
        return sum(r.spilled_out for r in self.per_region)

    @property
    def spill_ratio(self) -> float:
        """Fleet-wide spillover: cloud-bound frames served away from their
        home region / all cloud-bound frames. 0.0 for single-region fleets."""
        offered = sum(r.offered for r in self.per_region)
        return self.total_spilled / offered if offered else 0.0

    # -- failure/recovery aggregates (0 / 0.0 without a FaultSpec) -----------
    @property
    def total_degraded(self) -> int:
        return sum(r.degraded for r in self.recovery)

    @property
    def total_retries(self) -> int:
        return sum(r.retries for r in self.recovery)

    @property
    def total_lost_offers(self) -> int:
        return sum(r.lost_offers for r in self.recovery)

    @property
    def unaccounted_frames(self) -> int:
        """Frame-conservation residual: every cloud-bound offer must end up
        either served by some cell or degraded to device-only. Anything else
        is a simulator bug — the chaos gate pins this to exactly 0."""
        offered = sum(r.offered for r in self.per_region)
        served = sum(r.served for r in self.per_region)
        return offered - served - self.total_degraded

    @property
    def mean_time_to_recover_s(self) -> float:
        times = [t for r in self.recovery for t in r.recovery_times_s]
        return sum(times) / len(times) if times else 0.0

    @property
    def violation_ratio_during_outage(self) -> float:
        frames = sum(r.frames_during_outage for r in self.recovery)
        viol = sum(r.violations_during_outage for r in self.recovery)
        return viol / frames if frames else 0.0

    @property
    def violation_ratio_steady(self) -> float:
        frames = sum(r.frames_steady for r in self.recovery)
        viol = sum(r.violations_steady for r in self.recovery)
        return viol / frames if frames else 0.0


@dataclasses.dataclass
class _CloudItem:
    stream: int
    frame: int
    step: FrameStep
    t0: float          # frame start (latency is measured from here)
    ready_s: float     # device+comm done; enters the shared tier here


class FleetRuntime:
    """Drives N streams through one shared cloud tier (see module docstring)."""

    def __init__(self, profile: ModelProfile, base_cfg: EngineConfig,
                 streams: list[StreamSpec],
                 cloud: CloudTierConfig | None = None,
                 acc_model: AccuracyModel | None = None,
                 model_cfg=None, params=None,
                 autoscaler: Autoscaler | AutoscaleConfig | None = None,
                 sla_classes: dict[str, sla_lib.SlaClass] | None = None,
                 priority: bool | None = None,
                 regions: list[RegionSpec] | None = None,
                 spill_slack_s: float = 0.025,
                 faults: FaultSpec | None = None,
                 bucketing: BucketingConfig | BucketTable | None = None,
                 mesh_rules=None, device=None):
        if mesh_rules is not None:
            raise NotImplementedError(
                "mesh_rules: mesh-sharded execution is not ported yet "
                "(ROADMAP.md queue 1 item 10, sharding)")
        self.streams = streams
        self.cloud = cloud or default_cloud_config(len(streams))
        if isinstance(autoscaler, AutoscaleConfig):
            autoscaler = Autoscaler(autoscaler)
        self.autoscaler = autoscaler
        if spill_slack_s < 0:
            raise ValueError(f"spill_slack_s must be >= 0, got {spill_slack_s}")
        self.spill_slack_s = spill_slack_s
        if regions:
            if len(regions) == 1:
                # fold an explicit single region back into the classic shared
                # tier so every code path (run / run_reference / reports)
                # agrees on capacity and autoscale policy
                r0 = regions[0]
                self.cloud = dataclasses.replace(self.cloud,
                                                 capacity=r0.capacity)
                if r0.autoscale is not None:
                    self.autoscaler = Autoscaler(r0.autoscale)
            self.regions = list(regions)
        else:
            self.regions = [RegionSpec(
                name="cloud", capacity=self.cloud.capacity,
                autoscale=self.autoscaler.cfg if self.autoscaler else None)]
        for s in streams:
            if not 0 <= s.region < len(self.regions):
                raise ValueError(
                    f"stream region {s.region} out of range for "
                    f"{len(self.regions)} region(s)")
        # an episode-free FaultSpec is the null fault model: keep the
        # simulator on the exact faults=∅ code path (bit-exactness contract)
        self.faults = faults if (faults is not None and faults.episodes) \
            else None
        if self.faults is not None:
            for ep in self.faults.episodes:
                if ep.kind in ("region_outage", "executor_crash") and \
                        ep.region >= len(self.regions):
                    raise ValueError(
                        f"fault episode region {ep.region} out of range for "
                        f"{len(self.regions)} region(s)")
                if ep.kind == "blackout" and ep.stream >= len(streams):
                    raise ValueError(
                        f"blackout stream {ep.stream} out of range for "
                        f"{len(streams)} stream(s)")
        self.sla_classes = dict(sla_classes) if sla_classes is not None \
            else dict(sla_lib.DEFAULT_SLA_CLASSES)
        # priority admission: explicit, or auto (on iff any stream deviates
        # from the default class — an all-default fleet keeps the FIFO
        # micro-batcher and therefore today's behavior, event for event)
        self.priority = priority if priority is not None else \
            any(s.sla_class != sla_lib.DEFAULT_CLASS for s in streams)
        acc = acc_model or AccuracyModel()
        self.model_cfg = model_cfg
        self.params = params
        # one plan cache for the whole fleet: streams share the model, so
        # same-geometry partition callables are built once fleet-wide
        self.plan_cache = CompiledPlanCache()
        # per-stream scheduler state: a dedicated engine (shared model/plan
        # cache; profile per device tier, planner tables value-shared per
        # tier) so per-stream SLAs and hardware drive per-stream decisions
        # without re-deriving any model-dependent state. The stream's SLA
        # budget is its (override or fleet) SLA scaled by its class's
        # sla_multiplier — 1.0 for the default class, so plain fleets see
        # exactly the configured SLA.
        self.engines = [
            JanusEngine(s.profile if s.profile is not None else profile,
                        dataclasses.replace(
                            base_cfg,
                            sla_s=(base_cfg.sla_s if s.sla_s is None
                                   else s.sla_s)
                            * sla_lib.resolve_sla_class(
                                s.sla_class, self.sla_classes).sla_multiplier,
                            accuracy_scale=base_cfg.accuracy_scale
                            * s.accuracy_scale),
                        acc_model=acc, model_cfg=model_cfg, params=params,
                        plan_cache=self.plan_cache, device=device)
            for s in streams
        ]
        self._execute = base_cfg.execute and params is not None
        # token-count bucketing (core.bucketing): mixed-α cloud partitions at
        # a shared split pad up to bucket edges and share compiled geometries.
        # None (the default) keeps the exact-geometry batching path.
        self.buckets: BucketTable | None = None
        if bucketing is not None and self._execute:
            if isinstance(bucketing, BucketTable):
                self.buckets = bucketing
            else:
                alphas = sorted({float(a) for e in self.engines
                                 for a in e.tables.alpha_grid})
                self.buckets = BucketTable.build(
                    model_cfg, alphas, kind=profile.schedule_kind,
                    config=bucketing)

    def run(self, images=None, telemetry=None) -> FleetStats:
        """Run the fleet on the event-heap simulator core
        (``repro_torch.serving.simcore``): identical semantics to the retired
        per-frame loop (kept below as ``run_reference``), with planner
        decisions batched per (tier, profile) group so simulation cost
        scales with events, not frames x Python overhead. ``telemetry``
        takes an optional ``telemetry.Telemetry`` recorder (span traces,
        windowed metrics, decision logs); ``None`` — the default — runs
        the instrumentation-free hot path, bit-exact with pre-telemetry
        builds."""
        from repro_torch.serving import simcore
        return simcore.simulate(self, images=images, telemetry=telemetry)

    def run_reference(self, images=None) -> FleetStats:
        """The retired per-frame event loop, kept verbatim as the parity
        oracle: ``tests/test_simcore.py`` asserts ``run()`` reproduces this
        loop's ``FleetStats`` bit for bit on the seed scenarios. One
        ``plan_frame`` Python call per frame — do not use at scale."""
        if len(self.regions) > 1:
            raise ValueError(
                "run_reference models the classic single shared tier; "
                f"multi-region fleets ({len(self.regions)} regions) run on "
                "the event-heap core (run())")
        if self.faults is not None:
            raise ValueError(
                "run_reference has no failure model; fault-injected fleets "
                "run on the event-heap core (run())")
        streams, cloud = self.streams, self.cloud
        estimators = [HarmonicMeanEstimator(cold_start_bps=float(np.mean(s.trace.bps)))
                      for s in streams]
        results: list[list[FrameResult]] = [[] for _ in streams]
        batch_sizes: list[int] = []
        dropped = [0] * len(streams)
        inflight = [0] * len(streams)
        device_free = [0.0] * len(streams)  # per-client device busy-until
        # admission discipline: FIFO for all-default-class fleets (the classic
        # runtime, preserved event for event), class-priority otherwise
        if self.priority:
            # note: this runtime executes a dispatched micro-batch as ONE
            # stacked forward (every member completes together), so the
            # batcher's intra-batch admission *order* is timing-neutral
            # here — the fleet-level win comes from the per-class deadline
            # windows moving the flush itself. The order is the batcher's
            # contract for sequential consumers.
            micro = PriorityMicroBatcher(cloud.max_batch, cloud.max_wait_s,
                                         classes=self.sla_classes)
        else:
            micro = MicroBatcher(cloud.max_batch, cloud.max_wait_s)
        executors: list[float] = []   # busy-until heap, capped at `capacity`
        items: dict[int, _CloudItem] = {}
        rid = itertools.count()
        seq = itertools.count()       # FIFO tie-break for simultaneous events
        events: list = []             # (time, seq, callback)
        # fresh controller per run: cooldown state must not leak between
        # repeated run() calls on one runtime
        scaler = Autoscaler(self.autoscaler.cfg) if self.autoscaler else None
        capacity0 = scaler.initial_capacity(cloud.capacity) if scaler \
            else cloud.capacity
        # outstanding (start, end) cloud service intervals, consumed by the
        # autoscale control loop (billed by window overlap, not lump-summed
        # at dispatch — a service longer than the control window must keep
        # later windows looking busy)
        service_intervals: list[tuple[float, float]] = []
        state = {"busy": 0.0, "horizon": 0.0, "capacity": capacity0,
                 # cloud-bound offers this control window (predictive policy's
                 # arrival-rate signal; reset every control tick)
                 "cloud_arrivals": 0,
                 # arrivals still owed a verdict (finish or drop): the
                 # autoscale control timer keeps itself alive only while > 0
                 "remaining": sum(
                     s.n_frames if s.arrival_times is None
                     else min(s.n_frames, len(s.arrival_times))
                     for s in streams)}
        cap_timeline: list[tuple[float, int]] = [(0.0, capacity0)]

        def push(t: float, fn) -> None:
            heapq.heappush(events, (t, next(seq), fn))

        def arrive(si: int, fi: int, t0: float) -> None:
            spec = streams[si]
            if spec.max_inflight and inflight[si] >= spec.max_inflight:
                dropped[si] += 1           # admission control: overload drops
                state["remaining"] -= 1
                return
            inflight[si] += 1
            start_frame(si, fi, t0)

        def start_frame(si: int, fi: int, t0: float) -> None:
            eng, spec = self.engines[si], streams[si]
            step = eng.plan_frame(fi, spec.trace, spec.policy, estimators[si],
                                  images=images, defer_cloud=True)
            estimators[si].observe(step.bandwidth_bps)
            bd = step.breakdown
            # one device per client: overlapping open-loop frames serialize
            # their scheduler+device phase on the stream's own hardware (the
            # radio pipelines, so comm overlaps the next frame's compute).
            # Closed loop never has two frames in flight, so this never binds
            # there and the N=1 engine identity is untouched.
            dev_start = max(t0, device_free[si])
            device_free[si] = dev_start + eng.overhead_s(step) + bd.device_s
            local_done = device_free[si] + bd.comm_s
            if bd.cloud_s <= 0.0:  # device-only split: never touches the cloud
                push(local_done, lambda t: finish_frame(si, fi, step, t0, t))
            else:
                item = _CloudItem(si, fi, step, t0, local_done)
                push(local_done, lambda t, item=item: offer_item(item, t))

        def offer_item(item: _CloudItem, now: float) -> None:
            r = next(rid)
            items[r] = item
            state["cloud_arrivals"] += 1
            spec = streams[item.stream]
            req = Request(r, arrival_s=now, sla_class=spec.sla_class,
                          deadline_s=item.t0
                          + self.engines[item.stream].cfg.sla_s)
            batch = micro.offer(req, now)
            if batch is not None:
                dispatch(batch, now)
            elif self.priority:
                # class windows move the flush deadline *earlier* when an
                # urgent frame joins, so re-arm after every offer; a timer
                # that fires past a flush is a no-op poll
                push(max(micro.deadline(), now), poll_micro)
            elif len(micro.pending) == 1:
                # FIFO: the batch just became non-empty: one expiry timer
                # covers it (the deadline is keyed to pending[0] and never
                # moves, so later joiners would only add redundant events)
                push(micro.deadline(), poll_micro)

        def poll_micro(now: float) -> None:
            batch = micro.poll(now)
            if batch is not None:
                dispatch(batch, now)

        def dispatch(batch: list[Request], now: float) -> None:
            members = [items.pop(r.rid) for r in batch]
            if self._execute:
                # run the real cloud partitions for the whole micro-batch:
                # same-geometry frames execute as one stacked forward instead
                # of B serial ones (the partition fn is cached per geometry)
                run_cloud_batch(self.plan_cache, self.model_cfg, self.params,
                                [m.step.exec_plan for m in members],
                                buckets=self.buckets)
            service = max(m.step.breakdown.cloud_s for m in members) \
                * (1.0 + cloud.batch_growth * (len(batch) - 1))
            # retire executor slots freed past a capacity shrink (lazy: slots
            # mid-service when the scaler shrank drain first)
            while len(executors) > state["capacity"] and executors[0] <= now:
                heapq.heappop(executors)
            if len(executors) < state["capacity"]:
                start = now
            else:  # all executors busy (or recently so): wait for earliest-free
                start = max(now, heapq.heappop(executors))
            heapq.heappush(executors, start + service)
            state["busy"] += service
            if scaler is not None:
                if scaler.cfg.policy != "predictive":
                    # windowed-utilization bookkeeping; the predictive branch
                    # reads the executor heap instead, so appending here
                    # would only accumulate unread tuples for the whole run
                    service_intervals.append((start, start + service))
                scaler.observe_service(service / len(batch))
            batch_sizes.append(len(batch))
            done = start + service
            for m in members:
                push(done, lambda t, m=m: finish_frame(m.stream, m.frame,
                                                       m.step, m.t0, t))

        def finish_frame(si: int, fi: int, step: FrameStep, t0: float,
                         tf: float) -> None:
            eng, spec = self.engines[si], streams[si]
            standalone = step.breakdown.total_s + eng.overhead_s(step)
            queue_s = tf - t0 - standalone
            if queue_s < 1e-12:  # float residue from event-time arithmetic
                queue_s = 0.0
            results[si].append(eng.frame_result(step, queue_s=queue_s))
            state["horizon"] = max(state["horizon"], tf)
            state["remaining"] -= 1
            inflight[si] -= 1
            if spec.arrival_times is None and fi + 1 < spec.n_frames:
                # closed loop: the next frame arrives when this one is done
                arrive(si, fi + 1, max(tf, t0 + spec.period_s))

        def set_capacity(newc: int, now: float) -> None:
            if newc == state["capacity"]:
                return
            while len(executors) > newc and executors[0] <= now:
                heapq.heappop(executors)  # retire free slots immediately
            state["capacity"] = newc
            cap_timeline.append((now, newc))

        def control(now: float) -> None:
            window = scaler.cfg.interval_s
            if scaler.cfg.policy == "predictive":
                # feed-forward: EWMA arrival-rate forecast + current backlog
                # (service seconds still queued or running on the executors
                # plus frames parked in the micro-batcher)
                scaler.observe_rate(state["cloud_arrivals"], window)
                state["cloud_arrivals"] = 0
                backlog = sum(max(0.0, e - now) for e in executors)
                backlog += len(micro.pending) * (scaler.ewma_service_s or 0.0)
                newc = scaler.decide_predictive(now, backlog,
                                                state["capacity"])
            else:  # reactive: windowed utilization of the current capacity
                w0, busy, keep = now - window, 0.0, []
                for s, e in service_intervals:
                    busy += max(0.0, min(e, now) - max(s, w0))
                    if e > now:  # still busy (or queued): next window too
                        keep.append((s, e))
                service_intervals[:] = keep
                util = busy / (state["capacity"] * window)
                newc = scaler.decide(now, util, state["capacity"])
            set_capacity(newc, now)
            if state["remaining"] > 0:
                push(now + window, control)

        for si, spec in enumerate(streams):
            if spec.arrival_times is None:
                arrive(si, 0, 0.0)
            else:  # open loop: every arrival is scheduled up front
                for fi, ta in enumerate(spec.arrival_times[:spec.n_frames]):
                    push(float(ta), lambda t, si=si, fi=fi: arrive(si, fi, t))
        if scaler is not None:
            push(scaler.cfg.interval_s, control)
        while True:
            while events:
                t, _, fn = heapq.heappop(events)
                fn(t)
            if not micro.pending:  # defensive: a poll timer covers every batch
                break
            dispatch(micro.flush(), state["horizon"])

        r0 = self.regions[0]
        region_stats = RegionStats(
            name=r0.name, rtt_offset_s=r0.rtt_offset_s, capacity=capacity0,
            busy_s=state["busy"], horizon_s=state["horizon"],
            capacity_timeline=list(cap_timeline),
            offered=sum(batch_sizes), spilled_out=0,
            served=sum(batch_sizes), batches=len(batch_sizes))
        return FleetStats(per_stream=[RunStats(fr) for fr in results],
                          cloud_busy_s=state["busy"],
                          horizon_s=state["horizon"],
                          capacity=capacity0,
                          batch_sizes=batch_sizes,
                          dropped_per_stream=dropped,
                          capacity_timeline=cap_timeline,
                          stream_classes=[s.sla_class for s in streams],
                          per_region=[region_stats],
                          stream_regions=[s.region for s in streams])
