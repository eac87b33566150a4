"""Declarative workload scenarios for the fleet runtime (the layer between
"streams" and "runtime"). PyTorch port of ``repro.serving.workload``: a numpy
copy, building the port's ``FleetRuntime``.

The fleet runtime (``repro_torch.serving.fleet``) exposes mechanism: closed- or
open-loop frame arrivals with admission control, per-stream device profiles,
per-stream network traces, and a dynamically scaled cloud tier. This module is
the *policy* layer that composes those into a scenario:

  * **arrival processes** — ``ArrivalConfig`` describes how frames arrive per
    stream: ``closed`` (next frame after the previous completes, today's
    behavior), ``poisson`` (open-loop exponential inter-arrivals at
    ``rate_fps``), or ``mmpp`` (a 2-state Markov-modulated Poisson process:
    calm ``rate_fps`` / burst ``burst_rate_fps``). Open-loop arrivals pair
    with ``max_inflight`` admission control so overload produces a reported
    drop ratio instead of unbounded queueing.
  * **device tiers** — named hardware classes (``phone`` / ``jetson`` /
    ``laptop``) scale the fitted ``ModelProfile``'s device-side latencies, so
    each stream's scheduler plans against its own hardware. Tier profiles are
    LRU-cached per (base profile, tier) — and because ``planner.tables_for``
    caches by profile *value*, planner tables are shared per tier, not
    rebuilt per stream.
  * **network sources** — synthetic Markov traces (per-stream spawned seeds),
    one CSV replayed by every stream, or a directory of CSVs assigned
    round-robin (``NetworkTrace.from_csv``).
  * **cloud autoscaling** — ``fleet.AutoscaleConfig``, forwarded to the
    runtime's utilization-driven controller.
  * **cloud regions** — ``RegionConfig`` splits the shared tier into R
    regional cells (per-region capacity, autoscaler, and an RTT offset in ms
    on top of each homed stream's trace RTT). Streams are homed round-robin
    (stream i → region i % R), the home offset is *baked into the stream's
    trace* so the planner prices the distance in the engine's exact float
    order, and ``spill_slack_ms`` sets the queue-delay threshold past which
    a frame spills to another cell (paying the RTT difference).

``WorkloadSpec`` is JSON-loadable (``--workload spec.json`` in
``repro_torch.launch.serve``); ``build_runtime`` turns a spec plus a fitted profile
into a ready ``FleetRuntime``. Per-stream randomness (traces and arrivals) is
derived by spawning ``np.random.SeedSequence`` children off the spec's base
seed, so stream i's trace/arrivals are reproducible and distinct regardless
of how many streams run beside it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core import bandwidth, planner
from repro_torch.core.bandwidth import NetworkTrace
from repro_torch.core.engine import EngineConfig
from repro_torch.core.scheduler import ModelProfile
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import fleet
from repro_torch.serving import sla as sla_lib


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

ARRIVAL_KINDS = ("closed", "poisson", "mmpp", "diurnal", "trace")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """How frames arrive on one stream.

    ``closed`` is the classic closed loop (``period_s`` = min spacing). The
    open-loop kinds generate absolute arrival times up front:

      * ``poisson`` — exponential inter-arrivals at ``rate_fps``;
      * ``mmpp`` — 2-state Markov-modulated Poisson: switches between a calm
        state (``rate_fps``) and a burst state (``burst_rate_fps``) after
        each arrival with probabilities ``p_burst`` / ``p_calm``;
      * ``diurnal`` — non-homogeneous Poisson whose rate follows a sinusoidal
        day cycle, ``rate_fps * (1 + diurnal_amplitude *
        sin(2*pi*(t + diurnal_phase_s)/diurnal_period_s))``, sampled by
        thinning — the compressed-time analogue of a day/night load curve;
      * ``trace`` — non-homogeneous Poisson over a piecewise-constant rate
        schedule ``rate_schedule = ((t_start, fps), ...)`` (t_start ascending,
        first entry at 0.0; each rate holds until the next entry) — replay of
        a measured arrival-rate timeline.

    ``max_inflight`` is the per-stream admission bound (0 = unbounded;
    ignored for closed loop, which never exceeds one in flight).
    """
    kind: str = "closed"
    rate_fps: float = 10.0
    burst_rate_fps: float = 40.0
    p_burst: float = 0.05
    p_calm: float = 0.30
    period_s: float = 0.0
    max_inflight: int = 0
    diurnal_period_s: float = 60.0
    diurnal_amplitude: float = 0.8
    diurnal_phase_s: float = 0.0
    rate_schedule: tuple[tuple[float, float], ...] = ()

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"arrival kind must be one of {ARRIVAL_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind not in ("closed", "trace") and self.rate_fps <= 0:
            raise ValueError(f"rate_fps must be > 0, got {self.rate_fps}")
        if self.kind == "mmpp" and self.burst_rate_fps <= 0:
            raise ValueError(
                f"burst_rate_fps must be > 0, got {self.burst_rate_fps}")
        for pname, p in (("p_burst", self.p_burst), ("p_calm", self.p_calm)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{pname} must be in [0, 1], got {p}")
        if self.max_inflight < 0:
            raise ValueError(
                f"max_inflight must be >= 0, got {self.max_inflight}")
        if self.kind == "diurnal":
            if self.diurnal_period_s <= 0:
                raise ValueError(f"diurnal_period_s must be > 0, "
                                 f"got {self.diurnal_period_s}")
            if not 0.0 <= self.diurnal_amplitude <= 1.0:
                raise ValueError(f"diurnal_amplitude must be in [0, 1], "
                                 f"got {self.diurnal_amplitude}")
        if self.kind == "trace":
            sched = self.rate_schedule
            if not sched:
                raise ValueError("arrival kind 'trace' needs a rate_schedule")
            times = [t for t, _ in sched]
            if times[0] != 0.0:
                raise ValueError("rate_schedule must start at t=0, "
                                 f"got {times[0]}")
            if any(b <= a for a, b in zip(times, times[1:])):
                raise ValueError("rate_schedule times must be ascending")
            if any(r < 0 for _, r in sched):
                raise ValueError("rate_schedule rates must be >= 0")
            if sched[-1][1] <= 0:
                raise ValueError("rate_schedule must end on a rate > 0 (the "
                                 "final rate holds forever; a 0 tail would "
                                 "never produce the remaining arrivals)")

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate at time ``t`` (diurnal/trace kinds)."""
        if self.kind == "diurnal":
            return self.rate_fps * (1.0 + self.diurnal_amplitude * float(
                np.sin(2.0 * np.pi * (t + self.diurnal_phase_s)
                       / self.diurnal_period_s)))
        if self.kind == "trace":
            rate = self.rate_schedule[0][1]
            for t0, r in self.rate_schedule:
                if t0 > t:
                    break
                rate = r
            return rate
        return self.rate_fps

    def peak_rate(self) -> float:
        """Upper bound on ``rate_at`` (the thinning envelope)."""
        if self.kind == "diurnal":
            return self.rate_fps * (1.0 + self.diurnal_amplitude)
        if self.kind == "trace":
            return max(r for _, r in self.rate_schedule)
        return self.rate_fps


def _thinned_arrivals(cfg: ArrivalConfig, n_frames: int,
                      rng: np.random.Generator) -> tuple[float, ...]:
    """Non-homogeneous Poisson arrivals by thinning (Lewis & Shedler):
    candidate points at the peak rate, accepted with probability
    ``rate(t) / peak``."""
    lam_max = cfg.peak_rate()
    out, t = [], 0.0
    while len(out) < n_frames:
        t += float(rng.exponential(1.0 / lam_max))
        if rng.random() * lam_max < cfg.rate_at(t):
            out.append(t)
    return tuple(out)


def arrival_times(cfg: ArrivalConfig, n_frames: int,
                  rng: np.random.Generator) -> tuple[float, ...] | None:
    """Absolute arrival times for one open-loop stream (None = closed loop)."""
    if cfg.kind == "closed":
        return None
    if cfg.kind == "poisson":
        return tuple(np.cumsum(rng.exponential(1.0 / cfg.rate_fps, n_frames)))
    if cfg.kind in ("diurnal", "trace"):
        return _thinned_arrivals(cfg, n_frames, rng)
    # mmpp: per-arrival state switch, exponential gap at the state's rate
    out, t, burst = [], 0.0, False
    for _ in range(n_frames):
        rate = cfg.burst_rate_fps if burst else cfg.rate_fps
        t += float(rng.exponential(1.0 / rate))
        out.append(t)
        u = rng.random()
        if not burst and u < cfg.p_burst:
            burst = True
        elif burst and u < cfg.p_calm:
            burst = False
    return tuple(out)


# ---------------------------------------------------------------------------
# device tiers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    """A named hardware class: multiplies the fitted profile's device-side
    latencies (per-layer linear model + embed), and — independently — the
    accuracy term (``accuracy_scale``): a phone-class camera degrades what
    the model can recognize, not just how fast the device computes. The
    latency side flows through ``tier_profile`` into the stream's planner
    tables; the accuracy side flows through ``StreamSpec.accuracy_scale``
    into ``EngineConfig.accuracy_scale`` and lands in every
    ``FrameResult.accuracy`` (so ``FleetStats.avg_accuracy`` reports the
    fleet's capture-quality mix). ``jetson`` is the calibration baseline
    (the profile is fitted against a Jetson-class edge platform)."""
    name: str
    compute_scale: float = 1.0
    accuracy_scale: float = 1.0

    def __post_init__(self):
        if self.compute_scale <= 0:
            raise ValueError(
                f"compute_scale must be > 0, got {self.compute_scale}")
        if not 0.0 < self.accuracy_scale <= 1.0:
            raise ValueError(
                f"accuracy_scale must be in (0, 1], got {self.accuracy_scale}")


DEVICE_TIERS = {
    "uniform": DeviceTier("uniform", 1.0),   # alias: the fleet-wide profile
    "jetson": DeviceTier("jetson", 1.0),
    # phone-class optics/sensor: ~3% relative accuracy degradation on top of
    # the 4x slower device compute
    "phone": DeviceTier("phone", 4.0, accuracy_scale=0.97),
    "laptop": DeviceTier("laptop", 0.45),
}

_TIER_CACHE: OrderedDict[tuple, ModelProfile] = OrderedDict()
_TIER_CACHE_MAX = 64


def resolve_tier(tier: str | DeviceTier) -> DeviceTier:
    if isinstance(tier, DeviceTier):
        return tier
    try:
        return DEVICE_TIERS[tier]
    except KeyError:
        raise ValueError(f"unknown device tier {tier!r}; known: "
                         f"{sorted(DEVICE_TIERS)}") from None


def tier_profile(base: ModelProfile, tier: str | DeviceTier) -> ModelProfile:
    """The base profile with device-side latencies scaled for ``tier``.

    LRU-cached by (base profile value, tier), so N same-tier streams share
    one ModelProfile object — and therefore (via ``planner.tables_for``'s
    value cache) one PlannerTables instance per tier, not per stream.
    """
    tier = resolve_tier(tier)
    if tier.compute_scale == 1.0:
        return base
    key = (planner._profile_signature(base), tier.name, tier.compute_scale)
    hit = _TIER_CACHE.get(key)
    if hit is not None:
        _TIER_CACHE.move_to_end(key)
        return hit
    s = tier.compute_scale
    # LatencyModel.scaled keeps this model-agnostic: a LinearProfiler scales
    # (a, b) — bit-identical to the old inline construction — and a
    # StepProfiler scales its plateau levels
    prof = dataclasses.replace(
        base,
        device=base.device.scaled(s),
        device_embed_s=base.device_embed_s * s)
    _TIER_CACHE[key] = prof
    while len(_TIER_CACHE) > _TIER_CACHE_MAX:
        _TIER_CACHE.popitem(last=False)
    return prof


# ---------------------------------------------------------------------------
# network sources
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Where each stream's network trace comes from: ``synthetic`` (seeded
    Markov generator, one distinct trace per stream) or ``csv`` (``path`` is
    one CSV replayed by every stream, or a directory of CSVs assigned
    round-robin)."""
    kind: str = "synthetic"
    network: str = "4g"
    mobility: str = "driving"
    path: str | None = None
    rtt_ms: float = 42.2

    def __post_init__(self):
        if self.kind not in ("synthetic", "csv"):
            raise ValueError(f"network kind must be 'synthetic' or 'csv', "
                             f"got {self.kind!r}")
        if self.kind == "csv" and not self.path:
            raise ValueError("network kind 'csv' requires a path")


def csv_traces(path: str, rtt_s: float) -> list[NetworkTrace]:
    """Trace(s) from a CSV file or a directory of ``*.csv`` (sorted)."""
    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.csv"))
        if not files:
            raise ValueError(f"no *.csv traces in {path}")
        return [NetworkTrace.from_csv(str(f), rtt_s) for f in files]
    return [NetworkTrace.from_csv(str(p), rtt_s)]


def build_traces(cfg: NetworkConfig, n_streams: int, steps: int,
                 trace_seeds: Sequence[int]) -> list[NetworkTrace]:
    if cfg.kind == "synthetic":
        return [bandwidth.synthetic_trace(cfg.network, cfg.mobility,
                                          steps=steps, seed=trace_seeds[i])
                for i in range(n_streams)]
    pool = csv_traces(cfg.path, cfg.rtt_ms / 1e3)
    return [pool[i % len(pool)] for i in range(n_streams)]


# ---------------------------------------------------------------------------
# cloud regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """One regional cloud cell, JSON-facing (``"regions"`` in the workload
    spec). ``capacity=None`` takes an even share of the fleet's default
    total (``ceil(default_capacity / R)``), so adding regions redistributes
    rather than multiplies the provisioned pool. ``rtt_ms`` is the extra
    round-trip to this cell on top of a stream's trace RTT — streams homed
    here pay it on every cloud-bound frame (baked into their trace), and
    frames spilling *into* this cell pay the difference vs. their home."""
    name: str = "cloud"
    capacity: int | None = None
    rtt_ms: float = 0.0
    autoscale: fleet.AutoscaleConfig | None = None

    def __post_init__(self):
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(
                f"region capacity must be >= 1 or None, got {self.capacity}")
        if self.rtt_ms < 0:
            raise ValueError(f"region rtt_ms must be >= 0, got {self.rtt_ms}")


# ---------------------------------------------------------------------------
# per-stream randomness
# ---------------------------------------------------------------------------


def stream_seed_sequences(base_seed: int,
                          n_streams: int) -> list[np.random.SeedSequence]:
    """Independent per-stream seed sequences spawned off one base seed.
    Child i is a function of (base_seed, i) only, so stream i's randomness
    does not change when the fleet grows or shrinks."""
    return np.random.SeedSequence(base_seed).spawn(n_streams)


def stream_seeds(base_seed: int, n_streams: int) -> list[int]:
    """Per-stream integer seeds (for APIs that take an int, e.g.
    ``synthetic_trace``), derived from the spawned sequences."""
    return [int(ss.generate_state(1)[0])
            for ss in stream_seed_sequences(base_seed, n_streams)]


# ---------------------------------------------------------------------------
# the scenario spec
# ---------------------------------------------------------------------------


def _from_dict(cls, d: dict, what: str):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown {what} keys {sorted(unknown)}; "
                         f"known: {sorted(fields)}")
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One serving scenario, JSON-loadable. Defaults reproduce the classic
    fleet: closed loop, one uniform tier, one (standard) SLA class,
    synthetic traces, static cloud. See ``docs/workload_spec.md`` for the
    JSON schema."""
    n_streams: int = 4
    n_frames: int = 30
    policy: str = "janus"
    sla_ms: float | None = None          # None = the base engine config's SLA
    seed: int = 0
    arrivals: ArrivalConfig = dataclasses.field(default_factory=ArrivalConfig)
    tiers: tuple[str, ...] = ("uniform",)  # assigned round-robin to streams
    # SLA classes assigned round-robin to streams (repro_torch.serving.sla); any
    # non-default class flips the shared tier to priority admission
    sla_classes: tuple[str, ...] = (sla_lib.DEFAULT_CLASS,)
    # optional per-class overrides / new classes, JSON style:
    # {"gold": {"priority": 0, "sla_multiplier": 0.4, "wait_multiplier": 0.2}}
    sla_class_defs: dict = dataclasses.field(default_factory=dict)
    # force priority admission on/off (None = auto from sla_classes)
    priority: bool | None = None
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    # shared-tier overrides (None = default_cloud_config(n_streams) values)
    capacity: int | None = None
    max_batch: int | None = None
    max_wait_ms: float | None = None
    batch_growth: float | None = None
    autoscale: fleet.AutoscaleConfig | None = None
    # regional cloud cells (empty = the classic single shared tier); streams
    # are homed round-robin, spilling over past spill_slack_ms of queue delay
    regions: tuple[RegionConfig, ...] = ()
    spill_slack_ms: float = 25.0
    # timed fault episodes + recovery policy (None = no failure model);
    # times inside are simulator seconds, like autoscale's interval_s
    faults: faults_lib.FaultSpec | None = None
    name: str = "workload"

    def __post_init__(self):
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {self.n_streams}")
        if self.spill_slack_ms < 0:
            raise ValueError(
                f"spill_slack_ms must be >= 0, got {self.spill_slack_ms}")
        if self.n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {self.n_frames}")
        if not self.tiers:
            raise ValueError("tiers must name at least one device tier")
        for t in self.tiers:
            resolve_tier(t)  # fail fast on unknown tier names
        if not self.sla_classes:
            raise ValueError("sla_classes must name at least one SLA class")
        table = self.resolved_sla_classes()
        for c in self.sla_classes:
            sla_lib.resolve_sla_class(c, table)  # fail fast on unknown names

    def resolved_sla_classes(self) -> dict[str, sla_lib.SlaClass]:
        """The default class registry overlaid with this spec's overrides."""
        return sla_lib.classes_from_dict(self.sla_class_defs)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        d = dict(d)
        if "arrivals" in d:
            a = dict(d["arrivals"])
            if "rate_schedule" in a:
                a["rate_schedule"] = tuple(
                    (float(t), float(r)) for t, r in a["rate_schedule"])
            d["arrivals"] = _from_dict(ArrivalConfig, a, "arrivals")
        if "network" in d:
            d["network"] = _from_dict(NetworkConfig, d["network"], "network")
        if d.get("autoscale") is not None:
            d["autoscale"] = _from_dict(fleet.AutoscaleConfig, d["autoscale"],
                                        "autoscale")
        if "regions" in d:
            regs = []
            for r in d["regions"]:
                r = dict(r)
                if r.get("autoscale") is not None:
                    r["autoscale"] = _from_dict(
                        fleet.AutoscaleConfig, r["autoscale"],
                        "region autoscale")
                regs.append(_from_dict(RegionConfig, r, "region"))
            d["regions"] = tuple(regs)
        if d.get("faults") is not None:
            d["faults"] = faults_lib.FaultSpec.from_dict(d["faults"])
        if "tiers" in d:
            d["tiers"] = tuple(d["tiers"])
        if "sla_classes" in d:
            d["sla_classes"] = tuple(d["sla_classes"])
        return _from_dict(cls, d, "workload")

    @classmethod
    def from_json(cls, path: str) -> "WorkloadSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tiers"] = list(self.tiers)
        d["sla_classes"] = list(self.sla_classes)
        d["arrivals"]["rate_schedule"] = \
            [list(p) for p in self.arrivals.rate_schedule]
        d["regions"] = [dataclasses.asdict(r) for r in self.regions]
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        return d

    # -- assembly -----------------------------------------------------------
    def cloud_config(self) -> fleet.CloudTierConfig:
        base = fleet.default_cloud_config(self.n_streams)
        over = {k: v for k, v in
                (("capacity", self.capacity), ("max_batch", self.max_batch),
                 ("batch_growth", self.batch_growth))
                if v is not None}
        if self.max_wait_ms is not None:
            over["max_wait_s"] = self.max_wait_ms / 1e3
        return dataclasses.replace(base, **over) if over else base

    def resolved_regions(self) -> list[fleet.RegionSpec]:
        """The spec's regions as runtime ``RegionSpec``s (empty = classic
        single tier): ms → s, ``capacity=None`` → even share of the fleet's
        configured total."""
        if not self.regions:
            return []
        total = self.cloud_config().capacity
        share = max(1, -(-total // len(self.regions)))
        return [fleet.RegionSpec(
            name=r.name,
            capacity=r.capacity if r.capacity is not None else share,
            rtt_offset_s=r.rtt_ms / 1e3,
            autoscale=r.autoscale) for r in self.regions]

    def build_streams(self, profile: ModelProfile) -> list[fleet.StreamSpec]:
        """Per-stream specs: spawned-seed traces and arrivals, round-robin
        device tiers applied to the fitted profile, round-robin region
        affinity with the home region's RTT offset baked into the trace."""
        seqs = stream_seed_sequences(self.seed, self.n_streams)
        n_regions = len(self.regions)
        specs = []
        for si, ss in enumerate(seqs):
            trace_ss, arrival_ss = ss.spawn(2)
            tier = resolve_tier(self.tiers[si % len(self.tiers)])
            if self.network.kind == "synthetic":
                trace = bandwidth.synthetic_trace(
                    self.network.network, self.network.mobility,
                    steps=self.n_frames,
                    seed=int(trace_ss.generate_state(1)[0]))
            else:
                trace = None  # filled from the CSV pool below
            prof = tier_profile(profile, tier)
            specs.append(fleet.StreamSpec(
                trace=trace, n_frames=self.n_frames, policy=self.policy,
                sla_s=None if self.sla_ms is None else self.sla_ms / 1e3,
                period_s=self.arrivals.period_s,
                arrival_times=arrival_times(self.arrivals, self.n_frames,
                                            np.random.default_rng(arrival_ss)),
                max_inflight=self.arrivals.max_inflight,
                profile=None if prof is profile else prof,
                tier=tier.name,
                sla_class=self.sla_classes[si % len(self.sla_classes)],
                accuracy_scale=tier.accuracy_scale,
                region=si % n_regions if n_regions else 0))
        if self.network.kind == "csv":
            pool = csv_traces(self.network.path, self.network.rtt_ms / 1e3)
            specs = [dataclasses.replace(s, trace=pool[i % len(pool)])
                     for i, s in enumerate(specs)]
        if n_regions:
            # bake the home region's RTT offset into the trace so every
            # planner/accounting path prices the distance in the engine's
            # exact float order; a 0-offset region keeps the trace object
            # untouched (bit-exact, and CSV pool traces stay shared)
            offsets = [r.rtt_ms / 1e3 for r in self.regions]
            specs = [
                dataclasses.replace(
                    s, trace=dataclasses.replace(
                        s.trace, rtt_s=s.trace.rtt_s + offsets[s.region]))
                if offsets[s.region] else s
                for s in specs]
        return specs


def build_runtime(spec: WorkloadSpec, profile: ModelProfile,
                  base_cfg: EngineConfig, *, acc_model=None,
                  model_cfg=None, params=None, bucketing=None,
                  mesh_rules=None, device=None) -> fleet.FleetRuntime:
    """A ready-to-run FleetRuntime for the scenario on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``). ``bucketing`` / ``mesh_rules``
    configure the real-execution fast path (token-count bucketing and
    mesh-sharded partitions; see docs/execution.md)."""
    return fleet.FleetRuntime(
        profile, base_cfg, spec.build_streams(profile),
        cloud=spec.cloud_config(), acc_model=acc_model,
        model_cfg=model_cfg, params=params,
        autoscaler=spec.autoscale,
        sla_classes=spec.resolved_sla_classes(),
        priority=spec.priority,
        regions=spec.resolved_regions() or None,
        spill_slack_s=spec.spill_slack_ms / 1e3,
        faults=spec.faults,
        bucketing=bucketing, mesh_rules=mesh_rules, device=device)
