"""Fault injection + recovery bookkeeping for the fleet runtime.
Port of ``repro.serving.faults`` (pure Python, copied unchanged).

This module is the declarative half of the failure model: *what* goes wrong
(``FaultSpec`` — timed episodes of region outages, executor crashes, and
per-stream network blackouts) and *how hard we try to recover* (``RetryConfig``
capped exponential backoff, ``BreakerConfig`` per-region circuit breakers).
The procedural half — realizing episodes as events on the simulator heap,
re-planning retries against the live trace, degrading to device-only — lives
in ``repro_torch.serving.simcore``, which drives a ``FaultManager`` instance as pure
mutable state.

Design rules that keep the simulator honest:

* Episodes are injected as heap events, so a run with ``faults=∅`` takes the
  exact same code path (``fm is None`` everywhere) and stays bit-exact with
  the pre-fault simulator — pinned by tests/test_faults.py.
* Routing may consult only *observable* state (the circuit breaker); the
  ground-truth ``down[r]`` flags model physical transport loss at enqueue
  time and are never read by the routing policy. A dark cell is discovered
  the way a real fleet discovers it: by losing requests to it.
* All times are simulator seconds (matching the autoscale convention in
  ``workload.py``, not the millisecond CLI shorthands).
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field

from repro_torch.runtime.fault_tolerance import BreakerConfig, CircuitBreaker

FAULT_KINDS = ("region_outage", "executor_crash", "blackout")


def _from_dict(cls, d: dict, what: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown {what} key(s): {sorted(unknown)}")
    return cls(**d)


@dataclass(frozen=True)
class FaultEpisode:
    """One timed fault. ``region``/``stream`` index into the workload's
    resolved regions / streams; which one applies depends on ``kind``."""
    kind: str
    start_s: float
    duration_s: float = 0.0
    region: int = -1
    stream: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}, "
                             f"expected one of {FAULT_KINDS}")
        if self.start_s < 0.0:
            raise ValueError(f"fault start_s must be >= 0, got {self.start_s}")
        if self.kind in ("region_outage", "blackout") and self.duration_s <= 0.0:
            raise ValueError(f"{self.kind} needs duration_s > 0, "
                             f"got {self.duration_s}")
        if self.kind in ("region_outage", "executor_crash") and self.region < 0:
            raise ValueError(f"{self.kind} needs a region index >= 0")
        if self.kind == "blackout" and self.stream < 0:
            raise ValueError("blackout needs a stream index >= 0")

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s


@dataclass(frozen=True)
class RetryConfig:
    """Capped exponential backoff for lost cloud offers.

    ``max_retries=0`` is the naive no-retry policy: any lost offer degrades
    straight to device-only.
    """
    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.16

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s <= 0.0 or self.backoff_cap_s <= 0.0:
            raise ValueError("backoff base/cap must be > 0")

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** (attempt - 1)))


@dataclass(frozen=True)
class FaultSpec:
    episodes: tuple[FaultEpisode, ...] = ()
    retry: RetryConfig = field(default_factory=RetryConfig)
    breaker: BreakerConfig | None = field(default_factory=BreakerConfig)

    def __post_init__(self):
        if not isinstance(self.episodes, tuple):
            object.__setattr__(self, "episodes", tuple(self.episodes))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        d = dict(d)
        if "episodes" in d:
            d["episodes"] = tuple(
                _from_dict(FaultEpisode, dict(e), "fault episode")
                for e in d["episodes"])
        if d.get("retry") is not None:
            d["retry"] = _from_dict(RetryConfig, dict(d["retry"]), "retry")
        if d.get("breaker") is not None:
            d["breaker"] = _from_dict(BreakerConfig, dict(d["breaker"]),
                                      "breaker")
        return _from_dict(cls, d, "faults")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class RecoveryStats:
    """Per-region failure/recovery accounting, attached to ``FleetStats``."""
    name: str
    outages: int = 0
    outage_s: float = 0.0
    lost_inflight: int = 0      # frames killed inside a dispatched batch
    lost_pending: int = 0       # frames lost in a dead cell's queue/transport
    retries: int = 0            # retry attempts launched for this home region
    degraded: int = 0           # frames that fell back to device-only
    breaker_trips: int = 0
    breaker_open_s: float = 0.0
    recovery_times_s: list[float] = field(default_factory=list)
    frames_during_outage: int = 0
    violations_during_outage: int = 0
    frames_steady: int = 0
    violations_steady: int = 0

    @property
    def lost_offers(self) -> int:
        """Offers lost to this region (each later retried or degraded)."""
        return self.lost_inflight + self.lost_pending

    @property
    def mean_time_to_recover_s(self) -> float:
        if not self.recovery_times_s:
            return 0.0
        return sum(self.recovery_times_s) / len(self.recovery_times_s)

    @property
    def violation_ratio_during_outage(self) -> float:
        if self.frames_during_outage == 0:
            return 0.0
        return self.violations_during_outage / self.frames_during_outage

    @property
    def violation_ratio_steady(self) -> float:
        if self.frames_steady == 0:
            return 0.0
        return self.violations_steady / self.frames_steady


class FaultManager:
    """Mutable fault/recovery state for one ``simulate()`` run.

    Owns no policy beyond the breaker objects; ``simcore.simulate`` mutates
    the counters as it realizes episodes and recovery decisions.
    """

    def __init__(self, spec: FaultSpec, n_regions: int, n_streams: int):
        self.spec = spec
        self.retry = spec.retry
        self.down = [False] * n_regions
        self.saved_cap = [0] * n_regions
        if spec.breaker is not None:
            self.breakers: list[CircuitBreaker | None] = [
                CircuitBreaker(spec.breaker) for _ in range(n_regions)]
        else:
            self.breakers = [None] * n_regions
        # per-stream blackout windows, sorted by start
        self.blackouts: list[list[tuple[float, float]]] = [
            [] for _ in range(n_streams)]
        self.outage_windows: list[list[tuple[float, float]]] = [
            [] for _ in range(n_regions)]
        for ep in spec.episodes:
            if ep.kind == "blackout":
                self.blackouts[ep.stream].append((ep.start_s, ep.end_s))
            elif ep.kind == "region_outage":
                self.outage_windows[ep.region].append((ep.start_s, ep.end_s))
        for w in self.blackouts:
            w.sort()
        for w in self.outage_windows:
            w.sort()
        # request / batch tracking
        self.attempts: dict[int, int] = {}
        self.pending_region: dict[int, int] = {}
        self.batch_of: dict[int, int] = {}
        self.batch_members: dict[int, list[int]] = {}
        self.live: list[dict[int, float]] = [{} for _ in range(n_regions)]
        self.dead_batches: set[int] = set()
        self.override: dict[int, tuple[float, int, float]] = {}
        self.bid_seq = itertools.count()
        # per-region counters
        self.outages = [0] * n_regions
        self.outage_s = [0.0] * n_regions
        self.lost_inflight = [0] * n_regions
        self.lost_pending = [0] * n_regions
        self.retries = [0] * n_regions
        self.degraded = [0] * n_regions
        self.awaiting_recovery: list[float | None] = [None] * n_regions
        self.recovery_times: list[list[float]] = [[] for _ in range(n_regions)]
        self.frames_during = [0] * n_regions
        self.viol_during = [0] * n_regions
        self.frames_steady = [0] * n_regions
        self.viol_steady = [0] * n_regions

    def admits(self, r: int, now: float) -> bool:
        br = self.breakers[r]
        return True if br is None else br.admits(now)

    def note_route(self, rid: int, r: int, now: float):
        self.pending_region[rid] = r
        br = self.breakers[r]
        if br is not None:
            br.note_dispatch(now)

    def blacked_out(self, si: int, t: float) -> bool:
        for start, end in self.blackouts[si]:
            if start <= t < end:
                return True
            if start > t:
                break
        return False

    def _in_outage(self, r: int, t0: float, tf: float) -> bool:
        for start, end in self.outage_windows[r]:
            if t0 < end and tf > start:
                return True
        return False

    def note_frame(self, home: int, si: int, t0: float, tf: float,
                   violated: bool):
        """Classify a completed frame as outage-affected or steady-state."""
        affected = self._in_outage(home, t0, tf)
        if not affected:
            for start, end in self.blackouts[si]:
                if t0 < end and tf > start:
                    affected = True
                    break
        if affected:
            self.frames_during[home] += 1
            self.viol_during[home] += int(violated)
        else:
            self.frames_steady[home] += 1
            self.viol_steady[home] += int(violated)

    def region_stats(self, names: list[str], horizon_s: float
                     ) -> list[RecoveryStats]:
        out = []
        for r, name in enumerate(names):
            br = self.breakers[r]
            out.append(RecoveryStats(
                name=name,
                outages=self.outages[r],
                outage_s=self.outage_s[r],
                lost_inflight=self.lost_inflight[r],
                lost_pending=self.lost_pending[r],
                retries=self.retries[r],
                degraded=self.degraded[r],
                breaker_trips=0 if br is None else br.trips,
                breaker_open_s=(0.0 if br is None
                                else br.open_seconds(horizon_s)),
                recovery_times_s=list(self.recovery_times[r]),
                frames_during_outage=self.frames_during[r],
                violations_during_outage=self.viol_during[r],
                frames_steady=self.frames_steady[r],
                violations_steady=self.viol_steady[r],
            ))
        return out
