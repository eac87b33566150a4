"""Fault tolerance for 1000+-node deployments (brief: large-scale runnability).
Port of ``repro.runtime.fault_tolerance`` (numpy, copied unchanged).

Three cooperating mechanisms:

* HeartbeatMonitor — workers report per-step heartbeats; hosts that miss
  ``timeout_steps`` consecutive beats are declared failed. (In a real fleet the
  transport is the coordination service; here it is in-process state so the
  policy logic is fully testable.)
* StragglerDetector — per-step worker durations; a worker slower than
  ``factor`` x the rolling median for ``patience`` consecutive steps is flagged.
  Policy hooks: reassign its data shard (the data pipeline re-keys on the
  worker set) or drop to the elastic path.
* ElasticPlan — given the surviving device count, propose the largest
  (data, model) mesh <= survivors that preserves the model-parallel extent
  (TP degree must divide into surviving hosts' devices; DP shrinks). Restart =
  make_mesh(new shape) + Checkpointer.restore with the new shardings — restore
  elasticity is exercised by tests/test_checkpoint.py.
* CircuitBreaker — per-target admission control for a caller that keeps
  losing requests to it: trip open after ``trip_after`` consecutive failures,
  stay open for ``open_s``, then admit exactly one half-open probe whose
  outcome re-closes or re-opens the breaker. Time is caller-supplied, so the
  state machine is deterministic under the event-heap simulator — the fleet
  runtime (``repro_torch.serving.faults``) keeps one breaker per regional cell and
  reroutes through the spillover path while a cell's breaker is open.

Janus-specific failover: a *network* partition between tiers is handled by the
dynamic scheduler itself (bandwidth -> 0 drives the split to device-only);
these classes handle *worker* failures inside a tier.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Sequence

import numpy as np


class HeartbeatMonitor:
    def __init__(self, workers: Sequence[str], timeout_steps: int = 3):
        self.workers = list(workers)
        self.timeout = timeout_steps
        self.last_beat: dict[str, int] = {w: 0 for w in self.workers}
        self.step = 0

    def beat(self, worker: str, step: int | None = None):
        if worker not in self.last_beat:
            # dynamic registration: a beat from an unknown worker enrolls it,
            # so tick()/alive() track it from now on
            self.workers.append(worker)
        self.last_beat[worker] = step if step is not None else self.step

    def tick(self) -> list[str]:
        """Advance one step; return newly-failed workers."""
        self.step += 1
        return [w for w in self.workers
                if self.step - self.last_beat[w] >= self.timeout]

    def alive(self) -> list[str]:
        return [w for w in self.workers
                if self.step - self.last_beat[w] < self.timeout]


class StragglerDetector:
    def __init__(self, factor: float = 1.5, patience: int = 3, window: int = 16):
        self.factor = factor
        self.patience = patience
        self.durations: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self.strikes: dict[str, int] = defaultdict(int)

    def observe(self, step_durations: dict[str, float]) -> list[str]:
        """Record one step's per-worker durations; return flagged stragglers."""
        med = float(np.median(list(step_durations.values())))
        flagged = []
        for w, d in step_durations.items():
            self.durations[w].append(d)
            if d > self.factor * med:
                self.strikes[w] += 1
            else:
                self.strikes[w] = 0
            if self.strikes[w] >= self.patience:
                flagged.append(w)
        return flagged


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker policy knobs (times in seconds, caller-supplied clock)."""
    trip_after: int = 3
    open_s: float = 0.25

    def __post_init__(self):
        if self.trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got {self.trip_after}")
        if self.open_s <= 0.0:
            raise ValueError(f"open_s must be > 0, got {self.open_s}")


class CircuitBreaker:
    """Deterministic closed/open/half-open breaker with an explicit clock.

    The caller owns time (the event-heap simulator passes sim time), and the
    half-open probe is split across two calls so that *peeking* at
    admissibility during candidate filtering never consumes the probe:
    ``admits(now)`` is side-effect free (beyond the open->half-open clock
    transition); ``note_dispatch(now)`` marks the probe in flight once the
    caller actually routes a request here.
    """

    __slots__ = ("config", "state", "failures", "opened_at", "probe_inflight",
                 "trips", "_open_time_s")

    def __init__(self, config: BreakerConfig):
        self.config = config
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.probe_inflight = False
        self.trips = 0
        self._open_time_s = 0.0  # accumulated fully-resolved open intervals

    def _maybe_half_open(self, now: float):
        if self.state == "open" and now >= self.opened_at + self.config.open_s:
            self.state = "half_open"
            self.probe_inflight = False

    def admits(self, now: float) -> bool:
        """Would a request routed here at ``now`` be admitted? No side effects
        on the probe slot."""
        self._maybe_half_open(now)
        if self.state == "closed":
            return True
        if self.state == "half_open":
            return not self.probe_inflight
        return False

    def note_dispatch(self, now: float):
        """The caller committed a request here; consume the half-open probe."""
        self._maybe_half_open(now)
        if self.state == "half_open":
            self.probe_inflight = True

    def record_success(self, now: float):
        self._maybe_half_open(now)
        if self.state != "closed":
            self._open_time_s += now - self.opened_at
        self.state = "closed"
        self.failures = 0
        self.probe_inflight = False

    def record_failure(self, now: float):
        self._maybe_half_open(now)
        if self.state == "half_open":
            # failed probe: re-open for a fresh window
            self._open_time_s += now - self.opened_at
            self.state = "open"
            self.opened_at = now
            self.probe_inflight = False
            self.trips += 1
        elif self.state == "closed":
            self.failures += 1
            if self.failures >= self.config.trip_after:
                self.state = "open"
                self.opened_at = now
                self.failures = 0
                self.trips += 1
        # already open: losses of requests dispatched before the trip don't
        # extend the window

    def open_seconds(self, now: float) -> float:
        """Total time spent not-closed up to ``now``."""
        extra = 0.0 if self.state == "closed" else max(0.0, now - self.opened_at)
        return self._open_time_s + extra


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(surviving_devices: int, model_parallel: int,
                      min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) grid fitting the survivors, preserving TP degree.

    TP degree is preserved because resharding model-parallel state across a
    *different* TP extent changes per-op shapes (recompile + reshard); shrinking
    DP only requires re-batching, which the data pipeline handles.
    """
    if surviving_devices < model_parallel * min_data:
        raise ValueError(
            f"{surviving_devices} devices cannot sustain model_parallel="
            f"{model_parallel} (need >= {model_parallel * min_data})")
    data = surviving_devices // model_parallel
    # power-of-two DP keeps batch splitting simple
    data = 1 << (data.bit_length() - 1)
    return ElasticPlan(data=data, model=model_parallel)
