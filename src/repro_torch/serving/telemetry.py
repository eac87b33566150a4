"""Event-sourced observability for the fleet simulator.
Port of ``repro.serving.telemetry`` (numpy, copied unchanged).

``simcore.simulate`` accepts an optional :class:`Telemetry` recorder and
calls its hooks from the heap loop — every call site is guarded by
``if tel is not None``, so a run without a recorder executes today's exact
instruction stream (the ``FleetStats`` bit-exactness contract extends to
``telemetry=None``, same discipline as the ``faults=∅`` and ``regions=1``
parity pins). Three pillars:

**Span traces.** Per-frame phase spans on the stream tracks — ``device``
(incl. scheduler overhead), ``uplink``, ``enqueue`` (the spillover detour's
extra RTT), ``batch-wait``, ``cloud`` (or ``cloud-lost`` when the serving
cell died mid-flight), ``queue-lost``, ``retry-backoff``,
``degraded-fallback``, and one enclosing ``frame`` span — plus per-region
lifecycle spans: ``batch`` (dispatch→finish, optimistic: a later kill is
marked by a ``batch-killed`` instant, not by truncating the span),
``region-outage``, ``breaker-open``, and instants for autoscale decisions,
breaker transitions, executor crashes, and lost offers. Spans are stored as
plain tuples in a bounded deque and exported as Chrome trace-event JSON
(``chrome_trace`` / ``write_chrome_trace``, loadable in Perfetto or
``chrome://tracing``) or a JSONL raw feed (``write_jsonl``). Stream-track
spans honor the sampling knobs; region-track spans are always recorded
(they are per batch / per episode, not per frame).

**Windowed metrics.** Per ``window_s`` of *sim time*: offered / finished /
violation / drop / spill / lost / retry / degraded counts, dispatched busy
seconds and queue-depth high-water mark per region, and exact per-window
latency percentiles per region and per SLA class (``np.percentile`` over
the window's raw latencies — the same op ``RunStats`` uses end-of-run).
Counters increment for **every** frame regardless of sampling, so window
totals reconcile exactly with ``FleetStats``; only latency reservoirs and
spans are sampled. Windows live in a bounded dict (oldest evicted past
``max_windows``; evictions are counted, never silent).

**Decision logs.** For sampled frames, the planner's chosen ``(α, split)``
and home region, the committed bandwidth estimate the decision actually
used (read from the estimator window *before* the frame's observation
commits — bit-equal to the speculated batched estimate), the predicted SLA
slack left after the planned phases, and the runner-up split at the chosen
α with its predicted latency delta.

Accounting conventions (documented, not configurable): latencies and
violation counts attribute to the frame's *home* region; window ``busy_s``
is dispatched service time (not refunded when a fault kills the batch, so
outage-window utilization reads as dispatched-load, matching the region
``batch`` spans); a frame finishing at ``t`` lands in window
``floor(t / window_s)``.

Overhead contract: at the default sampling config the enabled recorder must
stay within 1.3x the telemetry-off wall per fleet-scale cell — measured by
the ``telemetry_overhead`` section of ``BENCH_fleet_scale.json`` and gated
by ``benchmarks/check_regression.py``. See ``docs/observability.md``.
"""
from __future__ import annotations

import array
import collections
import dataclasses
import json

import numpy as np

# track kinds (span tuples carry these; export maps them to trace pids)
_REGION, _STREAM = 0, 1
_PIDS = {_REGION: 1, _STREAM: 2}
_TRACKS = {_REGION: "region", _STREAM: "stream"}

#: wall-ratio budget (telemetry-on / telemetry-off) the CI gate enforces
OVERHEAD_BUDGET_RATIO = 1.3


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Sampling knobs and ring bounds (see module docstring).

    ``stream_sample=k`` records stream-track spans and decision logs for
    streams with ``si % k == 0`` (1 = every stream); ``frame_sample=k``
    further thins a sampled stream to every k-th frame. Windowed counters
    ignore sampling entirely — they are exact by design.
    """
    window_s: float = 1.0
    stream_sample: int = 16
    frame_sample: int = 1
    decisions: bool = True
    max_windows: int = 4096
    max_spans: int = 1 << 20
    max_decisions: int = 1 << 16

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        for field in ("stream_sample", "frame_sample", "max_windows",
                      "max_spans", "max_decisions"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, "
                                 f"got {getattr(self, field)}")


def _pct(vals: list[float]) -> dict:
    """Exact percentile block for one window reservoir (the same
    ``np.percentile`` call ``RunStats.p50/p99`` uses end-of-run)."""
    if not vals:
        return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0}
    a = np.asarray(vals)
    return {"n": len(vals),
            "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3}


class _Window:
    """One sim-time window's counters and latency reservoirs."""

    __slots__ = ("index", "drops", "offered", "finished", "violations",
                 "spills", "lost", "retries", "degraded", "busy_s", "qmax",
                 "cap_max", "lat_r", "lat_c")

    def __init__(self, index: int, n_regions: int, n_classes: int,
                 caps: list[int]):
        self.index = index
        self.drops = 0
        self.offered = [0] * n_regions
        self.finished = [0] * n_regions
        self.violations = [0] * n_regions
        self.spills = [0] * n_regions
        self.lost = [0] * n_regions
        self.retries = [0] * n_regions
        self.degraded = [0] * n_regions
        self.busy_s = [0.0] * n_regions
        self.qmax = [0] * n_regions
        self.cap_max = list(caps)
        self.lat_r: list[list[float]] = [[] for _ in range(n_regions)]
        self.lat_c: list[list[float]] = [[] for _ in range(n_classes)]


class Telemetry:
    """One simulation run's recorder. ``simcore.simulate`` calls ``bind``
    at simulation start (which resets all state, so a recorder instance is
    one-run-at-a-time) and the event hooks from the heap loop; after the
    run, read ``metrics_summary`` / ``chrome_trace`` / ``decision_log`` or
    write the export files. The recorder never feeds back into the
    simulation — it only observes."""

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self.bound = False

    # -- lifecycle -----------------------------------------------------------

    def bind(self, region_names: list[str], caps: list[int],
             stream_regions: list[int], stream_classes: list[str]) -> None:
        """Attach to one simulation's fleet shape and reset all state."""
        cfg = self.config
        self._region_names = list(region_names)
        self._nr = len(region_names)
        self._caps = list(caps)
        self._region_of = list(stream_regions)
        # SLA classes as dense indices so the per-frame hot path does list
        # indexing instead of string-keyed dict lookups
        self._class_names = sorted(set(stream_classes))
        self._nc = len(self._class_names)
        cidx = {c: i for i, c in enumerate(self._class_names)}
        self._class_of = [cidx[c] for c in stream_classes]
        # with one SLA class the per-class reservoir is just the union of
        # the per-region ones, so skip the per-frame append and derive it
        # at summary time
        self._single_class = self._nc == 1
        ss = cfg.stream_sample
        self._span_stream = [si % ss == 0 for si in range(len(stream_regions))]
        self._fsamp = cfg.frame_sample
        self._w_s = cfg.window_s
        self._inv_w = 1.0 / cfg.window_s
        # decision-log row cache: (acct id, α, rtt) -> plain-float rows, so
        # sampled runner-up evals are a 15-element Python loop, not numpy
        self._row_cache: dict[tuple, tuple] = {}
        self._windows: dict[int, _Window] = {}
        self._last_win: _Window | None = None
        self.windows_evicted = 0
        # span tuples: (ph, t_s, dur_s, cat, name, track_kind, track_id, args)
        self._spans: collections.deque = \
            collections.deque(maxlen=cfg.max_spans)
        self.spans_total = 0
        self.frame_spans = 0
        self._decisions: collections.deque = \
            collections.deque(maxlen=cfg.max_decisions)
        self.decisions_total = 0
        # per-frame raw feeds: the heap loop extends a flat ``array('d')``
        # per event (unboxed doubles, no GC-tracked tuples retained) and
        # ``_drain_raw`` buckets them into windows vectorized via a
        # zero-parse buffer view, so the exact counters cost almost
        # nothing on the simulation's critical path
        self._fin_raw = array.array("d")    # si, tf, lat, violated
        self._off_raw = array.array("d")    # home, t
        self._enq_raw = array.array("d")    # r, t, depth
        # deferred span feeds: the high-rate span kinds (every batch, plus
        # the sampled per-frame spans) are likewise pushed as bare scalars
        # and only materialized into span tuples by
        # ``_merge_deferred_spans`` when an export reads them — span
        # tuples + args dicts per event would drag the GC cadence up and
        # blow the overhead budget at fleet scale
        self._batch_raw = array.array("d")      # r, start, service, size
        self._qd_raw = array.array("d")         # r, t, depth
        self._plan_raw = array.array("d")       # si, fi, t, dur, comm, a, sp
        self._bwait_raw = array.array("d")      # si, t_q, dur
        self._fspan_raw = array.array("d")      # 14 cols, see merge
        self._region_np = np.asarray(self._region_of, dtype=np.int64)
        self._class_np = np.asarray(self._class_of, dtype=np.int64)
        # sampled in-flight bookkeeping (popped on dispatch / loss / finish)
        self._offer_t: dict[int, tuple[float, int]] = {}    # rid -> (t, si)
        self._cloud_open: dict[int, tuple[float, float, int, int]] = {}
        # open lifecycle spans (closed by the matching end event / finalize)
        self._outage_open: dict[int, float] = {}
        self._breaker_open: dict[int, float] = {}
        self._breaker_last = ["closed"] * self._nr
        # exact fleet-level counters (reconcile against FleetStats)
        self.frames_finished = 0
        self.frames_dropped = 0
        self.horizon_s = 0.0
        self.bound = True

    def sinks(self):
        """Bound appends for the three per-frame raw feeds — finish
        ``si, tf, lat, violated``, cloud offer ``home, t``, enqueue
        ``r, t, depth``. The heap loop pushes each field as a bare scalar
        (unboxed into the ``array('d')`` — no GC-tracked allocation per
        event, which matters: tuple-per-event feeds cost ~70 extra GC
        passes over the whole sim heap at fleet scale); ``_drain_raw``
        buckets the backlog vectorized."""
        return (self._fin_raw.append, self._off_raw.append,
                self._enq_raw.append)

    @staticmethod
    def _columns(raw: "array.array", width: int) -> np.ndarray:
        """``(n, width)`` float array from a flat ``array('d')`` feed —
        a zero-parse buffer view, copied so the feed can be cleared."""
        return np.frombuffer(raw, np.float64).reshape(-1, width).copy()

    def _drain_raw(self) -> None:
        """Bucket the raw per-frame feeds into windows (exact counters,
        latency reservoirs, queue high-water). Idempotent and incremental:
        each call drains and clears the current backlog."""
        nr = self._nr
        if self._off_raw:
            a = self._columns(self._off_raw, 2)
            del self._off_raw[:]
            key = (a[:, 1] * self._inv_w).astype(np.int64) * nr \
                + a[:, 0].astype(np.int64)
            for k, n in zip(*np.unique(key, return_counts=True)):
                self._win(int(k) // nr).offered[int(k) % nr] += int(n)
        if self._enq_raw:
            a = self._columns(self._enq_raw, 3)
            del self._enq_raw[:]
            key = (a[:, 1] * self._inv_w).astype(np.int64) * nr \
                + a[:, 0].astype(np.int64)
            order = np.argsort(key, kind="stable")
            ks = key[order]
            ds = a[:, 2].astype(np.int64)[order]
            starts = np.r_[0, np.flatnonzero(np.diff(ks)) + 1]
            hi = np.maximum.reduceat(ds, starts)
            for k, m in zip(ks[starts], hi):
                w = self._win(int(k) // nr)
                if m > w.qmax[int(k) % nr]:
                    w.qmax[int(k) % nr] = int(m)
        if self._fin_raw:
            a = self._columns(self._fin_raw, 4)
            del self._fin_raw[:]
            self.frames_finished += len(a)
            si = a[:, 0].astype(np.int64)
            lat = a[:, 2]
            vio = a[:, 3]
            wi = (a[:, 1] * self._inv_w).astype(np.int64)
            key = wi * nr + self._region_np[si]
            order = np.argsort(key, kind="stable")
            ks, ls, vs = key[order], lat[order], vio[order]
            cut = np.flatnonzero(np.diff(ks)) + 1
            starts = np.r_[0, cut]
            ends = np.r_[cut, len(ks)]
            for s, e, k in zip(starts, ends, ks[starts]):
                w = self._win(int(k) // nr)
                r = int(k) % nr
                w.finished[r] += int(e - s)
                w.violations[r] += int(vs[s:e].sum())
                w.lat_r[r].extend(ls[s:e].tolist())
            if not self._single_class:
                nc = self._nc
                key = wi * nc + self._class_np[si]
                order = np.argsort(key, kind="stable")
                ks, ls = key[order], lat[order]
                cut = np.flatnonzero(np.diff(ks)) + 1
                starts = np.r_[0, cut]
                ends = np.r_[cut, len(ks)]
                for s, e, k in zip(starts, ends, ks[starts]):
                    self._win(int(k) // nc).lat_c[int(k) % nc].extend(
                        ls[s:e].tolist())

    def finalize(self, horizon_s: float) -> None:
        """Close lifecycle spans still open when the simulation drained,
        and bucket the raw per-frame feeds into their windows."""
        self._drain_raw()
        self.horizon_s = horizon_s
        for r, t0 in sorted(self._outage_open.items()):
            self._span("X", t0, max(0.0, horizon_s - t0), "region",
                       "region-outage", _REGION, r, {"open_at_end": True})
        self._outage_open.clear()
        for r, t0 in sorted(self._breaker_open.items()):
            self._span("X", t0, max(0.0, horizon_s - t0), "region",
                       "breaker-open", _REGION, r, {"open_at_end": True})
        self._breaker_open.clear()

    # -- span plumbing -------------------------------------------------------

    def _span(self, ph: str, t: float, dur: float, cat: str, name: str,
              tk: int, tid: int, args: dict | None = None) -> None:
        self.spans_total += 1
        self._spans.append((ph, t, dur, cat, name, tk, tid, args))

    def _sampled(self, si: int, fi: int) -> bool:
        return self._span_stream[si] and fi % self._fsamp == 0

    def sampling(self) -> tuple[list[bool], int, bool]:
        """``(span_stream, frame_sample, decisions)`` — handed to the heap
        loop so it can inline the per-frame sampling gate instead of paying
        a method call per frame just to early-return."""
        return self._span_stream, self._fsamp, self.config.decisions

    def _win(self, index: int) -> _Window:
        w = self._last_win
        if w is not None and w.index == index:
            return w
        w = self._windows.get(index)
        if w is None:
            w = _Window(index, self._nr, self._nc, self._caps)
            self._windows[index] = w
            if len(self._windows) > self.config.max_windows:
                self._windows.pop(min(self._windows))
                self.windows_evicted += 1
        self._last_win = w
        return w

    # -- frame-path hooks (simcore heap loop) --------------------------------

    def frame_planned(self, si: int, fi: int, t0: float, dev_start: float,
                      ov: float, dev_s: float, comm_s: float,
                      alpha: float, split: int) -> None:
        if not self._sampled(si, fi):
            return
        self.spans_total += 2 if comm_s > 0.0 else 1
        self._plan_raw.extend((si, fi, dev_start, ov + dev_s, comm_s,
                               alpha, split))

    def log_decision(self, si: int, fi: int, t0: float, home: int,
                     alpha: float, split: int, est_bps: float,
                     slack_s: float, acct, rtt_s: float) -> None:
        """Record a sampled planner decision plus its runner-up split (the
        second-best split at the chosen α under the same estimate)."""
        alt_split, alt_lat, lat = -1, 0.0, 0.0
        if acct is not None and est_bps > 0.0:
            key = (id(acct), alpha, rtt_s)
            row = self._row_cache.get(key)
            if row is None:
                ai = int(np.argmin(np.abs(acct.alpha - alpha)))
                bits = acct.bits[ai].tolist()
                fixed = (rtt_s * acct.tables.rtt_mask
                         + acct.dev[ai] + acct.cloud[ai]).tolist()
                row = self._row_cache[key] = \
                    (bits, fixed, acct.cand.tolist())
            bits, fixed, cand = row
            inv = 1.0 / est_bps
            alt_lat = float("inf")
            for j, cj in enumerate(cand):
                lj = bits[j] * inv + fixed[j]
                if cj == split:
                    lat = lj
                elif lj < alt_lat:
                    alt_lat, alt_split = lj, cj
        self.decisions_total += 1
        self._decisions.append((t0, si, fi, home, alpha, split, est_bps,
                                slack_s, lat, alt_split, alt_lat))

    def frame_dropped(self, si: int, t0: float) -> None:
        self.frames_dropped += 1
        self._win(int(t0 * self._inv_w)).drops += 1

    def spilled(self, home: int, now: float) -> None:
        self._win(int(now * self._inv_w)).spills[home] += 1

    def enqueue_delay(self, rid: int, si: int, fi: int, now: float,
                      delta: float) -> None:
        """The spillover detour's extra round-trip before batcher entry."""
        if self._sampled(si, fi):
            self._span("X", now, delta, "frame", "enqueue", _STREAM, si,
                       {"frame": fi})

    def enqueued(self, rid: int, si: int, fi: int, r: int, now: float,
                 depth: int) -> None:
        """Sampled-frame batcher entry (queue-depth counters for every
        frame flow through the raw ``sinks()`` feed instead)."""
        self._offer_t[rid] = (now, si)
        self.spans_total += 1
        self._qd_raw.extend((r, now, depth))

    def batch_dispatched(self, r: int, start: float, service: float,
                         members: list[int]) -> None:
        if len(self._fin_raw) > 1 << 18:    # bound the raw-feed backlog
            self._drain_raw()
        done = start + service
        self.spans_total += 1
        br = self._batch_raw
        br.append(r)
        br.append(start)
        br.append(service)
        br.append(len(members))
        # busy seconds attributed to windows by overlap (service is usually
        # well under a window, so this loop is 1–2 iterations)
        w_s = self._w_s
        i0, i1 = int(start * self._inv_w), int(done * self._inv_w)
        if i0 == i1:
            w = self._last_win
            if w is None or w.index != i0:
                w = self._win(i0)
            w.busy_s[r] += service
        else:
            for i in range(i0, i1 + 1):
                lo, hi = max(start, i * w_s), min(done, (i + 1) * w_s)
                if hi > lo:
                    self._win(i).busy_s[r] += hi - lo
        ot = self._offer_t
        if ot:
            for rid in members:
                ent = ot.pop(rid, None)
                if ent is not None:
                    t_q, si = ent
                    self.spans_total += 1
                    self._bwait_raw.extend((si, t_q, start - t_q))
                    self._cloud_open[rid] = (start, service, r, si)

    def frame_finished(self, si: int, fi: int, rid: int, t0: float,
                       tf: float, lat: float, violated: bool, queue_s: float,
                       alpha: float, split: int, degraded: bool) -> None:
        """Sampled-frame completion spans (finish counters and latency
        reservoirs for every frame flow through the raw ``sinks()`` feed)."""
        co = self._cloud_open.pop(rid, None)
        if co is not None:
            cloud, c_start, c_service, c_r = 1.0, co[0], co[1], co[2]
            self.spans_total += 1
        else:
            cloud = c_start = c_service = c_r = 0.0
        self.frame_spans += 1
        self.spans_total += 1
        self._fspan_raw.extend((si, fi, t0, tf, lat, queue_s, alpha, split,
                                violated, degraded, cloud, c_start,
                                c_service, c_r))

    # -- fault / recovery hooks ----------------------------------------------

    def offer_lost(self, rid: int, si: int, r: int | None,
                   now: float) -> None:
        if r is not None:
            self._win(int(now / self._w_s)).lost[r] += 1
            self._span("I", now, 0.0, "region", "offer-lost", _REGION, r,
                       None)
        ent = self._offer_t.pop(rid, None)
        if ent is not None:   # died queued in a cell that went dark
            t_q, si_q = ent
            self._span("X", t_q, now - t_q, "frame", "queue-lost",
                       _STREAM, si_q, None)
        co = self._cloud_open.pop(rid, None)
        if co is not None:    # died mid-flight in a killed batch
            start, _, cr, si_c = co
            self._span("X", start, now - start, "frame", "cloud-lost",
                       _STREAM, si_c, {"region": self._region_names[cr]})

    def retry_scheduled(self, rid: int, si: int, fi: int, home: int,
                        now: float, backoff_s: float, attempt: int) -> None:
        self._win(int(now / self._w_s)).retries[home] += 1
        if self._sampled(si, fi):
            self._span("X", now, backoff_s, "frame", "retry-backoff",
                       _STREAM, si, {"frame": fi, "attempt": attempt})

    def degraded_run(self, rid: int, si: int, fi: int, home: int,
                     start: float, dev_s: float) -> None:
        self._win(int(start / self._w_s)).degraded[home] += 1
        if self._sampled(si, fi):
            self._span("X", start, dev_s, "frame", "degraded-fallback",
                       _STREAM, si, {"frame": fi})

    def outage_started(self, r: int, now: float) -> None:
        self._outage_open[r] = now
        self._span("I", now, 0.0, "region", "outage-start", _REGION, r, None)

    def outage_ended(self, r: int, now: float) -> None:
        t0 = self._outage_open.pop(r, None)
        if t0 is not None:
            self._span("X", t0, now - t0, "region", "region-outage",
                       _REGION, r, None)

    def executor_crash(self, r: int, now: float) -> None:
        self._span("I", now, 0.0, "region", "executor-crash", _REGION, r,
                   None)

    def batch_killed(self, r: int, now: float, size: int) -> None:
        self._span("I", now, 0.0, "region", "batch-killed", _REGION, r,
                   {"size": size})

    def breaker_state(self, r: int, now: float, state: str) -> None:
        """Emit transition instants (and open→close spans) when a breaker's
        observable state moved since the last time this hook saw it."""
        prev = self._breaker_last[r]
        if state == prev:
            return
        self._breaker_last[r] = state
        self._span("I", now, 0.0, "region", f"breaker->{state}", _REGION, r,
                   {"from": prev})
        if state == "open" and r not in self._breaker_open:
            self._breaker_open[r] = now
        elif state == "closed":
            t0 = self._breaker_open.pop(r, None)
            if t0 is not None:
                self._span("X", t0, now - t0, "region", "breaker-open",
                           _REGION, r, None)

    def capacity_changed(self, r: int, now: float, newc: int) -> None:
        self._caps[r] = newc
        w = self._win(int(now / self._w_s))
        if newc > w.cap_max[r]:
            w.cap_max[r] = newc
        self._span("C", now, 0.0, "region", "capacity", _REGION, r,
                   {"capacity": newc})

    def autoscale(self, r: int, now: float, old: int, new: int) -> None:
        self._span("I", now, 0.0, "region", "autoscale", _REGION, r,
                   {"from": old, "to": new})

    # -- exports -------------------------------------------------------------

    def _merge_deferred_spans(self) -> None:
        """Materialize the span kinds the hot path deferred as bare
        scalars (batch, queue-depth, device/uplink, batch-wait,
        cloud/frame) into real span tuples, merged time-sorted with the
        online spans. Idempotent; runs on first export access, off the
        simulation's timed path."""
        if not (self._batch_raw or self._qd_raw or self._plan_raw
                or self._bwait_raw or self._fspan_raw):
            return
        spans = list(self._spans)
        ap = spans.append
        cols = zip(*[iter(self._batch_raw)] * 4)
        for r, start, service, size in cols:
            ap(("X", start, service, "region", "batch", _REGION, int(r),
                {"size": int(size)}))
        cols = zip(*[iter(self._qd_raw)] * 3)
        for r, t, depth in cols:
            ap(("C", t, 0.0, "region", "queue-depth", _REGION, int(r),
                {"depth": int(depth)}))
        cols = zip(*[iter(self._plan_raw)] * 7)
        for si, fi, t, dur, comm_s, alpha, split in cols:
            si, fi = int(si), int(fi)
            ap(("X", t, dur, "frame", "device", _STREAM, si,
                {"frame": fi, "alpha": round(alpha, 4),
                 "split": int(split)}))
            if comm_s > 0.0:
                ap(("X", t + dur, comm_s, "frame", "uplink", _STREAM, si,
                    {"frame": fi}))
        cols = zip(*[iter(self._bwait_raw)] * 3)
        for si, t_q, dur in cols:
            ap(("X", t_q, dur, "frame", "batch-wait", _STREAM, int(si),
                None))
        cols = zip(*[iter(self._fspan_raw)] * 14)
        for (si, fi, t0, tf, lat, queue_s, alpha, split, violated,
             degraded, cloud, c_start, c_service, c_r) in cols:
            si, fi = int(si), int(fi)
            if cloud:
                ap(("X", c_start, c_service, "frame", "cloud", _STREAM,
                    si, {"frame": fi,
                         "region": self._region_names[int(c_r)]}))
            ap(("X", t0, tf - t0, "frame", "frame", _STREAM, si,
                {"frame": fi, "alpha": round(alpha, 4),
                 "split": int(split),
                 "latency_ms": round(lat * 1e3, 3),
                 "queue_ms": round(queue_s * 1e3, 3),
                 "violated": bool(violated), "degraded": bool(degraded)}))
        for raw in (self._batch_raw, self._qd_raw, self._plan_raw,
                    self._bwait_raw, self._fspan_raw):
            del raw[:]
        spans.sort(key=lambda s: s[1])
        self._spans = collections.deque(spans,
                                        maxlen=self.config.max_spans)

    @property
    def spans(self) -> list[tuple]:
        """Recorded span tuples ``(ph, t_s, dur_s, cat, name, track_kind,
        track_id, args)``, sorted by start time."""
        self._merge_deferred_spans()
        return list(self._spans)

    def decision_log(self) -> list[dict]:
        return [{"t_s": t, "stream": si, "frame": fi,
                 "region": self._region_names[home],
                 "alpha": alpha, "split": split, "est_bps": est,
                 "slack_pred_s": slack, "pred_latency_s": lat,
                 "alt_split": alt_split, "alt_latency_s": alt_lat}
                for (t, si, fi, home, alpha, split, est, slack, lat,
                     alt_split, alt_lat) in self._decisions]

    def chrome_trace(self) -> dict:
        """The run as a Chrome trace-event JSON object (Perfetto-loadable):
        regions are pid 1 with one thread per cell, sampled streams are
        pid 2 with one thread per stream; ts/dur are sim-time µs."""
        self._merge_deferred_spans()
        meta: list[dict] = [
            {"ph": "M", "pid": _PIDS[_REGION], "name": "process_name",
             "args": {"name": "fleet regions"}},
            {"ph": "M", "pid": _PIDS[_STREAM], "name": "process_name",
             "args": {"name": "streams (sampled)"}},
        ]
        for r, name in enumerate(self._region_names):
            meta.append({"ph": "M", "pid": _PIDS[_REGION], "tid": r,
                         "name": "thread_name", "args": {"name": name}})
        events: list[dict] = []
        stream_tids: set[int] = set()
        for ph, t, dur, cat, name, tk, tid, args in self._spans:
            if tk == _STREAM:
                stream_tids.add(tid)
            e = {"ph": ph, "ts": round(t * 1e6, 3), "pid": _PIDS[tk],
                 "tid": tid, "cat": cat, "name": name}
            if ph == "X":
                e["dur"] = round(dur * 1e6, 3)
            elif ph == "I":
                e["s"] = "t"
            elif ph == "C":
                # counter events carry the value in args; keep the series
                # name stable per region thread
                e["name"] = f"{name} {self._region_names[tid]}"
                e["tid"] = 0
            if args:
                e["args"] = dict(args)
            events.append(e)
        for si in sorted(stream_tids):
            meta.append({"ph": "M", "pid": _PIDS[_STREAM], "tid": si,
                         "name": "thread_name",
                         "args": {"name": f"stream {si}"}})
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "frames_finished": self.frames_finished,
                    "frames_dropped": self.frames_dropped,
                    "frame_spans": self.frame_spans,
                    "spans_recorded": self.spans_total,
                    "spans_kept": len(self._spans),
                    "decisions": len(self._decisions),
                    "horizon_s": self.horizon_s,
                    "stream_sample": self.config.stream_sample,
                    "frame_sample": self.config.frame_sample}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    def write_jsonl(self, path: str) -> None:
        """Raw feed: one JSON object per span, then per decision record."""
        self._merge_deferred_spans()
        with open(path, "w") as f:
            for ph, t, dur, cat, name, tk, tid, args in self._spans:
                rec = {"kind": "span", "ph": ph, "t_s": t, "dur_s": dur,
                       "cat": cat, "name": name, "track": _TRACKS[tk],
                       "id": tid}
                if args:
                    rec["args"] = dict(args)
                f.write(json.dumps(rec) + "\n")
            for d in self.decision_log():
                f.write(json.dumps({"kind": "decision", **d}) + "\n")

    def _per_class(self, w: _Window) -> dict:
        if self._single_class:
            vals = [v for lr in w.lat_r for v in lr]
            if not vals:
                return {}
            return {self._class_names[0]: _pct(vals)}
        return {cls: _pct(w.lat_c[ci])
                for ci, cls in enumerate(self._class_names)
                if w.lat_c[ci]}

    def metrics_summary(self) -> dict:
        """Windowed time series (exact counters + exact percentiles)."""
        self._drain_raw()
        self._merge_deferred_spans()
        wins = []
        for i in sorted(self._windows):
            w = self._windows[i]
            per_region = []
            for r in range(self._nr):
                cap_s = w.cap_max[r] * self._w_s
                per_region.append({
                    "name": self._region_names[r],
                    "offered": w.offered[r],
                    "finished": w.finished[r],
                    "violations": w.violations[r],
                    "spills": w.spills[r],
                    "lost": w.lost[r],
                    "retries": w.retries[r],
                    "degraded": w.degraded[r],
                    "busy_s": w.busy_s[r],
                    "utilization": min(1.0, w.busy_s[r] / cap_s)
                    if cap_s > 0 else 0.0,
                    "queue_depth_max": w.qmax[r],
                    "latency": _pct(w.lat_r[r]),
                })
            offered = sum(w.offered)
            wins.append({
                "index": i,
                "t0_s": i * self._w_s,
                "t1_s": (i + 1) * self._w_s,
                "offered": offered,
                "finished": sum(w.finished),
                "violations": sum(w.violations),
                "drops": w.drops,
                "spills": sum(w.spills),
                "spill_ratio": sum(w.spills) / offered if offered else 0.0,
                "lost": sum(w.lost),
                "retries": sum(w.retries),
                "degraded": sum(w.degraded),
                "per_region": per_region,
                "per_class": self._per_class(w),
            })
        return {"window_s": self._w_s,
                "windows": wins,
                "windows_evicted": self.windows_evicted,
                "totals": {"frames_finished": self.frames_finished,
                           "frames_dropped": self.frames_dropped,
                           "frame_spans": self.frame_spans,
                           "spans_recorded": self.spans_total,
                           "spans_kept": len(self._spans),
                           "decisions": len(self._decisions),
                           "horizon_s": self.horizon_s}}

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.metrics_summary(), f, indent=2)

    # -- reconciliation ------------------------------------------------------

    def reconcile(self, fs) -> dict:
        """Cross-check the recorder against a run's ``FleetStats`` — the
        ``unaccounted_frames == 0`` discipline extended to telemetry. With
        full sampling (``stream_sample == frame_sample == 1``) the frame
        *span* count must also equal the completed-frame count."""
        full = (self.config.stream_sample == 1
                and self.config.frame_sample == 1)
        self._drain_raw()
        window_finished = sum(sum(w.finished)
                              for w in self._windows.values())
        out = {
            "frames_finished": self.frames_finished,
            "fleet_frames": len(fs.all_frames),
            "frames_dropped": self.frames_dropped,
            "fleet_dropped": fs.total_dropped,
            "window_finished": window_finished,
            "frame_spans": self.frame_spans,
            "full_sampling": full,
            "open_offers": len(self._offer_t),
            "open_cloud": len(self._cloud_open),
        }
        out["ok"] = (
            self.frames_finished == len(fs.all_frames)
            and self.frames_dropped == fs.total_dropped
            and window_finished == self.frames_finished
            and not self._offer_t and not self._cloud_open
            and (not full or self.frame_spans == self.frames_finished))
        return out


def format_window_summary(tel: Telemetry, max_rows: int = 8) -> str:
    """Per-window text block for the fleet report (``serve.py``)."""
    ms = tel.metrics_summary()
    wins = ms["windows"]
    if not wins:
        return "[fleet windows] (no completed windows)"
    stride = max(1, -(-len(wins) // max_rows))
    lines = [f"[fleet windows] window={ms['window_s']:g}s "
             f"({len(wins)} windows, every {stride})"
             if stride > 1 else
             f"[fleet windows] window={ms['window_s']:g}s "
             f"({len(wins)} windows)"]
    for w in wins[::stride]:
        p99 = max((pr["latency"]["p99_ms"] for pr in w["per_region"]
                   if pr["latency"]["n"]), default=0.0)
        util = max(pr["utilization"] for pr in w["per_region"])
        q = max(pr["queue_depth_max"] for pr in w["per_region"])
        viol = w["violations"] / w["finished"] if w["finished"] else 0.0
        extra = ""
        if w["lost"] or w["retries"] or w["degraded"]:
            extra = (f" lost={w['lost']} retry={w['retries']} "
                     f"degraded={w['degraded']}")
        lines.append(
            f"  [{w['t0_s']:6.1f}s,{w['t1_s']:6.1f}s) "
            f"done={w['finished']:6d} viol={viol:5.3f} "
            f"q<= {q:4d} util<= {util:4.2f} "
            f"spill={w['spill_ratio']:5.3f} p99={p99:7.1f}ms" + extra)
    return "\n".join(lines)
