"""Event-heap simulator core for the fleet runtime: cost scales with events.
Port of ``repro.serving.simcore``, a numpy copy: its engine-mode dispatch
calls the port's ``run_cloud_batch``, so a CUDA fleet reaches the kernels.

``fleet.FleetRuntime.run`` delegates here. The retired per-frame loop (kept
as ``FleetRuntime.run_reference``, the parity oracle) paid one
``JanusEngine.plan_frame`` Python call per frame — estimator bookkeeping, an
``(A, S)`` planner eval, several small-numpy accounting calls, and a handful
of dataclass allocations — per stream per frame. At fleet scale (thousands
of streams, ``benchmarks/fleet_scale_bench.py``) that per-frame Python
overhead, not the event count, dominated wall time.

This core keeps the discrete-event structure — one heap carrying arrival,
device+uplink-done, cloud-batch-done, batcher-poll, and autoscale-tick
events, with the micro-batcher (FIFO or priority) and autoscaler objects
reused verbatim so their semantics cannot drift — and removes the per-frame
Python from the hot path:

  * **Batched planner decisions.** Streams are grouped per (planner tables,
    rtt, SLA, policy) — i.e. per (device tier / profile) — and each group's
    Algorithm-1 decisions are evaluated as one chunked ``(R, A, S)`` matrix
    eval over the group's bandwidth-estimate vector instead of R separate
    ``PlannerTables.decide`` calls. One matrix eval per decision epoch.
  * **Precomputed estimate sequences.** The harmonic-mean estimator only
    ever sees the stream's own admitted-frame trace values, so each stream's
    estimate sequence is computed vectorized up front (bit-exact, including
    the cold start and the <5-observation partial windows). It is
    *re*-computed — in one small vectorized chunk — only when an admission
    drop invalidates the speculated observation order; the next pending
    decision stays valid across a drop (it depends only on committed
    observations), so consecutive drops cost O(1) each.
  * **Table-lookup accounting.** Per-(α, split) device/cloud phase latency,
    payload, and accuracy tables are built once per planner-tables instance
    with the exact float-op order of ``JanusEngine.account_breakdown``, so
    per-frame accounting is scalar arithmetic on plain floats.
  * **Flat state, deferred objects.** Each stream's decision pipeline —
    per-frame (α, split), phase latencies, payload, accuracy — is resolved
    from the batched evals into preallocated arrays up front; per-frame
    admission is then scalar arithmetic, and completed frames accumulate as
    plain tuples. ``FrameResult``/``RunStats`` objects are materialized once
    at the end, in the retired loop's per-stream completion order.

Bit-exactness contract: with ``include_scheduler_overhead=False`` this core
reproduces the retired loop's ``FleetStats`` bit for bit (latencies, queue
delays, violation/drop ratios, percentiles, per-class stats, batch sizes,
capacity timeline) on closed-loop, Poisson-overload, MMPP-burst, and
SLA-mix scenarios — tested in ``tests/test_simcore.py``. With overhead
billing on, the vectorized path bills the *amortized* measured wall time of
the batched eval per decision (the retired loop billed each decision's own
measured wall time — equally wall-clock-dependent, differently sliced).

The engine-backed slow path (``execute=True`` with images, or
``planner="legacy"``) runs the same event machinery with per-frame
``plan_frame`` calls, so real-math micro-batched cloud execution and the
legacy-planner comparison benches keep their exact semantics. The fallback
is per stream: a stream whose arrival times are not sorted (so its frames
do not arrive in index order) drops back to an engine-planned stream inside
the same simulation.

**Regional cells.** The cloud tier generalizes to R regions
(``fleet.RegionSpec``): per-region micro-batchers, executor heaps,
autoscalers, and poll/control events all hang off the single event heap
(payloads carry the region index). Planner-batching groups key on
``(region, tables, rtt, sla, policy)`` — the home region's RTT offset is
already baked into each stream's trace by the workload layer, so the
``AcctTables`` evals account it in the engine's exact float order. At OFFER
time a frame whose home-region queue delay exceeds ``rt.spill_slack_s``
routes to the region minimizing ``queue_delay + max(0, Δrtt_offset)``,
paying the positive Δ as an ENQUEUE delay before the remote batcher (it
lands in the frame's ``queue_s``). With one region every branch degenerates
to the classic shared tier — same events, same floats, bit for bit.
"""
from __future__ import annotations

import heapq
import itertools
import time

import numpy as np

from repro_torch.core.bandwidth import HarmonicMeanEstimator
from repro_torch.core.engine import FrameResult, RunStats, run_cloud_batch
from repro_torch.serving.batcher import MicroBatcher, PriorityMicroBatcher, Request
from repro_torch.serving.faults import FaultManager

# event kinds (heap entries are (time, seq, kind, payload) tuples; seq is the
# global tie-break, assigned in push order exactly like the retired loop's).
# ENQUEUE is spillover's deferred batcher entry: a frame routed to a non-home
# region pays the extra round-trip RTT before joining that region's batch.
# FAULT realizes a FaultSpec episode boundary (outage start/end, crash);
# RETRY re-offers a lost cloud frame after its backoff delay. Both exist only
# when rt.faults is set, so the faults=∅ event stream is unchanged.
ARRIVE, OFFER, POLL, FINISH, CONTROL, ENQUEUE, FAULT, RETRY = range(8)
EVENT_NAMES = ("arrive", "offer", "poll", "finish", "control", "enqueue",
               "fault", "retry")

_WINDOW = 5          # HarmonicMeanEstimator's observation window
_CHUNK_MIN, _CHUNK_MAX = 4, 64   # post-drop refill sizing (adaptive)
_EVAL_ELEMS = 1_000_000          # max elements per (R, A, S) eval chunk
# (~8 MB of float64 per chunk buffer: small enough to stay cache-warm
# across the eval's several passes, large enough to amortize numpy overhead)

_POLICIES = ("janus", "device", "cloud", "mixed")
_TABLES, _CONST, _MIXED = 0, 1, 2   # pipe kinds


# ---------------------------------------------------------------------------
# accounting tables (exact account_breakdown float-op order, per tables)
# ---------------------------------------------------------------------------


class AcctTables:
    """Per-(α, split) phase-accounting tables for one ``PlannerTables``.

    ``dev[a, j]`` / ``cloud[a, j]`` reproduce ``account_breakdown``'s
    device/cloud phase values bit-exact: each column is built with the same
    slice-then-``np.sum`` float order the engine uses per frame (verified in
    ``tests/test_simcore.py``). ``payload``/``bits`` are reused from the
    planner tables (identical single-multiply construction), and ``acc[a]``
    is the accuracy model evaluated once per α row.

    The per-layer latencies come from the profile's ``LatencyModel``s, so a
    step-plateau cloud model (``planner.step_aware_profile``) flows through
    unchanged: the simulation prices the exact bucket plateaus the bucketed
    ``--execute`` path runs, and ``decide_batch`` inherits the planner's
    plateau-tie α-snapping (lowest α wins equal-latency cells) for free.
    """

    __slots__ = ("tables", "dev", "cloud", "payload", "bits", "acc",
                 "alpha", "cand", "raw8", "n", "device_only_split")

    def __init__(self, tables, acc_model):
        p = tables.profile
        n = p.n_layers
        counts = tables.counts.astype(np.float64)
        dev_lat = p.device.predict(counts[:, :n])
        cloud_lat = p.cloud.predict(counts[:, :n])
        a_n, s_n = tables.dev_s.shape
        dev = np.zeros((a_n, s_n))
        cloud = np.zeros((a_n, s_n))
        for j, s in enumerate(tables.candidates):
            s = int(s)
            if s == 0:
                cloud[:, j] = p.cloud_embed_s + np.sum(cloud_lat, axis=1) \
                    + p.head_s
            elif s == n + 1:
                dev[:, j] = p.device_embed_s + np.sum(dev_lat, axis=1) \
                    + p.head_s
            else:
                dev[:, j] = p.device_embed_s + np.sum(dev_lat[:, :s], axis=1)
                cloud[:, j] = np.sum(cloud_lat[:, s:], axis=1) + p.head_s
        self.tables = tables
        self.dev = dev
        self.cloud = cloud
        self.payload = tables.payload
        self.bits = tables.bits
        self.acc = np.asarray([acc_model.accuracy(p.x0, sched)
                               for sched in tables.schedules])
        self.alpha = tables.alpha_grid
        self.cand = tables.candidates.astype(np.int64)
        self.raw8 = float(p.raw_input_bytes * 8)
        self.n = n
        self.device_only_split = n + 1

    def decide_batch(self, est: np.ndarray, rtt_s: float,
                     sla_s: float) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``PlannerTables.decide`` over a bandwidth-estimate
        vector: returns (α-index, split-index) per row with exactly the
        scalar path's semantics (first-min split tie-break, first-feasible
        α, global-argmin fallback)."""
        est = np.asarray(est, dtype=np.float64)
        dead = est <= 0.0
        any_dead = bool(dead.any())
        if any_dead:
            # blackout rows: keep the chunk math finite (value irrelevant —
            # the outputs are overwritten with the dead-link decision below);
            # the all-positive path takes no copy and stays bit-identical
            est = np.where(dead, 1.0, est)
        t = self.tables
        a_out = np.empty(len(est), dtype=np.int64)
        j_out = np.empty(len(est), dtype=np.int64)
        a_n, s_n = t.dev_s.shape
        step = max(1, _EVAL_ELEMS // (a_n * s_n))
        # fixed per-(α, split) part of the latency matrix: dev + rtt·mask +
        # cloud. Scalar decide computes (dev + (bits/b + rtt·mask)) + cloud;
        # regrouping to bits/b + (dev + rtt·mask + cloud) would NOT be
        # bit-identical, so keep the exact op order below and only hoist the
        # chunk buffer (in-place ops reuse it; IEEE addition is commutative
        # in value, so a+buf == buf+a bit-exact).
        rtt_term = (rtt_s * t.rtt_mask)[None, None, :]
        buf = np.empty((step, a_n, s_n))
        for lo in range(0, len(est), step):
            e = est[lo:lo + step, None, None]
            out = buf[:len(e)]
            np.divide(t.bits[None], e, out=out)      # bits/b
            np.add(out, rtt_term, out=out)           # comm = bits/b + rtt·mask
            np.add(out, t.dev_s[None], out=out)      # dev + comm
            np.add(out, t.cloud_s[None], out=out)    # (dev + comm) + cloud
            best_j = np.argmin(out, axis=2)
            best_lat = np.take_along_axis(out, best_j[:, :, None],
                                          axis=2)[:, :, 0]
            feasible = best_lat <= sla_s
            has = feasible.any(axis=1)
            a = np.where(has, feasible.argmax(axis=1), best_lat.argmin(axis=1))
            a_out[lo:lo + step] = a
            j_out[lo:lo + step] = np.take_along_axis(
                best_j, a[:, None], axis=1)[:, 0]
        if any_dead:
            a0, j0 = self.decide_dead(rtt_s, sla_s)
            a_out[dead] = a0
            j_out[dead] = j0
        return a_out, j_out

    def decide_dead(self, rtt_s: float, sla_s: float) -> tuple[int, int]:
        """Scalar ``decide`` at bandwidth == 0: every transfer column is
        unreachable (``latency_matrix`` makes them +inf), so the device-only
        column — the one with ``rtt_mask == 0`` — wins for every α row;
        α follows the usual first-feasible / global-argmin rule."""
        t = self.tables
        j = int(np.argmax(t.rtt_mask == 0.0))
        lat = t.dev_s[:, j] + t.cloud_s[:, j]
        feasible = lat <= sla_s
        if feasible.any():
            a = int(np.argmax(feasible))
        else:
            a = int(np.argmin(lat))
        return a, j


# ---------------------------------------------------------------------------
# bandwidth-estimate sequences (exact HarmonicMeanEstimator semantics)
# ---------------------------------------------------------------------------


def window_estimates(obs: np.ndarray, cold: np.ndarray) -> np.ndarray:
    """Estimate before each frame for streams observing ``obs`` row-wise in
    order (all values positive): bit-exact ``HarmonicMeanEstimator`` —
    left-to-right window sums over the last ≤5 inverse observations, cold
    start before the first."""
    n_streams, frames = obs.shape
    inv = 1.0 / obs
    est = np.empty_like(obs)
    est[:, 0] = cold
    p = None
    for k in range(1, min(_WINDOW, frames)):
        p = inv[:, 0].copy() if k == 1 else p + inv[:, k - 1]
        est[:, k] = k / p
    if frames > _WINDOW:
        w = inv[:, 0:frames - _WINDOW]
        for d in range(1, _WINDOW):
            w = w + inv[:, d:frames - _WINDOW + d]
        est[:, _WINDOW:] = float(_WINDOW) / w
    return est


def _est_exact(window: list[float], cold: float,
               obs_spec: list[float]) -> list[float]:
    """Scalar fallback/refill path: estimate before each speculated frame,
    replicating the estimator exactly (including skipping non-positive
    observations). ``window`` is the committed last ≤5 positive observations,
    oldest first; it is not mutated."""
    win = list(window)
    out = []
    for b in obs_spec:
        if win:
            s = 0.0
            for v in win:
                s += 1.0 / v
            out.append(len(win) / s)
        else:
            out.append(cold)
        if b > 0:
            win.append(b)
            if len(win) > _WINDOW:
                win.pop(0)
    return out


# ---------------------------------------------------------------------------
# per-stream decision pipelines
# ---------------------------------------------------------------------------


class _Pipe:
    """Precomputed decision pipeline for one stream (see module docstring).

    Entries are indexed by *planned order*: entry ``pos`` is the decision for
    the stream's next admitted frame and depends only on already-committed
    observations, so it survives admission drops; entries past it speculate
    that arrivals are admitted consecutively and are invalidated (``valid``
    truncated) when a drop shifts the observation sequence.
    """

    __slots__ = ("kind", "frames", "obs", "cold", "window", "arrived", "pos",
                 "valid", "chunk", "acct", "rtt", "sla", "acc_scale",
                 "bill_overhead", "ov",
                 "alpha", "split", "dev", "cloudp", "bits", "payload", "acc",
                 "const_dev_total", "const_cloud", "const_acc", "const_split",
                 "dead_row")

    def __init__(self, kind: int, frames: int, obs: list[float], cold: float,
                 acct: AcctTables, rtt: float, sla: float, acc_scale: float,
                 bill_overhead: bool):
        self.kind = kind
        self.frames = frames
        self.obs = obs             # trace value per frame index (plain floats)
        self.cold = cold
        self.window = []           # committed last ≤5 positive observations
        self.arrived = 0           # arrivals consumed (admitted + dropped)
        self.pos = 0
        self.valid = 0
        self.chunk = 16
        self.acct = acct
        self.rtt = rtt
        self.sla = sla
        self.acc_scale = acc_scale
        self.bill_overhead = bill_overhead
        self.ov = 0.0              # amortized per-decision overhead billed
        self.alpha = self.split = self.dev = self.cloudp = None
        self.bits = self.payload = self.acc = None
        self.const_dev_total = self.const_cloud = 0.0
        self.const_acc = 0.0
        self.const_split = 0
        self.dead_row = None

    # -- filling -------------------------------------------------------------
    def load_rows(self, a_idx: np.ndarray, j_idx: np.ndarray) -> None:
        """Install decisions (tables kind): resolve every per-frame quantity
        to plain-float lists so admission is scalar arithmetic."""
        t = self.acct
        self.alpha = t.alpha[a_idx].tolist()
        self.split = t.cand[j_idx].tolist()
        self.dev = t.dev[a_idx, j_idx].tolist()
        self.cloudp = t.cloud[a_idx, j_idx].tolist()
        self.bits = t.bits[a_idx, j_idx].tolist()
        self.payload = t.payload[a_idx, j_idx].tolist()
        self.acc = (t.acc[a_idx] * self.acc_scale).tolist()
        self.pos = 0
        self.valid = len(self.alpha)

    def load_mixed(self, splits: np.ndarray) -> None:
        self.split = splits.tolist()
        self.pos = 0
        self.valid = len(self.split)

    def _refill(self) -> None:
        t0 = time.perf_counter() if self.bill_overhead else 0.0
        # take() only runs for an admitted frame, so arrived < frames here
        count = min(self.chunk, self.frames - self.arrived)
        self.chunk = min(_CHUNK_MAX, self.chunk * 2)
        obs_spec = [self.obs[f]
                    for f in range(self.arrived, self.arrived + count)]
        est = np.asarray(_est_exact(self.window, self.cold, obs_spec))
        if self.kind == _TABLES:
            a_idx, j_idx = self.acct.decide_batch(est, self.rtt, self.sla)
            self.load_rows(a_idx, j_idx)
        else:  # mixed baseline: endpoint choice per estimate
            lat_c = (self.acct.raw8 / est + self.rtt) + self.const_cloud
            self.load_mixed(np.where(self.const_dev_total <= lat_c,
                                     self.acct.device_only_split, 0))
        if self.bill_overhead:
            self.ov = (time.perf_counter() - t0) / count

    # -- event hooks ---------------------------------------------------------
    def on_drop(self) -> None:
        """An arrival was rejected: it never observes, so every speculated
        entry past the next pending decision is stale. Constant-decision
        (device/cloud baseline) pipes never speculate, so nothing expires."""
        self.arrived += 1
        if self.kind != _CONST and self.valid > self.pos + 1:
            self.valid = self.pos + 1
            self.chunk = max(_CHUNK_MIN, self.chunk // 2)

    def current_estimate(self) -> float:
        """The committed harmonic-mean estimate the next decision sees —
        read-only (``take`` commits the observation *after* the decision),
        so this is bit-equal to the speculated batched estimate. Telemetry's
        decision log reads it; the hot path never calls it."""
        win = self.window
        if win:
            s = 0.0
            for v in win:
                s += 1.0 / v
            return len(win) / s
        return self.cold

    def take(self, fi: int):
        """Consume the next decision for admitted frame ``fi``. Returns
        ``(dev_s, comm_s, cloud_s, overhead_s, alpha, split, accuracy,
        payload_bytes, bandwidth_bps)``."""
        if self.pos >= self.valid:
            self._refill()
        k = self.pos
        self.pos = k + 1
        self.arrived += 1
        b = self.obs[fi]
        if b > 0:
            self.window.append(b)
            if len(self.window) > _WINDOW:
                self.window.pop(0)
        acct = self.acct
        if self.kind == _TABLES:
            split = self.split[k]
            if split == 0:
                comm = acct.raw8 / b + self.rtt
            elif split == acct.device_only_split:
                comm = 0.0
            else:
                comm = self.bits[k] / b + self.rtt
            return (self.dev[k], comm, self.cloudp[k], self.ov,
                    self.alpha[k], split, self.acc[k], self.payload[k], b)
        split = self.const_split if self.kind == _CONST else self.split[k]
        if split == 0:
            return (0.0, acct.raw8 / b + self.rtt, self.const_cloud, 0.0,
                    0.0, split, self.const_acc, 0.0, b)
        return (self.const_dev_total, 0.0, 0.0, 0.0,
                0.0, split, self.const_acc, 0.0, b)

    # -- dead-link path (fault injection) ------------------------------------
    def dead_decision(self) -> tuple[float, float, int, float]:
        """``(dev_s, alpha, split, accuracy)`` under zero bandwidth — the
        decision the scalar planner makes on a dead link (device-only, the
        only finite column of ``latency_matrix(0, ·)``). Cached per pipe."""
        if self.dead_row is None:
            acct = self.acct
            if self.kind == _TABLES:
                a, j = acct.decide_dead(self.rtt, self.sla)
                self.dead_row = (float(acct.dev[a, j]), float(acct.alpha[a]),
                                 int(acct.cand[j]),
                                 float(acct.acc[a]) * self.acc_scale)
            else:
                self.dead_row = (self.const_dev_total, 0.0,
                                 acct.device_only_split, self.const_acc)
        return self.dead_row

    def take_dead(self, fi: int):
        """Plan admitted frame ``fi`` under a network blackout. The observed
        bandwidth is 0 — skipped by the estimator, so the committed window
        and the next pending decision both survive — but speculated entries
        past the pending one assumed this frame committed ``obs[fi]``, so
        they expire exactly like a drop's. Same return shape as ``take``."""
        self.arrived += 1
        if self.kind != _CONST and self.valid > self.pos + 1:
            self.valid = self.pos + 1
            self.chunk = max(_CHUNK_MIN, self.chunk // 2)
        dev, alpha, split, acc = self.dead_decision()
        return (dev, 0.0, 0.0, 0.0, alpha, split, acc, 0.0, 0.0)


def _build_pipes(rt) -> list:
    """One pipeline per stream (or ``None`` for streams that must take the
    engine-planned slow path), with the initial decisions of every regular
    stream filled by one batched eval per (tables, rtt, SLA, policy) group."""
    acct_cache: dict[int, AcctTables] = {}
    pipes: list = []
    groups: dict[tuple, list[_Pipe]] = {}
    for si, spec in enumerate(rt.streams):
        eng = rt.engines[si]
        if spec.policy not in _POLICIES:
            raise ValueError(spec.policy)
        if spec.arrival_times is not None:
            ats = spec.arrival_times[:spec.n_frames]
            if any(b < a for a, b in zip(ats, ats[1:])):
                pipes.append(None)   # frames arrive out of index order
                continue
            frames = min(spec.n_frames, len(spec.arrival_times))
        else:
            frames = max(1, spec.n_frames)
        tables = eng.tables
        acct = acct_cache.get(id(tables))
        if acct is None:
            acct = acct_cache[id(tables)] = AcctTables(tables, eng.acc)
        bps = np.asarray(spec.trace.bps, dtype=np.float64)
        obs_arr = bps[np.arange(frames) % len(bps)]
        cold = float(np.mean(spec.trace.bps))
        rtt = float(spec.trace.rtt_s)
        sla = float(eng.cfg.sla_s)
        bill = bool(eng.cfg.include_scheduler_overhead)
        if spec.policy == "janus":
            kind = _TABLES
        elif spec.policy == "mixed":
            kind = _MIXED
        else:
            kind = _CONST
        # only tables (janus) decisions bill amortized overhead: the
        # reference path's baseline Decisions carry scheduler_overhead_s=0.0
        pipe = _Pipe(kind, frames, obs_arr.tolist(), cold, acct, rtt, sla,
                     float(eng.cfg.accuracy_scale),
                     bill and kind == _TABLES)
        if kind != _TABLES:
            # baseline constants (also used by the mixed refill path); built
            # through account_breakdown itself so the float order is the
            # engine's by construction
            fc = eng._fixed_counts
            n = acct.n
            pipe.const_dev_total = eng.account_breakdown(
                fc, n + 1, 0.0, 1.0, rtt).device_s
            pipe.const_cloud = eng.account_breakdown(
                fc, 0, 0.0, 1.0, rtt).cloud_s
            pipe.const_acc = eng.acc.accuracy(eng.profile.x0,
                                              eng._fixed_schedule) \
                * eng.cfg.accuracy_scale
            pipe.const_split = n + 1 if spec.policy == "device" else 0
        pipes.append(pipe)
        if kind == _CONST:
            pipe.valid = pipe.frames   # constant decision: never refills
            continue
        if frames == 0:
            continue   # empty arrival list: the stream never plans a frame
        if np.all(obs_arr > 0):
            groups.setdefault(
                (spec.region, id(tables), rtt, sla, spec.policy, frames),
                []).append(pipe)
        # else: non-positive trace values are skipped by the estimator —
        # leave the pipe empty so take() routes through the exact scalar
        # refill path

    for (_, _, rtt, sla, policy, frames), members in groups.items():
        t0 = time.perf_counter()
        obs2d = np.asarray([p.obs for p in members])
        est2d = window_estimates(obs2d, np.asarray([p.cold for p in members]))
        acct = members[0].acct
        if policy == "janus":
            a_idx, j_idx = acct.decide_batch(est2d.ravel(), rtt, sla)
            a_idx = a_idx.reshape(len(members), frames)
            j_idx = j_idx.reshape(len(members), frames)
            for i, p in enumerate(members):
                p.load_rows(a_idx[i], j_idx[i])
        else:  # mixed
            for i, p in enumerate(members):
                lat_c = (acct.raw8 / est2d[i] + rtt) + p.const_cloud
                p.load_mixed(np.where(p.const_dev_total <= lat_c,
                                      acct.device_only_split, 0))
        if members[0].bill_overhead:
            ov = (time.perf_counter() - t0) / (len(members) * frames)
            for p in members:
                p.ov = ov
    return pipes


# ---------------------------------------------------------------------------
# the simulation
# ---------------------------------------------------------------------------


def _merge_timelines(tls: list[list[tuple[float, int]]]) \
        -> list[tuple[float, int]]:
    """Merge per-region executor-count step functions into one fleet-total
    step function. A single region passes through untouched (the classic
    timeline, bit for bit)."""
    if len(tls) == 1:
        return list(tls[0])
    times = sorted({t for tl in tls for t, _ in tl})
    idx = [0] * len(tls)
    merged: list[tuple[float, int]] = []
    for t in times:
        for k, tl in enumerate(tls):
            while idx[k] + 1 < len(tl) and tl[idx[k] + 1][0] <= t:
                idx[k] += 1
        total = sum(tl[idx[k]][1] for k, tl in enumerate(tls))
        if not merged or merged[-1][1] != total:
            merged.append((t, total))
    return merged


def simulate(rt, images=None, record: list | None = None, telemetry=None):
    """Run ``rt`` (a ``fleet.FleetRuntime``) through the event-heap core and
    return its ``FleetStats``. ``record``, if given, collects every popped
    event as ``(time, kind, payload)`` — the determinism test asserts two
    seeded runs produce identical event sequences. ``telemetry``, if given,
    is a ``telemetry.Telemetry`` recorder whose hooks observe the heap loop
    (spans, windowed metrics, decision logs); every call site is guarded so
    ``telemetry=None`` runs today's exact instruction stream — the recorder
    must never change a simulated float (``tests/test_telemetry.py`` pins
    both directions)."""
    from repro_torch.serving.fleet import Autoscaler, FleetStats, RegionStats

    tel = telemetry

    streams, cloud = rt.streams, rt.cloud
    n_streams = len(streams)
    engine_mode = (rt._execute and images is not None) or \
        any(e.cfg.planner == "legacy" for e in rt.engines)
    pipes = [None] * n_streams if engine_mode else _build_pipes(rt)
    fm = None
    if getattr(rt, "faults", None) is not None:
        if engine_mode:
            raise ValueError(
                "fault injection requires the vectorized planner path "
                "(incompatible with execute-with-images and planner='legacy')")
        if any(p is None for p in pipes):
            raise ValueError(
                "fault injection requires in-order arrival times "
                "for every stream")
        fm = FaultManager(rt.faults, len(rt.regions), n_streams)
    estimators = [None] * n_streams
    for si, spec in enumerate(streams):
        if pipes[si] is None:
            estimators[si] = HarmonicMeanEstimator(
                cold_start_bps=float(np.mean(spec.trace.bps)))
    sla_eff = [e.cfg.sla_s for e in rt.engines]

    # -- per-stream mutable state (flat, O(1) access) ------------------------
    # results accumulate per stream in completion order (the retired loop's
    # order); each entry is the finished frame's scalar tuple, materialized
    # into FrameResult objects once at the end
    results: list[list[tuple]] = [[] for _ in streams]
    device_free = [0.0] * n_streams
    inflight = [0] * n_streams
    dropped = [0] * n_streams

    # per admitted frame: (si, fi, t0, dev_s, comm_s, cloud_s, overhead_s,
    # alpha, split, acc, payload, b_true); index = rid
    recs: list[tuple] = []
    exec_plans: list = []
    batch_sizes: list[int] = []

    # -- per-region cloud state (R == 1 is the classic shared tier) ----------
    n_regions = len(rt.regions)
    home_of = [s.region for s in streams]
    off = [reg.rtt_offset_s for reg in rt.regions]

    def _make_micro():
        if rt.priority:
            return PriorityMicroBatcher(cloud.max_batch, cloud.max_wait_s,
                                        classes=rt.sla_classes)
        return MicroBatcher(cloud.max_batch, cloud.max_wait_s)

    micros = [_make_micro() for _ in rt.regions]
    executors: list[list[float]] = [[] for _ in rt.regions]
    # busy-until heaps, each capped at its region's capacity
    scalers: list = []
    caps0: list[int] = []
    for reg in rt.regions:
        cfg = reg.autoscale or (rt.autoscaler.cfg if rt.autoscaler else None)
        sc = Autoscaler(cfg) if cfg is not None else None
        scalers.append(sc)
        caps0.append(sc.initial_capacity(reg.capacity) if sc
                     else reg.capacity)
    caps = list(caps0)
    busy = [0.0] * n_regions
    cloud_arrivals = [0] * n_regions
    offered = [0] * n_regions        # cloud-bound frames homed per region
    spilled = [0] * n_regions        # of those, routed to another region
    served = [0] * n_regions         # frames each region's executors ran
    region_batches = [0] * n_regions
    service_intervals: list[list[tuple[float, float]]] = \
        [[] for _ in rt.regions]
    cap_timelines: list[list[tuple[float, int]]] = \
        [[(0.0, c)] for c in caps0]
    if tel is not None:
        tel.bind(region_names=[reg.name for reg in rt.regions], caps=caps0,
                 stream_regions=home_of,
                 stream_classes=[s.sla_class for s in streams])
        # hot-path hooks bound once (the guarded call sites below pay one
        # identity check + one call, no attribute chase, per frame)
        tel_planned, tel_enqueued = tel.frame_planned, tel.enqueued
        tel_finished, tel_dispatched = tel.frame_finished, \
            tel.batch_dispatched
        tel_sampled, tel_fsamp, tel_dec = tel.sampling()
        # per-frame exact counters push bare scalars into flat arrays
        # (bucketed vectorized at finalize) — the cheapest possible
        # hot-path hook, and allocation-free so GC cadence stays put
        tel_fin, tel_off, tel_enq = tel.sinks()
    else:
        tel_planned = tel_sampled = tel_enqueued = None
        tel_finished = tel_dispatched = None
        tel_fin = tel_off = tel_enq = None
        tel_fsamp, tel_dec = 1, False
    seq = itertools.count()
    events: list = []                # (time, seq, kind, payload)
    state = {"horizon": 0.0,
             "remaining": sum(
                 s.n_frames if s.arrival_times is None
                 else min(s.n_frames, len(s.arrival_times))
                 for s in streams)}

    def push(t: float, kind: int, payload) -> None:
        heapq.heappush(events, (t, next(seq), kind, payload))

    def arrive(si: int, fi: int, t0: float) -> None:
        spec = streams[si]
        if spec.max_inflight and inflight[si] >= spec.max_inflight:
            dropped[si] += 1
            state["remaining"] -= 1
            if pipes[si] is not None:
                pipes[si].on_drop()
            if tel is not None:
                tel.frame_dropped(si, t0)
            return
        inflight[si] += 1
        plan_frame(si, fi, t0)

    def plan_frame(si: int, fi: int, t0: float) -> None:
        pipe = pipes[si]
        est_pre = None
        if tel_dec and tel_sampled[si] and fi % tel_fsamp == 0:
            # the committed estimate the decision is about to use, read
            # before take() commits this frame's observation
            est_pre = pipe.current_estimate() if pipe is not None \
                else estimators[si].estimate()
        if pipe is not None:
            if fm is not None and fm.blacked_out(si, t0):
                (dev_s, comm_s, cloud_s, ov, alpha, split, acc, payload,
                 b_true) = pipe.take_dead(fi)
                if est_pre is not None:
                    est_pre = 0.0   # dead link: the planner saw 0 bandwidth
            else:
                (dev_s, comm_s, cloud_s, ov, alpha, split, acc, payload,
                 b_true) = pipe.take(fi)
            plan = None
        else:
            eng, spec = rt.engines[si], streams[si]
            step = eng.plan_frame(fi, spec.trace, spec.policy,
                                  estimators[si], images=images,
                                  defer_cloud=True)
            estimators[si].observe(step.bandwidth_bps)
            bd = step.breakdown
            dev_s, comm_s, cloud_s = bd.device_s, bd.comm_s, bd.cloud_s
            ov = eng.overhead_s(step)
            alpha, split = step.decision.alpha, step.decision.split
            acc, payload = step.accuracy, step.payload_bytes
            b_true, plan = step.bandwidth_bps, step.exec_plan
        dev_start = max(t0, device_free[si])
        device_free[si] = dev_start + ov + dev_s
        local_done = device_free[si] + comm_s
        rid = len(recs)
        recs.append((si, fi, t0, dev_s, comm_s, cloud_s, ov, alpha, split,
                     acc, payload, b_true))
        if engine_mode:
            exec_plans.append(plan)
        if tel_planned is not None and tel_sampled[si] \
                and fi % tel_fsamp == 0:
            tel_planned(si, fi, t0, dev_start, ov, dev_s, comm_s,
                        alpha, split)
            if est_pre is not None:
                tel.log_decision(
                    si, fi, t0, home_of[si], alpha, split, est_pre,
                    sla_eff[si] - (dev_start - t0 + ov + dev_s + comm_s
                                   + cloud_s),
                    pipe.acct if pipe is not None
                    and pipe.kind == _TABLES else None,
                    pipe.rtt if pipe is not None
                    else float(streams[si].trace.rtt_s))
        if cloud_s <= 0.0:            # device-only: never touches the cloud
            push(local_done, FINISH, rid if fm is None else (rid, -1))
        else:
            push(local_done, OFFER, rid)

    def queue_delay(r: int, now: float) -> float:
        """Routing estimate: how long a batch dispatched to region ``r`` now
        would wait for an executor. Read-only on the busy-until heap (the
        lazy slot retirement stays in dispatch)."""
        ex = executors[r]
        if len(ex) < caps[r] or (ex and ex[0] <= now):
            return 0.0
        # caps can be 0 (outage) with an already-cleared heap; an empty heap
        # reads as no wait — the routing policy discovers a dark cell by
        # losing to it, never by peeking at ground truth
        return ex[0] - now if ex else 0.0

    def offer(rid: int, now: float) -> None:
        rec = recs[rid]
        home = home_of[rec[0]]
        offered[home] += 1
        if tel_off is not None:
            tel_off(home)
            tel_off(now)
        if fm is not None:
            route(rid, home, now, retry=False)
            return
        if n_regions > 1 and queue_delay(home, now) > rt.spill_slack_s:
            # spillover: cheapest cell by estimated wait + extra distance;
            # ties keep the frame home (strict < below)
            best, best_cost = home, queue_delay(home, now)
            for r in range(n_regions):
                if r == home:
                    continue
                cost = queue_delay(r, now) + max(0.0, off[r] - off[home])
                if cost < best_cost:
                    best, best_cost = r, cost
            if best != home:
                spilled[home] += 1
                if tel is not None:
                    tel.spilled(home, now)
                delta = max(0.0, off[best] - off[home])
                if delta > 0.0:
                    # the detour's extra round-trip precedes batcher entry
                    if tel is not None:
                        tel.enqueue_delay(rid, rec[0], rec[1], now, delta)
                    push(now + delta, ENQUEUE, (rid, best))
                    return
                enqueue(rid, best, now)
                return
        enqueue(rid, home, now)

    def route(rid: int, home: int, now: float, retry: bool) -> None:
        """Fault-aware routing: the spillover policy filtered through the
        circuit breakers. Only *observable* state is consulted — breaker
        position and queue estimates — never ``fm.down`` ground truth. No
        admittable cell at all means graceful degradation to device-only."""
        home_ok = fm.admits(home, now)
        if home_ok and (n_regions == 1
                        or queue_delay(home, now) <= rt.spill_slack_s):
            target = home
        else:
            if home_ok:
                target, best_cost = home, queue_delay(home, now)
            else:
                target, best_cost = None, float("inf")
            for r in range(n_regions):
                if r == home or not fm.admits(r, now):
                    continue
                cost = queue_delay(r, now) + max(0.0, off[r] - off[home])
                if cost < best_cost:
                    target, best_cost = r, cost
        if target is None:
            degrade(rid, now)
            return
        if target != home and not retry:
            spilled[home] += 1
            if tel is not None:
                tel.spilled(home, now)
        fm.note_route(rid, target, now)
        if tel is not None:
            br = fm.breakers[target]
            if br is not None:   # note_route may have probed open→half_open
                tel.breaker_state(target, now, br.state)
        delta = max(0.0, off[target] - off[home])
        if retry:
            delta += recs[rid][4]     # the resend pays the uplink again
        if delta > 0.0:
            if tel is not None:
                tel.enqueue_delay(rid, recs[rid][0], recs[rid][1], now,
                                  delta)
            push(now + delta, ENQUEUE, (rid, target))
        else:
            enqueue(rid, target, now)

    def enqueue(rid: int, r: int, now: float) -> None:
        if fm is not None and fm.down[r]:
            # the cell is dark: the frame dies in transport/queue. Observed
            # by the caller only through the loss (breaker bookkeeping).
            fm.lost_pending[r] += 1
            on_loss(rid, now)
            return
        cloud_arrivals[r] += 1
        rec = recs[rid]
        si = rec[0]
        micro = micros[r]
        req = Request(rid, arrival_s=now, sla_class=streams[si].sla_class,
                      deadline_s=rec[2] + sla_eff[si])
        if tel_enq is not None:
            # depth includes this frame (offer below may flush the batch)
            depth = micro.pending_count + 1
            tel_enq(r)
            tel_enq(now)
            tel_enq(depth)
            if tel_sampled[si] and rec[1] % tel_fsamp == 0:
                tel_enqueued(rid, si, rec[1], r, now, depth)
        batch = micro.offer(req, now)
        if batch is not None:
            dispatch(r, batch, now)
        elif rt.priority:
            # class windows can pull the flush earlier on every offer
            push(max(micro.deadline(), now), POLL, r)
        elif micro.pending_count == 1:
            # FIFO: one expiry timer per batch (deadline never moves)
            push(micro.deadline(), POLL, r)

    def poll(r: int, now: float) -> None:
        if fm is not None and fm.down[r]:
            return          # queue already drained at outage start
        batch = micros[r].poll(now)
        if batch is not None:
            dispatch(r, batch, now)

    def dispatch(r: int, batch: list[Request], now: float) -> None:
        members = [req.rid for req in batch]
        if rt._execute and engine_mode:
            run_cloud_batch(rt.plan_cache, rt.model_cfg, rt.params,
                            [exec_plans[rid] for rid in members],
                            buckets=rt.buckets)
        service = max(recs[rid][5] for rid in members) \
            * (1.0 + cloud.batch_growth * (len(batch) - 1))
        ex, scaler = executors[r], scalers[r]
        while len(ex) > caps[r] and ex[0] <= now:
            heapq.heappop(ex)
        if len(ex) < caps[r]:
            start = now
        else:
            start = max(now, heapq.heappop(ex))
        heapq.heappush(ex, start + service)
        busy[r] += service
        if scaler is not None:
            if scaler.cfg.policy != "predictive":
                service_intervals[r].append((start, start + service))
            scaler.observe_service(service / len(batch))
        batch_sizes.append(len(batch))
        region_batches[r] += 1
        served[r] += len(batch)
        done = start + service
        if tel_dispatched is not None:
            tel_dispatched(r, start, service, members)
        if fm is not None:
            # FINISH carries (rid, batch-token): a later kill voids the
            # token, so stale completions of dead batches are discarded even
            # after the rid is re-dispatched under a fresh token
            bid = next(fm.bid_seq)
            fm.live[r][bid] = done
            fm.batch_members[bid] = members
            for rid in members:
                fm.batch_of[rid] = bid
                push(done, FINISH, (rid, bid))
        else:
            for rid in members:
                push(done, FINISH, rid)

    def finish(rid: int, tf: float, token: int = -1) -> None:
        (si, fi, t0, dev_s, comm_s, cloud_s, ov, alpha, split, acc, payload,
         b_true) = recs[rid]
        if fm is not None:
            if token >= 0:
                if token in fm.dead_batches:
                    return      # stale completion of a killed batch
                fm.batch_of.pop(rid, None)
                r = fm.pending_region.pop(rid)
                fm.live[r].pop(token, None)
                br = fm.breakers[r]
                if br is not None:
                    br.record_success(tf)
                    if tel is not None:
                        tel.breaker_state(r, tf, br.state)
                t_up = fm.awaiting_recovery[r]
                if t_up is not None and tf >= t_up:
                    # first cloud completion after the cell came back
                    fm.recovery_times[r].append(tf - t_up)
                    fm.awaiting_recovery[r] = None
            else:
                fm.pending_region.pop(rid, None)
            o = fm.override.pop(rid, None)
            if o is not None:   # degraded: report the device-only rerun
                dev_s, comm_s, cloud_s, alpha, split, acc = o
                degraded = True
            else:
                degraded = False
        else:
            degraded = False
        total_s = dev_s + comm_s + cloud_s
        standalone = total_s + ov
        queue_s = tf - t0 - standalone
        if queue_s < 1e-12:
            queue_s = 0.0
        lat = total_s + ov + queue_s
        sla = sla_eff[si]
        lg = exec_plans[rid].logits \
            if engine_mode and exec_plans[rid] is not None else None
        results[si].append(
            (lat, lat > sla, max(0.0, (lat - sla) / sla) if sla else 0.0,
             alpha, split, acc, payload, b_true, queue_s, lg))
        state["horizon"] = max(state["horizon"], tf)
        state["remaining"] -= 1
        inflight[si] -= 1
        if fm is not None:
            fm.note_frame(home_of[si], si, t0, tf, lat > sla)
        if tel_fin is not None:
            violated = lat > sla
            tel_fin(si)
            tel_fin(tf)
            tel_fin(lat)
            tel_fin(violated)
            if tel_sampled[si] and fi % tel_fsamp == 0:
                tel_finished(si, fi, rid, t0, tf, lat, violated, queue_s,
                             alpha, split, degraded)
        spec = streams[si]
        if spec.arrival_times is None and fi + 1 < spec.n_frames:
            arrive(si, fi + 1, max(tf, t0 + spec.period_s))

    def set_capacity(r: int, newc: int, now: float) -> None:
        if newc == caps[r]:
            return
        ex = executors[r]
        while len(ex) > newc and ex[0] <= now:
            heapq.heappop(ex)
        caps[r] = newc
        cap_timelines[r].append((now, newc))
        if tel is not None:
            tel.capacity_changed(r, now, newc)

    def control(r: int, now: float) -> None:
        scaler = scalers[r]
        window = scaler.cfg.interval_s
        if fm is not None and fm.down[r]:
            # capacity is pinned at 0 for the outage; the scaler must not
            # resurrect a dark cell, so skip the decision but keep the timer
            if state["remaining"] > 0:
                push(now + window, CONTROL, r)
            return
        if scaler.cfg.policy == "predictive":
            scaler.observe_rate(cloud_arrivals[r], window)
            cloud_arrivals[r] = 0
            backlog = sum(max(0.0, e - now) for e in executors[r])
            backlog += micros[r].pending_count \
                * (scaler.ewma_service_s or 0.0)
            newc = scaler.decide_predictive(now, backlog, caps[r])
        else:
            w0, busy_w, keep = now - window, 0.0, []
            for s, e in service_intervals[r]:
                busy_w += max(0.0, min(e, now) - max(s, w0))
                if e > now:
                    keep.append((s, e))
            service_intervals[r][:] = keep
            util = busy_w / (caps[r] * window)
            newc = scaler.decide(now, util, caps[r])
        if tel is not None and newc != caps[r]:
            tel.autoscale(r, now, caps[r], newc)
        set_capacity(r, newc, now)
        if state["remaining"] > 0:
            push(now + window, CONTROL, r)

    # -- failure recovery (all closures below only run when fm is set) -------
    def on_loss(rid: int, now: float) -> None:
        """A cloud offer died (dark cell, killed batch). Charge the breaker
        of the region it was pending on, then retry with backoff while the
        budget lasts; after that, degrade to device-only."""
        r = fm.pending_region.pop(rid, None)
        if r is not None:
            br = fm.breakers[r]
            if br is not None:
                br.record_failure(now)
                if tel is not None:
                    tel.breaker_state(r, now, br.state)
        if tel is not None:
            tel.offer_lost(rid, recs[rid][0], r, now)
        attempts = fm.attempts.get(rid, 0) + 1
        fm.attempts[rid] = attempts
        if attempts <= fm.retry.max_retries:
            home = home_of[recs[rid][0]]
            fm.retries[home] += 1
            backoff = fm.retry.backoff_s(attempts)
            if tel is not None:
                tel.retry_scheduled(rid, recs[rid][0], recs[rid][1], home,
                                    now, backoff, attempts)
            push(now + backoff, RETRY, rid)
        else:
            degrade(rid, now)

    def replan_keeps_cloud(si: int, rid: int, now: float) -> bool:
        """Re-plan the frame against the current committed estimate and the
        SLA slack it has left: is offloading still the right call? (The
        resend reuses the original payload; this is the go/no-go check.)"""
        pipe = pipes[si]
        sla_rem = max(0.0, recs[rid][2] + sla_eff[si] - now)
        if pipe.kind == _CONST:
            return pipe.const_split == 0    # cloud baseline never re-plans
        win = pipe.window
        if win:
            s = 0.0
            for v in win:
                s += 1.0 / v
            est = len(win) / s
        else:
            est = pipe.cold
        if est <= 0.0:
            return False
        acct = pipe.acct
        if pipe.kind == _MIXED:
            lat_c = (acct.raw8 / est + pipe.rtt) + pipe.const_cloud
            return lat_c < pipe.const_dev_total
        _, j = acct.decide_batch(np.asarray([est]), pipe.rtt, sla_rem)
        return int(acct.cand[j[0]]) != acct.device_only_split

    def retry_frame(rid: int, now: float) -> None:
        si = recs[rid][0]
        if fm.blacked_out(si, now) or not replan_keeps_cloud(si, rid, now):
            degrade(rid, now)
            return
        route(rid, home_of[si], now, retry=True)

    def degrade(rid: int, now: float) -> None:
        """Graceful degradation: rerun the frame device-only, serialized on
        its stream's device like any other device phase."""
        si = recs[rid][0]
        fm.degraded[home_of[si]] += 1
        dev_s, alpha, split, acc = pipes[si].dead_decision()
        fm.override[rid] = (dev_s, 0.0, 0.0, alpha, split, acc)
        fm.pending_region.pop(rid, None)
        start = max(now, device_free[si])
        device_free[si] = start + dev_s
        if tel is not None:
            tel.degraded_run(rid, si, recs[rid][1], home_of[si], start,
                             dev_s)
        push(device_free[si], FINISH, (rid, -1))

    def kill_batch(r: int, bid: int, now: float) -> None:
        done = fm.live[r].pop(bid)
        fm.dead_batches.add(bid)
        members = fm.batch_members.pop(bid)
        served[r] -= len(members)
        busy[r] -= max(0.0, done - now)   # the executor stopped burning time
        fm.lost_inflight[r] += len(members)
        if tel is not None:
            tel.batch_killed(r, now, len(members))
        for rid in members:
            fm.batch_of.pop(rid, None)
            on_loss(rid, now)

    def fault_event(idx: int, phase: int, now: float) -> None:
        ep = rt.faults.episodes[idx]
        r = ep.region
        if ep.kind == "executor_crash":
            live = [(done, bid) for bid, done in fm.live[r].items()
                    if done > now]
            if not live:
                return
            done, bid = min(live)
            if tel is not None:
                tel.executor_crash(r, now)
            kill_batch(r, bid, now)
            ex = executors[r]
            if done in ex:              # free the dead batch's slot
                ex.remove(done)
                heapq.heapify(ex)
            return
        # region outage boundaries
        if phase == 0:
            if fm.down[r]:
                return                  # overlapping windows: already dark
            fm.down[r] = True
            if tel is not None:
                tel.outage_started(r, now)
            fm.outages[r] += 1
            fm.outage_s[r] += ep.duration_s
            fm.saved_cap[r] = caps[r]
            fm.awaiting_recovery[r] = None
            for bid, done in list(fm.live[r].items()):
                if done <= now:
                    fm.live[r].pop(bid)     # completed before the outage
                else:
                    kill_batch(r, bid, now)
            executors[r].clear()
            for req in micros[r].flush():   # queued frames die with the cell
                fm.lost_pending[r] += 1
                on_loss(req.rid, now)
            caps[r] = 0
            cap_timelines[r].append((now, 0))
            if tel is not None:
                tel.capacity_changed(r, now, 0)
        else:
            fm.down[r] = False
            caps[r] = fm.saved_cap[r]
            cap_timelines[r].append((now, caps[r]))
            fm.awaiting_recovery[r] = now
            if tel is not None:
                tel.outage_ended(r, now)
                tel.capacity_changed(r, now, caps[r])

    for si, spec in enumerate(streams):
        if spec.arrival_times is None:
            arrive(si, 0, 0.0)
        else:
            for fi, ta in enumerate(spec.arrival_times[:spec.n_frames]):
                push(float(ta), ARRIVE, (si, fi))
    for r, scaler in enumerate(scalers):
        if scaler is not None:
            push(scaler.cfg.interval_s, CONTROL, r)
    if fm is not None:
        for i, ep in enumerate(rt.faults.episodes):
            if ep.kind == "region_outage":
                push(ep.start_s, FAULT, (i, 0))
                push(ep.end_s, FAULT, (i, 1))
            elif ep.kind == "executor_crash":
                push(ep.start_s, FAULT, (i, 0))
            # blackouts are plan-time lookups: no heap events needed

    while True:
        while events:
            t, _, kind, payload = heapq.heappop(events)
            if record is not None:
                record.append((t, EVENT_NAMES[kind], payload))
            if kind == FINISH:
                if fm is None:
                    finish(payload, t)
                else:
                    finish(payload[0], t, payload[1])
            elif kind == OFFER:
                offer(payload, t)
            elif kind == ARRIVE:
                arrive(payload[0], payload[1], t)
            elif kind == POLL:
                poll(payload, t)
            elif kind == ENQUEUE:
                enqueue(payload[0], payload[1], t)
            elif kind == FAULT:
                fault_event(payload[0], payload[1], t)
            elif kind == RETRY:
                retry_frame(payload, t)
            else:
                control(payload, t)
        pending = [r for r in range(n_regions) if micros[r].pending_count]
        if not pending:               # defensive: a timer covers every batch
            break
        for r in pending:
            dispatch(r, micros[r].flush(), state["horizon"])

    if tel is not None:
        tel.finalize(state["horizon"])
    per_stream = [RunStats([
        FrameResult(latency_s=float(lat), violated=bool(vio),
                    deviation=float(dev), alpha=float(alpha), split=int(spl),
                    accuracy=float(acc), payload_bytes=float(pay),
                    bandwidth_bps=float(bw), queue_s=float(q), logits=lg)
        for lat, vio, dev, alpha, spl, acc, pay, bw, q, lg in rows])
        for rows in results]
    per_region = [
        RegionStats(name=reg.name, rtt_offset_s=reg.rtt_offset_s,
                    capacity=caps0[r], busy_s=busy[r],
                    horizon_s=state["horizon"],
                    capacity_timeline=list(cap_timelines[r]),
                    offered=offered[r], spilled_out=spilled[r],
                    served=served[r], batches=region_batches[r])
        for r, reg in enumerate(rt.regions)]
    recovery = fm.region_stats([reg.name for reg in rt.regions],
                               state["horizon"]) if fm is not None else []
    return FleetStats(per_stream=per_stream,
                      cloud_busy_s=sum(busy),
                      horizon_s=state["horizon"],
                      capacity=sum(caps0),
                      batch_sizes=batch_sizes,
                      dropped_per_stream=dropped,
                      capacity_timeline=_merge_timelines(cap_timelines),
                      stream_classes=[s.sla_class for s in streams],
                      per_region=per_region,
                      stream_regions=list(home_of),
                      recovery=recovery)
