"""Serving-tier request batching + KV-slot management.
Port of ``repro.serving.batcher`` (pure Python, copied unchanged).

* ``KVSlotManager`` — fixed-capacity decode slots (the cache's batch dim);
  allocate on admission, free on completion. Static shapes: the decode step is
  compiled once for the full slot count; empty slots run padding tokens.
* ``ContinuousBatcher`` — vLLM-style continuous batching: new requests join the
  running batch at any decode step (no stop-the-world refill). For the Janus
  ViT tier, ``MicroBatcher`` groups frame requests within a deadline window so
  the engine amortizes per-invocation overhead without violating the SLA.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Mapping

from repro_torch.serving.sla import (DEFAULT_CLASS, DEFAULT_SLA_CLASSES, SlaClass,
                               resolve_sla_class)


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_len: int = 0
    max_new: int = 16
    generated: int = 0
    slot: int | None = None
    done_s: float | None = None
    # -- SLA-class metadata (used by PriorityMicroBatcher; the FIFO
    #    MicroBatcher ignores both, so defaults keep legacy callers intact) --
    sla_class: str = DEFAULT_CLASS
    deadline_s: float = math.inf   # absolute SLA deadline (slack tie-break)


class KVSlotManager:
    def __init__(self, n_slots: int):
        self.free = list(range(n_slots))
        heapq.heapify(self.free)
        self.n_slots = n_slots

    def alloc(self) -> int | None:
        return heapq.heappop(self.free) if self.free else None

    def release(self, slot: int):
        heapq.heappush(self.free, slot)

    @property
    def in_use(self) -> int:
        return self.n_slots - len(self.free)


class ContinuousBatcher:
    """Drives decode steps over a request stream; slots refill every step."""

    def __init__(self, n_slots: int, step_time_fn: Callable[[int], float]):
        self.slots = KVSlotManager(n_slots)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.step_time_fn = step_time_fn  # active_count -> seconds
        self.now = 0.0
        self.completed: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and self.queue[0].arrival_s <= self.now:
            slot = self.slots.alloc()
            if slot is None:
                break
            req = self.queue.popleft()
            req.slot = slot
            self.active[slot] = req

    def step(self):
        """One decode step across all active slots.

        When no slot is active the clock jumps to the next queued arrival
        instead of billing an idle gap as a decode step — otherwise low-load
        gaps distort completion times and burn ``max_steps``.
        """
        self._admit()
        if not self.active:
            if not self.queue:
                return
            self.now = max(self.now, self.queue[0].arrival_s)
            self._admit()
        self.now += self.step_time_fn(len(self.active))
        finished = []
        for slot, req in list(self.active.items()):
            req.generated += 1
            if req.generated >= req.max_new:
                req.done_s = self.now
                finished.append(slot)
        for slot in finished:
            self.completed.append(self.active.pop(slot))
            self.slots.release(slot)

    def run(self, until_empty: bool = True, max_steps: int = 100000):
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed


class MicroBatcher:
    """Deadline-aware frame batching for the Janus ViT tier: hold frames up to
    ``max_wait_s`` or ``max_batch``, whichever first."""

    def __init__(self, max_batch: int, max_wait_s: float):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pending: list[Request] = []

    @property
    def pending_count(self) -> int:
        """Number of pending requests (O(1); the event-heap fleet core polls
        this every control tick, where building ``pending`` would allocate)."""
        return len(self.pending)

    def offer(self, req: Request, now: float) -> list[Request] | None:
        self.pending.append(req)
        if len(self.pending) >= self.max_batch:
            out, self.pending = self.pending, []
            return out
        return self.poll(now)

    def poll(self, now: float) -> list[Request] | None:
        """Expire the pending batch once the oldest frame's deadline passes.

        ``offer`` alone only checks the deadline when a *new* frame arrives, so
        under low load a pending batch would go stale indefinitely. The serving
        loop must call ``poll`` at (or schedule a timer for) ``deadline()``.

        The comparison is phrased as ``now >= arrival + max_wait`` — the exact
        expression ``deadline()`` returns — so a timer that fires at the
        deadline always flushes (``now - arrival >= max_wait`` can round the
        other way in floating point and strand the batch).
        """
        if self.pending and now >= self.pending[0].arrival_s + self.max_wait_s:
            out, self.pending = self.pending, []
            return out
        return None

    def deadline(self) -> float | None:
        """Absolute time by which the current pending batch must flush, or
        ``None`` when nothing is pending."""
        if not self.pending:
            return None
        return self.pending[0].arrival_s + self.max_wait_s

    def flush(self) -> list[Request]:
        out, self.pending = self.pending, []
        return out


@dataclasses.dataclass
class _Lane:
    """One pending request with its admission bookkeeping."""
    req: Request
    seq: int                # arrival order (deterministic tie-break)
    rank: int               # class priority at admission
    wait_deadline_s: float  # latest flush time (per-class deadline window)


class PriorityMicroBatcher:
    """Deadline-aware, class-prioritized micro-batching (Clockwork-style).

    Same contract as ``MicroBatcher`` (``offer`` / ``poll`` / ``deadline`` /
    ``flush``; the serving loop arms a timer at ``deadline()``), but admission
    into a flushed batch is ordered by

        (class priority - aging, absolute SLA deadline, arrival seq)

    instead of FIFO:

    * **per-class deadline windows** — a pending frame of class ``c`` must
      flush by ``arrival + max_wait_s * c.wait_multiplier``; ``deadline()``
      is the minimum over pending frames, so an interactive arrival *pulls
      the flush forward* past longer-waiting batch traffic.
    * **preemptive lane draining** — an urgent expiry preemptively drains
      the batcher: the expired lane leads the admission order and every
      lower lane rides along in the same flush. The flush is deliberately
      *work-conserving* rather than lane-exclusive: batched execution is
      sub-linear (a B-frame batch costs far less than B singles), so
      holding lower lanes back would shrink batches, waste executor
      throughput, and — measured on the fleet benchmark — raise even the
      interactive class's violation ratio. The urgent class's win comes
      from the earlier flush time, not from excluding batch traffic.
    * **anti-starvation aging** — admission order uses an effective
      priority that improves by one rank per ``aging_s`` waited, so a
      long-waiting batch frame outranks fresh interactive frames after
      ``rank_gap * aging_s`` — and because every flush admits in this order
      and a frame's own class window arms a timer for it, the window is a
      hard upper bound on how long any frame can sit pending at all.

    Scope note: the admission *order* is this batcher's contract for
    consumers that serve a flushed batch sequentially. The fleet runtime
    executes a micro-batch as one stacked forward (members complete
    together), so there the measured priority-vs-FIFO win comes from the
    per-class windows moving the flush time, not from intra-batch order.

    With a single class (uniform rank and ``wait_multiplier == 1``) every
    ordering key collapses to arrival order and the flush conditions are
    exactly ``MicroBatcher``'s — the FIFO-equivalence regression test pins
    fleet results bit-exact in that case.
    """

    def __init__(self, max_batch: int, max_wait_s: float,
                 classes: Mapping[str, SlaClass] | None = None,
                 aging_s: float | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.classes = dict(classes) if classes is not None \
            else dict(DEFAULT_SLA_CLASSES)
        # default aging: one rank per 100 deadline windows — loose enough to
        # never reorder a healthy queue, tight enough to bound starvation
        self.aging_s = aging_s if aging_s is not None \
            else max(100.0 * max_wait_s, 1e-9)
        if self.aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {self.aging_s}")
        self._pending: list[_Lane] = []
        self._seq = 0

    # -- introspection (mirrors MicroBatcher.pending) ------------------------
    @property
    def pending(self) -> list[Request]:
        return [p.req for p in self._pending]

    @property
    def pending_count(self) -> int:
        """O(1) pending size — unlike ``pending``, no list materialization."""
        return len(self._pending)

    def _key(self, p: _Lane, now: float):
        aged = p.rank - int((now - p.req.arrival_s) / self.aging_s)
        return (aged, p.req.deadline_s, p.seq)

    def offer(self, req: Request, now: float) -> list[Request] | None:
        cls = resolve_sla_class(req.sla_class, self.classes)
        self._pending.append(_Lane(
            req=req, seq=self._seq, rank=cls.priority,
            wait_deadline_s=req.arrival_s
            + self.max_wait_s * cls.wait_multiplier))
        self._seq += 1
        if len(self._pending) >= self.max_batch:
            return self._select(now)   # size flush: every lane eligible
        return self.poll(now)

    def poll(self, now: float) -> list[Request] | None:
        """Flush once any pending frame's class window has expired. Phrased
        ``now >= deadline()`` exactly (see MicroBatcher.poll on why)."""
        d = self.deadline()
        if d is not None and now >= d:
            return self._select(now)
        return None

    def deadline(self) -> float | None:
        """Earliest per-class flush deadline over pending frames — unlike the
        FIFO batcher this can move *earlier* when an urgent class joins, so
        the serving loop must re-arm its timer after every offer."""
        if not self._pending:
            return None
        return min(p.wait_deadline_s for p in self._pending)

    def _select(self, now: float) -> list[Request]:
        """Drain the pending set in effective-priority order. ``offer``
        size-flushes at exactly ``max_batch`` pending, so a flush always
        drains everything; the ``[:max_batch]`` slice is a defensive cap,
        not a remainder mechanism."""
        order = sorted(self._pending, key=lambda p: self._key(p, now))
        take = order[:self.max_batch]
        taken = {p.seq for p in take}
        self._pending = [p for p in self._pending if p.seq not in taken]
        return [p.req for p in take]

    def flush(self) -> list[Request]:
        """Unconditional drain (end-of-run): priority order, no batch cap."""
        out = sorted(self._pending, key=lambda p: (p.rank, p.seq))
        self._pending = []
        return [p.req for p in out]
