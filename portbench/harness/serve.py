"""The entry the window drives: the Janus cloud tier for offloaded frames,
as the port's fleet runs it. Frames wait in ``serving.batcher.MicroBatcher``
on the wall clock; each flushed micro-batch is embedded with one
``CompiledPlanCache.device_fn`` call per distinct schedule on its stacked
images, then every frame's ``engine.ExecPlan`` goes to
``engine.run_cloud_batch`` (no bucket table, the fleet's default). A frame is
done when its logits are on the host.

Spans and counters are the harness's own, taken around the calls into the
program: the time of each ``run_cloud_batch`` call closed by a synchronize,
and the change in the plan cache's lookups across it.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from harness.traffic import Frame, Source


def _phase(name: str, traced: bool):
    return torch.profiler.record_function(f"portbench.{name}") if traced \
        else contextlib.nullcontext()


class CloudTier:
    def __init__(self, vit_cfg, params: dict, pool: torch.Tensor, traffic: dict):
        from repro_torch.core import engine
        self.engine = engine
        self.vit_cfg = vit_cfg
        self.params = params
        self.pool = pool
        self.schedules = [tuple(int(r) for r in k["schedule"]) for k in traffic["mix"]]
        self.cache = engine.CompiledPlanCache()
        self.traced = False
        self.reset_log()

    def reset_log(self) -> None:
        self.cloud_batch_s: list[float] = []
        self.forwards: list[int] = []
        self.groups: list[tuple[int, int]] = []   # (kind, frames) of each stacked forward

    def dispatch(self, frames: list[Frame]) -> dict[int, np.ndarray]:
        """Run one micro-batch; returns each frame's logits (f32, host) by
        frame id. A frame whose logits never came is absent."""
        engine, dev = self.engine, self.pool.device
        by_kind: dict[int, list[Frame]] = collections.defaultdict(list)
        for f in frames:
            by_kind[f.kind].append(f)
        plans, members = [], []
        for kind, group in by_kind.items():
            sched = self.schedules[kind]
            with _phase("frames", self.traced):
                idx = torch.tensor([f.image for f in group], dtype=torch.long, device=dev)
                images = self.pool.index_select(0, idx)
            with _phase("embed", self.traced):
                x, sizes = self.cache.device_fn(self.vit_cfg, sched, 0, images)(
                    self.params, images)
            plans += [engine.ExecPlan(sched, 0, x=x[i:i + 1], sizes=sizes[i:i + 1])
                      for i in range(len(group))]
            members += group
            self.groups.append((kind, len(group)))
        lookups = self.cache.hits + self.cache.misses
        t = time.perf_counter()
        with _phase("cloud", self.traced):
            engine.run_cloud_batch(self.cache, self.vit_cfg, self.params, plans)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.cloud_batch_s.append(time.perf_counter() - t)
        self.forwards.append(self.cache.hits + self.cache.misses - lookups)
        with _phase("logits", self.traced):
            done = [(f, p.logits) for f, p in zip(members, plans) if p.logits is not None]
            if not done:
                return {}
            host = torch.cat([lg.reshape(1, -1) for _, lg in done]).float().cpu().numpy()
        return {f.fid: host[i] for i, (f, _) in enumerate(done)}


class Window:
    """One measured stretch of traffic: every frame sent, when each was
    dispatched and done, and the logits that came back."""

    def __init__(self):
        self.frames: list[Frame] = []
        self.logits: dict[int, np.ndarray] = {}
        self.close = 0.0   # seconds from the window's start

    @property
    def seconds(self) -> float:
        return self.close


def _run_batch(tier: CloudTier, batch, frames_by_rid, window: Window, clock) -> float:
    frames = [frames_by_rid.pop(req.rid) for req in batch]
    t = clock()
    for f in frames:
        f.dispatch_s = t
    out = tier.dispatch(frames)
    t = clock()
    for f in frames:
        if f.fid in out:
            f.done_s = t
            window.logits[f.fid] = out[f.fid]
    return t


def run_window(tier: CloudTier, traffic: dict, source: Source, seconds: float) -> Window:
    """Drive the tier for ``seconds`` of wall time as a closed loop: each of
    ``streams`` clients keeps one frame in flight. Dispatches while the
    window is open; it closes when the last dispatched batch is done."""
    from repro_torch.serving.batcher import MicroBatcher, Request

    batcher = MicroBatcher(traffic["max_batch"], traffic["max_wait_s"])
    window = Window()
    pending: dict[int, Frame] = {}
    ready: collections.deque = collections.deque()
    t0 = time.perf_counter()

    def clock() -> float:
        return time.perf_counter() - t0

    def send(frame: Frame) -> None:
        window.frames.append(frame)
        pending[frame.fid] = frame
        batch = batcher.offer(Request(rid=frame.fid, arrival_s=frame.due_s), frame.due_s)
        if batch:
            ready.append(batch)

    def take() -> list:
        """The flushed micro-batches, oldest first, up to ``max_batch``
        frames: the tier takes at once what its batcher flushed while it
        was busy."""
        batch = ready.popleft()
        while ready and len(batch) + len(ready[0]) <= traffic["max_batch"]:
            batch = batch + ready.popleft()
        return batch

    for _ in range(traffic["streams"]):
        send(source.next(0.0))
    while True:
        now = clock()
        if now >= seconds:
            break
        if not ready:
            batch = batcher.poll(now)
            if batch is None:
                time.sleep(max(0.0, (batcher.deadline() or now) - now))
                continue
            ready.append(batch)
        batch = take()
        done_at = _run_batch(tier, batch, pending, window, clock)
        for _ in range(len(batch)):   # each stream sends its next frame
            send(source.next(done_at))
    window.close = clock()
    return window
