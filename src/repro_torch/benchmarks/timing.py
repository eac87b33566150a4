"""Timing on the card and the H100 bound of a kernel call, shared by
``kernel_bench`` and ``chip_smoke.py``.

Every time here is taken with CUDA events on a card: there is no CPU
fallback, and no CPU time is ever reported under a kernel's name.
"""
from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def time_ms(fn, iters: int = 30, queued: bool = False) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events.

    With ``queued`` the calls are enqueued behind a sleep kernel that
    outlasts the host's enqueueing, so the events time the card alone: the
    host's per-call overhead (Python, allocation, the launch) is hidden. If
    the sleep ended before the host had enqueued every call, it is doubled
    and the run repeated."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(6):
        if queued:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        if not queued or not slept.query():  # the card was still asleep: all queued
            end.synchronize()
            return start.elapsed_time(end) / iters
        end.synchronize()
        cycles *= 2
    raise RuntimeError("time_ms: the host could not queue the calls within the sleep")


def time_cold_ms(fn, iters: int = 20, flush_mb: int = 256) -> float:
    """Mean ms per call with the L2 cache flushed before each call: a
    ``flush_mb`` MB buffer is written outside the timed events (that write
    also outlasts the host's enqueueing of the call)."""
    buf = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        buf.fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least ms the card could take for ``flops`` operations at ``peak``
    and ``nbytes`` moved at the HBM rate, and which of the two sets it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
