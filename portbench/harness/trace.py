"""What ``torch.profiler`` saw over a traced stretch of the window: the
seconds in which an operation ran on the card (the union of the device
events' intervals), kernels by name, and the card's idle gaps by what the
host was doing, which is the innermost ``portbench.*`` range (the
harness's phases) open on the host at the gap's middle."""
from __future__ import annotations

import collections
import dataclasses

PHASE = "portbench."


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernels: dict[str, tuple[int, float]]   # name -> (launches, seconds)
    idle_by_phase: dict[str, float]

    def kernel_seconds(self, prefix: str) -> tuple[int, float]:
        """Launches and seconds of the kernels whose base name (no return
        type, namespace or template arguments) starts with ``prefix``."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if base_name(name).startswith(prefix):
                calls, secs = calls + n, secs + s
        return calls, secs

    @property
    def launches(self) -> int:
        return sum(n for name, (n, _) in self.kernels.items() if not _is_copy(name))


def _short(name: str) -> str:
    """A kernel's name without its return type: ``void f<...>(...)`` -> ``f<...>(...)``."""
    return name[5:] if name.startswith("void ") else name


def base_name(name: str) -> str:
    """``void (anonymous namespace)::f<64, 1>(P)`` -> ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return _short(name).rsplit("::", 1)[-1]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarize(events, window_name: str = PHASE + "window") -> DeviceTrace | None:
    """From a profile's ``events()``; None where no operation ran on the card."""
    device, host = [], []
    for e in events:
        kind = str(e.device_type).rsplit(".", 1)[-1]
        if kind == "CUDA" and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith(PHASE):
            device.append((e.time_range.start, e.time_range.end, e.name))
        elif kind == "CPU" and e.name.startswith(PHASE):
            host.append((e.time_range.start, e.time_range.end, e.name[len(PHASE):]))
    windows = [(s, t) for s, t, n in host if n == window_name[len(PHASE):]]
    if not device or not windows:
        return None
    w0, w1 = windows[0]
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device if t > w0 and s < w1]
    if not device:
        return None
    kernels: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for s, t, n in device:
        kernels[n][0] += 1
        kernels[n][1] += (t - s) * 1e-6
    busy, gaps, cursor = 0.0, [], w0
    for s, t, _ in sorted(device):
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))
    phases = [(s, t, n) for s, t, n in host if n != window_name[len(PHASE):]]
    idle: dict[str, float] = collections.defaultdict(float)
    for s, t in gaps:
        mid = 0.5 * (s + t)
        open_ = [(ps, n) for ps, pt, n in phases if ps <= mid < pt]
        idle[max(open_)[1] if open_ else "batcher"] += (t - s) * 1e-6
    return DeviceTrace(busy * 1e-6, (w1 - w0) * 1e-6,
                       {n: (c, s) for n, (c, s) in kernels.items()}, dict(idle))


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    ops = sorted(((_short(n)[:160], s) for n, (_, s) in trace.kernels.items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(trace.idle_by_phase.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
