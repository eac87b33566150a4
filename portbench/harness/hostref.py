"""A fixed measure of the host, printed on an earlier line of every run
(never among the metrics): so that a slower machine and a slower program can
be told apart. The card's name and power limit go beside it."""
from __future__ import annotations

import shutil
import subprocess
import time

import torch


def launch_us(device: torch.device, count: int = 2000) -> float:
    """Wall µs per launch of a one-element kernel from Python, queued back
    to back and closed by a synchronize."""
    x = torch.zeros(1, device=device)
    for _ in range(50):
        x.add_(1)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(count):
        x.add_(1)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t) / count * 1e6


def py_loop_ms(n: int = 2_000_000) -> float:
    """Wall ms of a fixed pure-Python loop."""
    t = time.perf_counter()
    s = 0
    for i in range(n):
        s += i & 7
    return (time.perf_counter() - t) * 1e3


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def line(device: torch.device) -> str:
    return (f"[host] launch_us={launch_us(device):.3f} py_loop_ms={py_loop_ms():.3f} "
            f"card={torch.cuda.get_device_name(device)!r} power_limit={power_limit()!r}")
