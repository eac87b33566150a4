"""Bandwidth estimation + dynamic network traces (Janus §III-D, §V-B).

Estimator: harmonic mean of recent observed throughputs (FESTIVE-style, the
paper's choice), with an offline-mean cold start.

Traces: the paper replays the 5G-mmWave uplink dataset (Static / Walking /
Driving, 5G and 4G LTE). That dataset isn't shipped here, so we generate
statistically similar traces with a seeded 3-state Markov chain
(good / degraded / blocked) whose means match the paper's §II-B numbers
(4G 7.6 Mbps, 5G 14.7 Mbps, WiFi 37.68 Mbps up; RTT 42.2 / 17.05 / 2.3 ms),
with mobility-dependent transition rates. Real traces can be loaded with
``NetworkTrace.from_csv``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import warnings
from collections import deque

import numpy as np


class HarmonicMeanEstimator:
    def __init__(self, window: int = 5, cold_start_bps: float = 10e6):
        self.window = window
        self.cold_start_bps = cold_start_bps
        self._obs: deque[float] = deque(maxlen=window)

    def observe(self, bps: float) -> None:
        if bps > 0:
            self._obs.append(float(bps))

    def estimate(self) -> float:
        if not self._obs:
            return self.cold_start_bps
        inv = [1.0 / o for o in self._obs]
        return len(inv) / sum(inv)


@dataclasses.dataclass(frozen=True)
class NetworkKind:
    name: str
    mean_up_bps: float
    rtt_s: float
    # Markov chain params
    p_degrade: float
    p_block: float
    p_recover: float
    degraded_factor: float = 0.3
    jitter: float = 0.25


NETWORKS = {
    "4g": NetworkKind("4g", 7.6e6, 0.0422, p_degrade=0.15, p_block=0.05, p_recover=0.5),
    "5g": NetworkKind("5g", 14.7e6, 0.01705, p_degrade=0.12, p_block=0.04, p_recover=0.55),
    "wifi": NetworkKind("wifi", 37.68e6, 0.0023, p_degrade=0.08, p_block=0.01, p_recover=0.7),
}

MOBILITY_SCALE = {"static": 0.4, "walking": 1.0, "driving": 2.0}


@dataclasses.dataclass
class NetworkTrace:
    """Per-step uplink throughput (bps) + rtt for a scenario."""
    bps: np.ndarray
    rtt_s: float
    name: str = "trace"

    def __len__(self) -> int:
        return len(self.bps)

    def at(self, step: int) -> float:
        return float(self.bps[step % len(self.bps)])

    @classmethod
    def from_csv(cls, path: str, rtt_s: float, name: str | None = None) -> "NetworkTrace":
        """Load per-step uplink bps from the first column of a CSV file.
        ``#``-comment lines are skipped; ``ndmin=1`` keeps a single-row file
        a length-1 trace. Default ``name`` is the file stem."""
        with warnings.catch_warnings():
            # an empty file raises ValueError below; loadtxt's "no data"
            # UserWarning on the way there is just noise
            warnings.simplefilter("ignore", UserWarning)
            bps = np.loadtxt(path, delimiter=",", usecols=0, ndmin=1)
        if bps.size == 0:
            raise ValueError(f"empty network trace: {path}")
        if name is None:
            name = pathlib.Path(path).stem
        return cls(bps, rtt_s, name)


def synthetic_trace(network: str = "4g", mobility: str = "driving", *,
                    steps: int = 200, seed: int = 0) -> NetworkTrace:
    kind = NETWORKS[network]
    scale = MOBILITY_SCALE[mobility]
    rng = np.random.default_rng(seed)
    state = 0  # 0 good, 1 degraded, 2 blocked
    out = np.empty(steps)
    for i in range(steps):
        u = rng.random()
        if state == 0:
            if u < kind.p_block * scale:
                state = 2
            elif u < (kind.p_block + kind.p_degrade) * scale:
                state = 1
        elif state == 1:
            if u < kind.p_recover:
                state = 0
            elif u < kind.p_recover + kind.p_block * scale:
                state = 2
        else:
            if u < kind.p_recover:
                state = 1
        base = kind.mean_up_bps * {0: 1.3, 1: kind.degraded_factor, 2: 0.02}[state]
        out[i] = max(base * (1 + kind.jitter * rng.standard_normal()), 1e4)
    return NetworkTrace(out, kind.rtt_s, f"{network}-{mobility}-s{seed}")
