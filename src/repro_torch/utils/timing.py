"""Timing helpers for measured (host-side) benchmarks."""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Timer:
    """Accumulates wall-clock samples; reports robust statistics."""

    samples_s: list[float] = field(default_factory=list)

    def time(self, fn: Callable[[], object]) -> object:
        t0 = time.perf_counter()
        out = fn()
        self.samples_s.append(time.perf_counter() - t0)
        return out

    @property
    def median_s(self) -> float:
        return statistics.median(self.samples_s) if self.samples_s else float("nan")

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.samples_s) if self.samples_s else float("nan")

    @property
    def min_s(self) -> float:
        return min(self.samples_s) if self.samples_s else float("nan")


def bench(fn: Callable[[], object], *, warmup: int = 2, iters: int = 5) -> Timer:
    """Run ``fn`` ``warmup`` + ``iters`` times; return a Timer with the iters."""
    for _ in range(warmup):
        fn()
    t = Timer()
    for _ in range(iters):
        t.time(fn)
    return t


@dataclass
class StepClock:
    """Per-step timing with straggler detection (z-score over a rolling window).

    Used by the training loop: on a real multi-host cluster each host feeds its
    step time; a straggling host shows up as a persistent positive z-score and
    the loop can trigger mitigation (checkpoint + re-mesh without it).
    """

    window: int = 50
    zscore_threshold: float = 4.0
    _times: list[float] = field(default_factory=list)

    def record(self, dt_s: float) -> bool:
        """Record a step time. Returns True if this step is a straggler outlier."""
        self._times.append(dt_s)
        hist = self._times[-self.window :]
        if len(hist) < 10:
            return False
        mu = statistics.fmean(hist[:-1])
        sd = statistics.pstdev(hist[:-1]) or 1e-9
        return (dt_s - mu) / sd > self.zscore_threshold
