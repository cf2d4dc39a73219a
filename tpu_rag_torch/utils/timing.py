"""Lightweight per-stage latency instrumentation.

The reference has no tracing at all (SURVEY.md §5: "Tracing / profiling:
ABSENT").  This framework reports per-stage latencies in /search responses
and exposes them for the bench harness.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Timer:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0


class StageTimings:
    """Collects named stage durations (milliseconds)."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0) * 1000.0

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 3) for k, v in self.stages.items()}
