"""Minimal in-process metrics: counters + latency summaries.

The reference has no metrics at all (SURVEY.md §5 "Metrics / logging /
observability: GET /health is the whole story"); this backs the /metrics
endpoint with Prometheus-style text exposition.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._lat_sum: dict[str, float] = defaultdict(float)
        self._lat_count: dict[str, int] = defaultdict(int)
        self._lat_max: dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._lat_sum[name] += seconds
            self._lat_count[name] += 1
            self._lat_max[name] = max(self._lat_max[name], seconds)

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        with self._lock:
            for name, v in sorted(self._counters.items()):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {v:g}")
            for name in sorted(self._lat_count):
                lines.append(f"# TYPE {name}_seconds summary")
                lines.append(f"{name}_seconds_sum {self._lat_sum[name]:.6f}")
                lines.append(f"{name}_seconds_count {self._lat_count[name]}")
                lines.append(f"{name}_seconds_max {self._lat_max[name]:.6f}")
        return "\n".join(lines) + "\n"


GLOBAL_METRICS = Metrics()
