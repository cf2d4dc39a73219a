"""A profiled slice of the measured window, and what the metric readers
take from it.

`Slice` runs torch.profiler (CUDA activity) from `start()` to `stop()`;
after the window, `read()` exports the chrome trace into the run's
temporary directory and reads it back: every device operation (kernel,
memcpy, memset) clipped to the slice, and the harness's own host spans
(`Spans`), which name what the host was doing in the device's idle gaps.
Busy time is the length of the union of the device intervals, so kernels
that overlap (two microbatch windows in flight) count once.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    """Device ops [(name, start_s, end_s)] and host ops [(name, tid, start_s,
    end_s)] within the slice, the slice's bounds on the trace's clock, and
    the host wall time of the slice."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    lo: float = 0.0
    hi: float = 0.0
    wall_s: float = 0.0
    lost: bool = False              # a marker was lost: records may be missing

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_s((s, e) for _, s, e in self.device)

    def kernels(self, pattern: str) -> list[float]:
        """Durations (s) of the device ops whose name holds `pattern`."""
        return [e - s for name, s, e in self.device if pattern in name]

    def breakdown(self, top: int = 10) -> dict:
        by: dict[str, float] = {}
        for name, s, e in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(s, e) for _, s, e in self.device], self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), e - s] for s, e in idle]}

    def host_at(self, t: float) -> str:
        """The innermost harness span running at time t."""
        best = None
        for name, tid, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (f"{name[:100]} [{tid}]", s, e)
        return best[0] if best else "outside the harness's spans (the program's threads)"


MARKER = "spin_kernel"       # torch.cuda._sleep's kernel: the slice's two bounds


def parse(events: list[dict], wall_s: float, t0: float = 0.0, spans=()) -> Trace:
    """A chrome trace's device ops between the end of the first marker
    kernel and the start of the last, and the host spans (name, start, end
    on the host's clock, whose t0 is the first marker's end).  Where the
    profiler lost a marker, the slice is the host's wall time from the
    first marker (or the first device op) and the trace is `lost`."""
    marks = sorted((e for e in events if e.get("cat") == "kernel"
                    and MARKER in e.get("name", "")), key=lambda e: e["ts"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and "dur" in e]
    lost = len(marks) < 2
    if not lost:
        lo = (marks[0]["ts"] + marks[0]["dur"]) * 1e-6
        hi = marks[-1]["ts"] * 1e-6
    else:
        first = marks[0] if marks else min(device, key=lambda e: e["ts"], default=None)
        if first is None:
            raise RuntimeError("the profiler's trace holds no device op")
        lo = (first["ts"] + (first["dur"] if marks else 0.0)) * 1e-6
        hi = lo + wall_s
    tr = Trace(lo=lo, hi=hi, wall_s=wall_s, lost=lost)
    for e in device:
        s = e["ts"] * 1e-6
        t = s + e["dur"] * 1e-6
        if t > lo and s < hi and MARKER not in e.get("name", ""):
            tr.device.append((e.get("name", "?"), max(s, lo), min(t, hi)))
    shift = lo - t0
    for name, s, t in spans:
        if t + shift > lo and s + shift < hi:
            tr.host.append((name, "harness", s + shift, t + shift))
    return tr


class Spans:
    """The harness's own host spans (name, start, end on time.monotonic()),
    around its calls into the program; a traced slice labels the device's
    idle gaps with them."""

    def __init__(self) -> None:
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.monotonic()
        try:
            yield
        finally:
            self.spans.append((name, t, time.monotonic()))


def _profile(torch):
    """torch.profiler over CUDA activity alone (recording host ops would
    slow a launch-bound host by half), from every thread where this torch
    can (autograd launches the backward from its own device thread)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        from torch._C._profiler import _ExperimentalConfig

        return profile(activities=[ProfilerActivity.CUDA],
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=[ProfilerActivity.CUDA])


class Slice:
    """Profile from start() to stop(); read() parses the trace afterwards,
    once the window has closed.  The slice is bounded on the device's clock
    by two marker kernels (`spin_kernel`, torch.cuda._sleep), each launched
    after a synchronize, so it holds exactly the device work of [start,
    stop]."""

    def __init__(self, tmpdir: str) -> None:
        self.path = os.path.join(tmpdir, "slice_trace.json")

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = _profile(torch)
        self.prof.__enter__()
        torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.monotonic() - self.t0
        torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        time.sleep(0.05)            # let the last activity records land before the flush
        self.prof.__exit__(None, None, None)

    def read(self, spans: Spans | None = None) -> Trace:
        """The slice's Trace, with the harness's spans."""
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return parse(events, self.wall_s, self.t0, spans.spans if spans else ())
