"""What the per-layer metric readers (perfbench/metrics/<metric>.py)
share.  Each takes a driver's `layer_data` and returns a number, or None
where there is nothing to read: no trace, a trace that lost records of the
kernels it is about (`partial`), or no work in it."""

from __future__ import annotations

from perfbench import roofline


def _trace(data: dict, need_whole: bool):
    tr = data.get("trace")
    if tr is None or tr.window_s <= 0 or (need_whole and data.get("partial")):
        return None
    return tr


def idle_pct(data: dict):
    """Share of the slice in which no device op ran (%)."""
    tr = _trace(data, need_whole=True)
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(data: dict):
    """The slice's model FLOPs over the bf16 peak times the slice (%)."""
    tr = _trace(data, need_whole=False)
    flops = data.get("flops", 0.0)
    if tr is None or flops <= 0:
        return None
    return 100.0 * flops / (roofline.PEAK_BF16_FLOPS * tr.window_s)


def share_pct(data: dict, patterns: tuple[str, ...]):
    """Share of the slice's device time in ops whose name holds one of
    `patterns` (%), or None where the trace is partial or empty."""
    tr = _trace(data, need_whole=True)
    if tr is None:
        return None
    total = sum(e - s for _, s, e in tr.device)
    if total <= 0:
        return None
    hit = sum(e - s for name, s, e in tr.device if any(p in name for p in patterns))
    return 100.0 * hit / total
