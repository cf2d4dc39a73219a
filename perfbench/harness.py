"""Name lookup, the run's context, the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json gives:

  perfbench/configs/<config>.json     a configuration (`file` in BENCHMARK.json)
  perfbench/traffic/<traffic>.json    a traffic mix; its "driver" names
  perfbench/drivers/<driver>.py       the general driver of that kind of traffic
  perfbench/metrics/<metric>.py       the reader of one per-layer metric
  perfbench/limits/<cell>.json        the limits of the numbers a cell's
                                      answers are judged by, and the
                                      readings each was set from

A driver's `run(ctx)` sets up the program, measures the window, reads
the device's peak memory, frees the program and checks what the timed path
produced against the plain reference.  It returns a dict: `e2e` (end-to-end
metric name -> value), `layer_data` (what the readers read; with the trace
on, its `trace`), `checks` ([(name, value, limit)], each passing where
value <= limit), `attempted`, `failed`, `memory_peak_bytes` and `device_kind`.
A reader's `read(data)` takes the driver's `layer_data` and returns the
metric's value, or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_rag")


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(pkg: Path, name: str) -> dict:
    return json.loads((pkg / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_of(pkg: Path, traffic: dict) -> ModuleType:
    name = traffic["driver"]
    return _module(pkg / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def reader_of(pkg: Path, metric: str) -> ModuleType:
    return _module(pkg / "metrics" / f"{metric}.py",
                   "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), in BENCHMARK.json's order.  A metric without `workloads`
    belongs to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def belongs(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if belongs(m)]


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in sys.modules that are, whole, one of FORBIDDEN."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Context:
    bench: dict                     # BENCHMARK.json
    pkg: Path                       # perfbench/ (where configs, traffic, ... are)
    workload: str
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object                  # torch.device
    limits: dict                    # perfbench/limits/<cell>.json
    tmpdir: str
    t_start: float                  # time.monotonic() at process start
    log: object = field(default=print)


@dataclass
class Check:
    """One number compared with its limit: it passes where value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def execute(ctx: Context) -> dict:
    """Run the cell once; the result line's dict (correct, attempted,
    failed, metrics, device, [breakdown], checks)."""
    bench_metrics = metrics_for(ctx.bench, ctx.workload, ctx.trace)
    driver = driver_of(ctx.pkg, ctx.traffic)
    out = driver.run(ctx)
    checks = [Check(*c) for c in out["checks"]]
    metrics = {}
    for m in bench_metrics:
        if ctx.trace:
            value = reader_of(ctx.pkg, m["name"]).read(out["layer_data"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": out["device_kind"], "count": ctx.cell.get("chips", 1),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.trace:
        tr = out["layer_data"]["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    line = {"correct": all(c.ok for c in checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        line["breakdown"] = out["layer_data"]["trace"].breakdown()
        line["trace_partial"] = out["layer_data"].get("partial", [])
    # a number that never came (inf, nan) is printed as 1e30, over any limit
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else 1e30,
                               "limit": c.limit} for c in checks}
    return line


def limits_of(pkg: Path, workload: str) -> dict:
    return json.loads((pkg / "limits" / f"{workload}.json").read_text())["limits"]


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the first card, as printed."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds; no library the port uses loads JAX."""
    cache = root / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
