"""Run one cell of the benchmark once and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads` (at the root of the
checkout); its configuration, traffic mix, driver and per-layer metric
readers are found by name under perfbench/ (harness.py).  The run needs as
many CUDA cards as the cell asks for and fails, printing no result, without
them.  With --trace 0 the result line holds the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from a profiled slice of the
window.  The numbers compared with the plain reference go to standard error
last, each with its limit, and under `checks`, the result line's last key.
The result line is the last line of standard output.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    harness.cache_env(ROOT)
    bench = harness.load_bench(ROOT)
    cell = harness.cell_of(bench, args.workload)
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: no device: {args.workload} needs {chips} CUDA card(s), "
              f"torch sees {have}; nothing falls back to the CPU", file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix="perfbench-")        # under the run's TMPDIR
    try:
        ctx = harness.Context(
            bench=bench, pkg=harness.PKG, workload=args.workload, cell=cell,
            cfg=harness.config_of(ROOT, bench, cell["config"]),
            traffic=harness.traffic_of(harness.PKG, cell["traffic"]),
            limits=harness.limits_of(harness.PKG, args.workload), seed=args.seed,
            seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda:0"),
            tmpdir=tmpdir, t_start=T_START,
            log=lambda *a: print("perfbench:", *a, file=sys.stderr, flush=True))
        line = harness.execute(ctx)
        line["device"]["power_limit"] = harness.power_limit()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run imported {', '.join(found)}: the port and the "
              f"harness may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
