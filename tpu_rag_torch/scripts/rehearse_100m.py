"""100M-scale machinery rehearsal on a sharded mesh (port of
scripts/rehearse_100m.py).

A 100M-row deployment needs three pieces of plumbing that no single-device
run exercises together: the disk-backed master arena (index/arena.py
memmap), the SQLite row store (index/rowmeta.py, docmeta_backing="disk":
100M Python strings would be tens of GB of host RAM) and the STREAMED
sharded device build (parallel/sharded.py: host temporaries of one upload
chunk, never the whole padded corpus).  This script proves them end to end
on a mesh of `--shards` entries of one device, with a sampled host-RSS
bound asserted:

    python -m tpu_rag_torch.scripts.rehearse_100m --rows 10000000 --dim 384
    python -m tpu_rag_torch.scripts.rehearse_100m --device cpu --rows 5000000 --dim 64

It streams the rows in, builds the sharded snapshot, checks that 8 planted
rows are each their own top-1, adds one row and deletes one (O(doc) moves),
and searches again.  On the CPU the shards live in host RAM, so the bound
is  rss_peak - rss_base <= device_resident_bytes + slack  (the reference's
rule); on a card the shards live in device memory and the bound is
rss_peak - rss_base <= slack  alone.  Either way the master vectors and the
id/doc/meta rows must not show up in anonymous RSS (they are on disk), and
build temporaries must stay small.  Anonymous memory is RssAnon, or VmData
where the kernel does not report RssAnon (anon_source).  Prints one JSON line; exits 1 if the
bound or the serving checks fail.  Rows are drawn in f32 directly (the
reference draws f64 and casts: at d 384 a 768 MB temporary a chunk).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time


def _status_mb(field: str) -> float | None:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 1024.0
    return None


def anon_source() -> str:
    """The /proc/self/status field that measures anonymous memory here:
    RssAnon (resident anonymous pages), or, where the kernel does not report
    it (gVisor's /proc, for one), VmData: the virtual size of the private
    writable mappings, which bounds the resident anonymous pages from above
    and leaves file-backed mappings out, as RssAnon does."""
    for field in ("RssAnon", "VmData"):
        if _status_mb(field) is not None:
            return field
    raise RuntimeError("/proc/self/status reports neither RssAnon nor VmData")


def _rss_mb(field: str | None = None) -> float:
    """Anonymous memory by default: the bounded-temporaries claim is about
    ANONYMOUS host allocations.  File-backed memmap pages (the disk master
    arena) also show in VmRSS while dirty, but the kernel can reclaim them
    under pressure; an anonymous O(n) buffer it cannot.  VmRSS is reported
    beside it."""
    value = _status_mb(field or anon_source())
    return 0.0 if value is None else value


class RssMonitor:
    def __init__(self, period_s: float = 0.2) -> None:
        self.peak = _rss_mb()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, args=(period_s,), daemon=True,
                                   name="rss-monitor")
        self._t.start()

    def _loop(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            self.peak = max(self.peak, _rss_mb())

    def stop(self) -> float:
        self._stop.set()
        self._t.join(timeout=2.0)
        self.peak = max(self.peak, _rss_mb())
        return self.peak


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=250_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shards", type=int, default=8,
                    help="mesh entries along 'data', all on --device (default 8, "
                         "the reference's virtual mesh)")
    ap.add_argument("--workdir", default=None,
                    help="backing files (default: a temporary directory)")
    ap.add_argument("--slack-mb", type=float, default=1536.0,
                    help="allowed anonymous RSS beyond the device-resident bytes "
                         "(those count only on the CPU): upload chunks, ingest "
                         "chunks, row-store caches, Python overhead")
    return ap


def run(args) -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.parallel.mesh import mesh_from_spec
    from tpu_rag_torch.parallel.sharded import ShardedFlatIndex

    dev = resolve(args.device)
    mesh = mesh_from_spec("", [dev] * args.shards)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)      # the CUDA context before the baseline

    rss_base = _rss_mb()
    mon = RssMonitor()
    t0 = time.time()
    idx = ShardedFlatIndex(args.dim, mesh=mesh, dtype="bfloat16", master_backing="disk",
                           docmeta_backing="disk", master_dir=args.workdir)

    # --- streamed ingest: per-chunk host temporaries only
    rng = np.random.default_rng(0)
    planted = {}  # query slot -> (id, vector) of a first-chunk row
    ingest_rows = 0
    while ingest_rows < args.rows:
        rows = min(args.chunk, args.rows - ingest_rows)
        x = rng.standard_normal((rows, args.dim), dtype=np.float32)
        ids = [f"r{ingest_rows + i}" for i in range(rows)]
        docs = [f"doc {ingest_rows + i}" for i in range(rows)]
        idx.add(ids, x, docs, [{} for _ in range(rows)])
        if not planted:
            for qi in range(8):
                planted[qi] = (ids[qi], x[qi].copy())
        del x, ids, docs
        ingest_rows += rows
    ingest_s = time.time() - t0

    # --- streamed sharded device build (the first search triggers it)
    t1 = time.time()
    q = np.stack([v for _, v in planted.values()])
    res = idx.search(q, args.k)
    build_s = time.time() - t1
    # each planted row must be its own top-1 (the corpus is random
    # Gaussian: nothing is closer than the row itself)
    self_hits = sum(res.ids[qi][0] == planted[qi][0] for qi in range(len(planted)))

    # incremental mutation at scale: O(doc) append + tag kill, then search
    t2 = time.time()
    xq = rng.standard_normal((1, args.dim), dtype=np.float32)
    idx.add(["late-row"], xq, ["late doc"], [{}])
    idx.delete(["r5"])
    res2 = idx.search(xq, args.k)
    gone = "r5" not in idx.search(planted[5][1][None, :], args.k).ids[0]
    incr_s = time.time() - t2
    incr_ok = res2.ids[0][0] == "late-row" and gone

    rss_peak = mon.stop()
    vmrss_end = _rss_mb("VmRSS")
    n_pad = idx.device_snapshot()["n_pad"]
    # device-resident bytes: bf16 rows + f32 scales + int32 tags x2
    dev_bytes = n_pad * (args.dim * 2 + 4 + 4 + 4)
    on_host = dev.type == "cpu"
    budget_mb = (dev_bytes / 1e6 if on_host else 0.0) + args.slack_mb
    rss_delta = rss_peak - rss_base
    return {
        "rows": args.rows, "dim": args.dim, "device": str(dev), "shards": args.shards,
        "backings": {"master": "disk", "docmeta": "disk"},
        "ingest_s": round(ingest_s, 1),
        "build_and_first_search_s": round(build_s, 1),
        "incremental_mutation_s": round(incr_s, 1),
        "self_hits": f"{self_hits}/{len(planted)}",
        "incremental_ok": bool(incr_ok),
        "rss_source": anon_source(),
        "rss_anon_base_mb": round(rss_base, 1),
        "rss_anon_peak_mb": round(rss_peak, 1),
        "rss_anon_delta_mb": round(rss_delta, 1),
        "vmrss_end_mb": round(vmrss_end, 1),  # file pages included
        "device_resident_mb": round(dev_bytes / 1e6, 1),
        "device_bytes_in_budget": on_host,
        "rss_budget_mb": round(budget_mb, 1),
        "rss_ok": bool(rss_delta <= budget_mb),
        "snapshot": dict(idx.snapshot_stats),
        "passed": bool(rss_delta <= budget_mb and self_hits == len(planted) and incr_ok),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.workdir is None:
        with tempfile.TemporaryDirectory(prefix="rehearse_100m_") as work:
            args.workdir = work
            report = run(args)
    else:
        report = run(args)
    print(json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
