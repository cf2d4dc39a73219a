"""HTTP load generator for the /search serving path (port of
scripts/bench_http.py).

Drives a running server (tpu_rag_torch's or tpu_rag's: the same routes)
with N concurrent keep-alive connections for a fixed duration and reports
QPS + latency percentiles as one JSON line.  Run it as a SEPARATE PROCESS
from the server so client CPU (its own GIL) does not serialize with handler
threads:

  python -m tpu_rag_torch.scripts.bench_http --base http://127.0.0.1:8765 \
      --mode single --concurrency 64 --duration 8

Modes:
  single   one query per request — exercises the cross-request microbatcher
           (utils/microbatch.py): concurrent embeds+scans fuse into shared
           device windows.
  batched  `batch` queries per request via the queries[] extension — one
           encoder/kernel pass per request, HTTP overhead amortized.
  stub     GET /health: the HTTP machinery with no engine work.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time


def _worker(host: str, port: int, path: str, mode: str, k: int, batch: int,
            deadline: float, wid: int, out: dict, auth: str | None) -> None:
    conn = http.client.HTTPConnection(host, port, timeout=60)
    headers = {"Content-Type": "application/json", "Connection": "keep-alive"}
    if auth:
        headers["x-api-key"] = auth
    lats, ok, failed, qok = [], 0, 0, 0
    i = 0
    while time.perf_counter() < deadline:
        i += 1
        if mode == "stub":
            # GET /health: the same HTTP+threadpool+JSON machinery with no
            # engine work — measures the pure host-side ceiling of this
            # client+server pair (on a 1-core box they share the core)
            t0 = time.perf_counter()
            try:
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 200 and data:
                    ok += 1
                    qok += 1
                    lats.append((time.perf_counter() - t0) * 1000.0)
                else:
                    failed += 1
            except Exception:
                failed += 1
                try:
                    conn.close()
                    conn = http.client.HTTPConnection(host, port, timeout=60)
                except Exception:
                    pass
            continue
        if mode == "batched":
            body = json.dumps({
                "queries": [f"load w{wid} r{i} q{j} topic {wid * 131 + i * 17 + j}"
                            for j in range(batch)],
                "k": k})
            nq = batch
        else:
            body = json.dumps(
                {"query": f"load w{wid} r{i} topic {wid * 131 + i}", "k": k})
            nq = 1
        t0 = time.perf_counter()
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status == 200 and data:
                ok += 1
                qok += nq
                lats.append((time.perf_counter() - t0) * 1000.0)
            else:
                failed += 1
        except Exception:
            failed += 1
            try:
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=60)
            except Exception:
                pass
    try:
        conn.close()
    except Exception:
        pass
    out[wid] = {"lats": lats, "ok": ok, "failed": failed, "qok": qok}


def _proc_load(base: str, mode: str, concurrency: int, duration: float,
               warmup: float, k: int, batch: int, auth: str | None,
               wid_base: int, q):
    """One load-generator process: `concurrency` worker threads, results
    posted to the parent through `q`.  A single Python client process caps
    out near ~1K requests/s on its own GIL, so run_load shards the thread
    pool across processes."""
    from urllib.parse import urlsplit

    u = urlsplit(base)
    host, port = u.hostname, u.port or 80
    path = "/health" if mode == "stub" else "/search"

    if warmup > 0:
        wout: dict = {}
        wdl = time.perf_counter() + warmup
        ths = [threading.Thread(target=_worker,
                                args=(host, port, path, mode, k, batch, wdl,
                                      w, wout, auth))
               for w in range(min(concurrency, 16))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

    out: dict = {}
    t_start = time.perf_counter()
    deadline = t_start + duration
    ths = [threading.Thread(target=_worker,
                            args=(host, port, path, mode, k, batch, deadline,
                                  wid_base + w, out, auth))
           for w in range(concurrency)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    elapsed = time.perf_counter() - t_start
    q.put((elapsed, out))


def run_load(base: str, *, mode: str = "single", concurrency: int = 96,
             duration: float = 10.0, warmup: float = 2.0, k: int = 5,
             batch: int = 32, auth: str | None = None,
             procs: int = 1) -> dict:
    from urllib.parse import urlsplit

    if procs > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # no fork: the parent may hold CUDA
        q = ctx.Queue()
        per = -(-concurrency // procs)
        ps = [ctx.Process(target=_proc_load,
                          args=(base, mode, per, duration, warmup, k, batch,
                                auth, 10_000 * (p + 1), q))
              for p in range(procs)]
        for p in ps:
            p.start()
        results = [q.get(timeout=duration + warmup + 120) for _ in ps]
        for p in ps:
            p.join(timeout=30)
        elapsed = max(e for e, _ in results)
        out = {}
        for _, o in results:
            out.update(o)
        lats = sorted(x for w in out.values() for x in w["lats"])
        ok = sum(w["ok"] for w in out.values())
        qok = sum(w["qok"] for w in out.values())
        failed = sum(w["failed"] for w in out.values())

        def pct(p: float) -> float | None:
            if not lats:
                return None
            return round(lats[min(len(lats) - 1, int(p * len(lats)))], 1)

        return {
            "mode": mode, "concurrency": per * procs, "procs": procs,
            "duration_s": round(elapsed, 2),
            "requests_ok": ok, "requests_failed": failed, "queries_ok": qok,
            "qps": round(qok / elapsed, 1) if elapsed > 0 else None,
            "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
        }

    u = urlsplit(base)
    host, port = u.hostname, u.port or 80
    path = "/health" if mode == "stub" else "/search"

    # warmup phase (not measured): fill pools, compile anything cold
    if warmup > 0:
        wout: dict = {}
        wdl = time.perf_counter() + warmup
        ths = [threading.Thread(target=_worker,
                                args=(host, port, path, mode, k, batch, wdl,
                                      w, wout, auth))
               for w in range(min(concurrency, 16))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

    out: dict = {}
    t_start = time.perf_counter()
    deadline = t_start + duration
    ths = [threading.Thread(target=_worker,
                            args=(host, port, path, mode, k, batch, deadline,
                                  w, out, auth))
           for w in range(concurrency)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    elapsed = time.perf_counter() - t_start

    lats = sorted(x for w in out.values() for x in w["lats"])
    ok = sum(w["ok"] for w in out.values())
    qok = sum(w["qok"] for w in out.values())
    failed = sum(w["failed"] for w in out.values())

    def pct(p: float) -> float | None:
        if not lats:
            return None
        return round(lats[min(len(lats) - 1, int(p * len(lats)))], 1)

    return {
        "mode": mode, "concurrency": concurrency,
        "duration_s": round(elapsed, 2),
        "requests_ok": ok, "requests_failed": failed, "queries_ok": qok,
        "qps": round(qok / elapsed, 1) if elapsed > 0 else None,
        "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default="http://127.0.0.1:8000")
    ap.add_argument("--mode", choices=("single", "batched", "stub"), default="single")
    ap.add_argument("--concurrency", type=int, default=96)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--warmup", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--auth", default=None)
    ap.add_argument("--procs", type=int, default=1,
                    help="shard the client threads over N processes (one "
                         "Python process GIL-caps near ~1K requests/s)")
    args = ap.parse_args(argv)
    print(json.dumps(run_load(
        args.base, mode=args.mode, concurrency=args.concurrency,
        duration=args.duration, warmup=args.warmup, k=args.k,
        batch=args.batch, auth=args.auth, procs=args.procs)))


if __name__ == "__main__":
    main()
