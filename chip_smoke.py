#!/usr/bin/env python3
"""Smoke run of the tpu_rag_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line (any failure exits non-zero):

  build    compile every kernel of tpu_rag_torch/csrc with nvcc (sm_90a),
           all sources in parallel, into build/tpu_rag_torch/;
  kernels  hold each kernel against its plain PyTorch version on the card at
           the main path's shapes, and time kernel, plain version and one
           library call (CUDA events, median);
  serve    a 1,000,000 x 384 flat store (bf16, exact scan) behind the real
           HTTP server with all-MiniLM-L6-v2 at full width (seeded weights):
           /docs/save of ~200-token documents, then /search, some of it
           concurrent; the scan (#1) and attention (#5) counters must rise;
  scale    a 2,000,000-row FlatIndex in auto mode (int8 + bucketed scan, #3)
           searched through FlatIndex.search, recall@10 against f32 exact.

Then the kernels summary line, the card's name and power limit as nvidia-smi
reports them, and, last, {"ok": true, "device": {...}}.  Without a CUDA
device, or without the repository beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                        # H100 SXM HBM3
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median wall time of fn() on the device, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------------ phases


def phase_build():
    from tpu_rag_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.is_file() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln][:12]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": _build.last_build["compiled"], "libraries": sorted(paths),
          "ptxas": ptxas})


def _id_check(k_sc, k_id, p_sc, p_id, tol: float) -> dict:
    """Ids equal except where neighbouring plain scores differ by < tol;
    scores within tol."""
    import torch

    fin = torch.isfinite(p_sc)
    err = float((k_sc[fin] - p_sc[fin]).abs().max()) if fin.any() else 0.0
    if not torch.equal(torch.isfinite(k_sc), fin):
        raise AssertionError("kernel and plain disagree on which slots are -inf")
    diff = (k_id != p_id).nonzero().tolist()
    unexplained = 0
    for qi, j in diff:
        near = [j2 for j2 in (j - 1, j + 1) if 0 <= j2 < p_sc.shape[1]]
        tied = any(abs(float(p_sc[qi, j]) - float(p_sc[qi, j2])) < tol for j2 in near)
        if not (tied or j == p_sc.shape[1] - 1):
            unexplained += 1
    if err > tol or unexplained:
        raise AssertionError(f"scan disagrees with its plain version: max score err "
                             f"{err:.3g}, {unexplained} unexplained id mismatches")
    return {"max_abs_err": err, "id_mismatches_in_ties": len(diff)}


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk
    from tpu_rag_torch.ops.quant import quantize_int8_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    d = 384

    def corpus(n):
        x = torch.randn((n, d), generator=g, device=dev)
        x = x / x.norm(dim=1, keepdim=True)
        ns = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int32)
        canon = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
        ns[-1000:] = tk.PAD_TAG                       # padding rows
        x[77] = x[11]                                  # an exact tie
        return x, ns, canon

    # ---- #1 exact scan: 1M x 384, bf16 (q 8, 64; k_scan 20) and int8 (q 64; 4k = 40)
    n = 1_000_000
    x, ns, canon = corpus(n)
    xb = x.to(torch.bfloat16)
    x8, s8 = quantize_int8_rows(x)
    del x
    for dtype, nq, k in (("bf16", 8, 20), ("bf16", 64, 20), ("int8", 64, 40)):
        qf = torch.randn((nq, d), generator=g, device=dev)
        qf[0] = xb[11].float()
        if dtype == "bf16":
            xx, sc, q_in, qs, elt = xb, None, qf.to(torch.bfloat16), None, 2
        else:
            q_in, qs = quantize_int8_rows(qf)
            xx, sc, elt = x8, s8, 1
        args = (q_in, xx, sc, ns, canon, qs, -1, -1, k)
        k_sc, k_id = tk._exact_scan_cuda(*args)
        p_sc, p_id = tk._exact_scan_plain(*args)
        torch.cuda.synchronize()
        chk = _id_check(k_sc, k_id, p_sc, p_id, 1e-4)
        if dtype == "bf16" and k_id[0, 0].item() != 11:
            raise AssertionError("exact scan: the tie must go to the lowest row")
        # filtered run, checked the same way
        fargs = (q_in, xx, sc, ns, canon, qs, 2, 1, k)
        _id_check(*tk._exact_scan_cuda(*fargs), *tk._exact_scan_plain(*fargs), 1e-4)

        def library(q_in=q_in, xx=xx, sc=sc, qs=qs, k=k):
            s = torch.matmul(q_in.to(torch.bfloat16), xx.to(torch.bfloat16).T).float()
            if sc is not None:
                s = s * qs[:, None] * sc[None, :]
            s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
            return torch.topk(s, k, dim=1)

        nbytes = n * d * elt + n * 8 + (n * 4 if sc is not None else 0) + nq * d * elt + nq * k * 8
        b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, dtype)
        rows.append({"name": f"exact_scan[{dtype},n={n},q={nq},k={k}]", "route": "cuda",
                     "source": "tpu_rag_torch/csrc/topk.cu",
                     "replaces": "tpu_rag/ops/topk.py:96", "counter": "exact",
                     "max_abs_err": chk["max_abs_err"],
                     "ms": cuda_ms(lambda: tk._exact_scan_cuda(*args)),
                     "plain_ms": cuda_ms(lambda: tk._exact_scan_plain(*args), iters=5),
                     "library_ms": cuda_ms(library, iters=5),
                     "bound_ms": b_ms, "bound_by": b_by})
    del xb, x8, s8, ns, canon
    torch.cuda.empty_cache()

    # ---- #3 bucketed scan: 2M x 384 int8, q 64, k_scan 40
    n, nq, k = 2_000_000, 64, 40
    x, ns, canon = corpus(n)
    x8, s8 = quantize_int8_rows(x)
    del x
    q8, qs = quantize_int8_rows(torch.randn((nq, d), generator=g, device=dev))
    bargs = (q8, x8, s8, ns, canon, -1, -1)
    k_sc, k_id = tk._bucketed_scan_cuda(*bargs)
    p_sc, p_id = tk._bucketed_scan_plain(*bargs)
    torch.cuda.synchronize()
    # per-bucket maxima: compare the top k the wrapper keeps, as for #1
    chk = _id_check(*tk.select_topk(k_sc, k_id, k), *tk.select_topk(p_sc, p_id, k), 1e-4)
    if not torch.equal(k_id[torch.isfinite(p_sc)], p_id[torch.isfinite(p_sc)]):
        raise AssertionError("bucketed scan: bucket winners differ from the plain version")

    def bucket_library():
        s = torch.matmul(q8.to(torch.bfloat16), x8.to(torch.bfloat16).T).float() * s8[None, :]
        s = torch.where((ns != tk.PAD_TAG)[None, :], s, -math.inf)
        bm = s.view(nq, -1, tk.BUCKET).amax(dim=2)
        return torch.topk(bm, k, dim=1)

    nbytes = n * d + n * 12 + nq * d + nq * (n // tk.BUCKET) * 8
    b_ms, b_by = bound(nbytes, 2.0 * n * d * nq, "int8")
    rows.append({"name": f"bucketed_scan[int8,n={n},q={nq}]", "route": "cuda",
                 "source": "tpu_rag_torch/csrc/topk.cu",
                 "replaces": "tpu_rag/ops/topk.py:284", "counter": "bucketed",
                 "max_abs_err": chk["max_abs_err"],
                 "ms": cuda_ms(lambda: tk._bucketed_scan_cuda(*bargs)),
                 "plain_ms": cuda_ms(lambda: tk._bucketed_scan_plain(*bargs), iters=5),
                 "library_ms": cuda_ms(bucket_library, iters=5),
                 "bound_ms": b_ms, "bound_by": b_by})
    del x8, s8, ns, canon
    torch.cuda.empty_cache()

    # ---- #5 attention: B 64, T 256, H 12, D 32, bf16, ragged masks
    b, t, h, hd = 64, 256, 12, 32
    q, k_, v = (torch.randn((b, t, h, hd), generator=g, device=dev).to(torch.bfloat16)
                for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[0], lens[1] = t, 1
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    mask[2] = 0                                        # an all-pad row
    out = att._fused_mha_cuda(q, k_, v, mask)
    ref = att.fused_mha_plain(q.float(), k_.float(), v.float(), mask)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"attention disagrees with its plain version: {err}")
    bool_mask = (mask > 0)[:, None, None, :]
    qh, kh, vh = (z.permute(0, 2, 1, 3) for z in (q, k_, v))
    nbytes = 4 * b * t * h * hd * 2 + b * t * 4
    b_ms, b_by = bound(nbytes, 4.0 * b * h * t * t * hd, "bf16")
    rows.append({"name": f"fused_mha[bf16,B={b},T={t},H={h},D={hd}]", "route": "cuda",
                 "source": "tpu_rag_torch/csrc/attention.cu",
                 "replaces": "tpu_rag/ops/attention.py:41", "counter": "mha",
                 "max_abs_err": err,
                 "ms": cuda_ms(lambda: att._fused_mha_cuda(q, k_, v, mask)),
                 "plain_ms": cuda_ms(lambda: att.fused_mha_plain(q, k_, v, mask)),
                 "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=bool_mask)),
                 "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernels", "checked": [r["name"] for r in rows],
          "max_abs_err": {r["name"]: r["max_abs_err"] for r in rows}})
    return rows


def _counters():
    from tpu_rag_torch.ops import attention as att
    from tpu_rag_torch.ops import topk as tk

    return {"exact": tk._exact_scan_cuda, "bucketed": tk._bucketed_scan_cuda,
            "mha": att._fused_mha_cuda}


def _reset_counters() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counters() -> dict[str, int]:
    return {name: fn.launches for name, fn in _counters().items()}


def _unit_rows(n: int, d: int, seed: int):
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _http(port: int, method: str, path: str, body=None, timeout: float = 300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _doc_text(i: int) -> str:
    words = ["river", "ember", "crown", "harbor", "glass", "falcon", "marble", "thunder",
             "orchard", "lantern", "copper", "meadow", "silver", "winter", "shadow", "canyon"]
    return " ".join(f"{words[(i * 7 + j * 3) % len(words)]}{(i * 31 + j) % 97}"
                    for j in range(200))


def _profile_window(engine, texts: list[str]) -> dict:
    """One fused embed+search window of len(texts) queries, in process (no
    HTTP): wall time, device time by kernel (torch.profiler), idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine._fused_vector_hits_batch(texts, 5, None, None, cache_qv=False)
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._fused_vector_hits_batch(texts, 5, None, None, cache_qv=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                      # host ops; their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_kernel[e.key[:80]] = us / reps / 1e3
    device_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    # host split of one more window, profiler off: tokenize, then the
    # index's own timers (snapshot / forward+scan+readback / decode)
    t0 = time.perf_counter()
    ids = engine.encoder.tokenize_query_ids(texts)
    t1 = time.perf_counter()
    engine.index.search_fused(engine.encoder.forward_ids, ids, len(texts), 5,
                              return_qv=False)
    split = {"tokenize_ms": (t1 - t0) * 1e3, "total_ms": (time.perf_counter() - t0) * 1e3}
    split.update({k.replace("_s", "_ms"): v * 1e3
                  for k, v in engine.index.last_search_stats.items()})
    return {"queries": len(texts), "wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
            "top_device_ms": top, "host_split_ms": split}


def phase_serve(work: Path) -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.index.flat import FlatIndex
    from tpu_rag_torch.index.store import save_index
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

    n, d = 1_000_000, 384
    t0 = time.perf_counter()
    store = FlatIndex(d, dtype="auto", device="cuda")
    store._bulk_adopt_rows(_unit_rows(n, d, SEED), (f"syn-{i}" for i in range(n)),
                           (("", {}) for _ in range(n)), count=n)
    cfg = Config(persist_dir=str(work / "vs"), kb_db_path=str(work / "db" / "kb.sqlite3"),
                 db_path=str(work / "db" / "app.sqlite3"), docs_dir=str(work / "docs"),
                 embedding_model="sentence-transformers/all-MiniLM-L6-v2",
                 host="127.0.0.1", device="cuda")
    save_index(store, Path(cfg.persist_dir) / cfg.collection_name)
    del store
    build_s = time.perf_counter() - t0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cfg.port = s.getsockname()[1]
    app = create_app(cfg)                 # loads the saved store
    engine = app.state["engine"]
    assert engine.index.count() == n
    server = HTTPServer(app, cfg.host, cfg.port, executor_workers=cfg.http_executor_workers)
    thread = threading.Thread(target=server.run, daemon=True)
    _reset_counters()
    thread.start()
    try:
        deadline = time.time() + 60
        while True:
            try:
                health = _http(cfg.port, "GET", "/health", timeout=10)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        texts = [_doc_text(i) for i in range(4)]
        saved = []
        t_save = time.perf_counter()
        for i, text in enumerate(texts):
            r = _http(cfg.port, "POST", "/docs/save",
                      {"title": f"Smoke doc {i}", "content": text,
                       "metadata": {"namespace": "smoke"}})
            saved.append(r["id"])
        while engine.index.count() < n + len(texts):      # background indexer
            if time.perf_counter() - t_save > 600:
                raise TimeoutError("background indexing did not finish")
            time.sleep(0.2)
        save_s = time.perf_counter() - t_save
        assert engine.encoder.spec.hidden == 384 and engine.encoder.spec.layers == 6
        assert engine.encoder.spec.heads == 12

        queries = texts + [f"{w} tale of the {w} keeper" for w in
                           ("harbor", "falcon", "orchard", "winter", "glass", "copper",
                            "meadow", "canyon")]
        lat = []

        def one(qtext):
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext, "k": 5})
            lat.append(time.perf_counter() - t1)
            return r

        first = [one(q) for q in queries[:4]]                 # sequential
        with ThreadPoolExecutor(8) as pool:                   # concurrent windows
            rest = list(pool.map(one, queries))
        for i, r in enumerate(first + rest[:4]):
            top = r["hits"][0]
            assert top["id"] == saved[i % 4], (i, top["id"])
            assert abs(top["score"]) < 1e-2                   # distance ~ 0: itself
        for r in first + rest:
            assert r["hits"] and all(math.isfinite(h["score"]) for h in r["hits"])
        r = _http(cfg.port, "POST", "/search", {"query": texts[1], "k": 5,
                                                "namespace": "smoke"})
        assert r["hits"][0]["id"] == saved[1] and len(r["hits"]) == 4
        counts = _read_counters()
        windows = {k: v for k, v in GLOBAL_METRICS._counters.items()
                   if k.startswith("vector_microbatch_window_le_")}
        # warm, one at a time: end-to-end latency and the route's stage split
        warm, stages = [], {}
        for qtext in queries[4:]:
            t1 = time.perf_counter()
            r = _http(cfg.port, "POST", "/search", {"query": qtext + " again", "k": 5})
            warm.append((time.perf_counter() - t1) * 1e3)
            for name, ms in r["timings_ms"].items():
                stages.setdefault(name, []).append(ms)
        profile = _profile_window(engine, queries[4:])
    finally:
        server.stop()
        thread.join(timeout=30)
        engine.shutdown()
    if counts["exact"] < 1 or counts["mha"] < 1:
        raise AssertionError(f"the main path did not launch the kernels: {counts}")
    out = {"phase": "serve", "rows": n, "store_build_s": build_s,
           "docs_saved": len(saved), "docs_index_s": save_s,
           "searches": len(lat), "search_ms_p50": statistics.median(lat) * 1e3,
           "search_ms_max": max(lat) * 1e3, "windows": windows,
           "warm_search_ms": warm, "warm_search_ms_p50": statistics.median(warm),
           "warm_stage_ms_p50": {k: statistics.median(v) for k, v in stages.items()},
           "profile_8q_window": profile,
           "snapshot": dict(engine.index.snapshot_stats),
           "health_device": health["device"], "launches": counts}
    emit(out)
    del app, engine, server
    torch.cuda.empty_cache()
    return counts


def phase_scale() -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.index.flat import FlatIndex

    n, d, nq = 2_000_000, 384, 64
    t0 = time.perf_counter()
    x = _unit_rows(n, d, SEED + 1)
    idx = FlatIndex(d, dtype="auto", device="cuda")
    idx._bulk_adopt_rows(x, (f"r{i}" for i in range(n)), (("", {}) for _ in range(n)),
                         count=n)
    rng = np.random.default_rng(SEED + 2)
    base = rng.choice(n, nq, replace=False)
    q = x[base] + 0.05 * rng.standard_normal((nq, d), dtype=np.float32) / math.sqrt(d)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    assert idx.dtype == "int8" and idx.effective_search_mode(n) == "bucketed"
    idx.device_snapshot()
    build_s = time.perf_counter() - t0
    _reset_counters()
    t1 = time.perf_counter()
    res = idx.search(q, 10)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t1
    counts = _read_counters()
    if counts["bucketed"] < 1:
        raise AssertionError(f"the 2M-row search did not launch the bucketed scan: {counts}")
    xt = torch.from_numpy(x).to("cuda")
    truth = torch.topk(torch.from_numpy(q).to("cuda") @ xt.T, 10, dim=1).indices.cpu().numpy()
    del xt
    got = np.asarray([[int(i[1:]) for i in ids] for ids in res.ids])
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, truth)]))
    self_hit = float(np.mean(got[:, 0] == base))
    if recall < 0.95 or self_hit < 1.0:
        raise AssertionError(f"2M int8 bucketed recall@10 {recall}, self hit {self_hit}")
    out = {"phase": "scale", "rows": n, "dtype": idx.dtype, "mode": "bucketed",
           "build_s": build_s, "search_s_64q_first": search_s,
           "recall_at_10": recall, "launches": counts}
    emit(out)
    del idx
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve,scale",
                    help="comma-separated subset of build,kernels,serve,scale")
    args = ap.parse_args()
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (REPO / "tpu_rag_torch" / "csrc").is_dir():
        print(f"chip_smoke: the tpu_rag_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    rows, launches = [], {}
    (REPO / "build").mkdir(exist_ok=True)
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        rows = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO / "build") as work:
        if "serve" in phases:
            launches.update({k: v for k, v in phase_serve(Path(work)).items()
                             if k in ("exact", "mha")})
    if "scale" in phases:
        launches["bucketed"] = phase_scale()["bucketed"]
    for r in rows:
        r["launches"] = launches.get(r.pop("counter"))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
