"""Scale benchmarks for the search kernels (BASELINE.md configs #2/#4 scale;
port of scripts/bench_scale.py).

The corpus is drawn and normalized ON THE DEVICE from a seeded
torch.Generator, chunk by chunk (no host->device upload of the corpus).
Prints one JSON line per config, with the reference's keys.

  python -m tpu_rag_torch.scripts.bench_scale --config flat-1m-bf16
  python -m tpu_rag_torch.scripts.bench_scale --config flat-1m-bf16 --d 768
  python -m tpu_rag_torch.scripts.bench_scale --config ivf-1m-bf16
  python -m tpu_rag_torch.scripts.bench_scale --config encoder-minilm

--paths takes the reference's names; each runs, on the same rows:
  xla       -> "plain_fused": the plain exact scan (ops/topk.py
               topk_reference: one matmul + torch.topk), the reference's
               XLA path;
  pallas    -> "cuda_fused": fused_matmul_topk exact, kernel #1;
  packed    -> "cuda_packed": mode="packed", kernel #2;
  bucketed  -> "cuda_bucketed": mode="bucketed", kernel #3;
  floor     -> "cuda_floor": dma_floor_scan, kernel #4, one read of the
               rows: the floor of every scan above (the port adds it).
On --device cpu every path runs the kernels' plain versions.  The port has
no use_pallas switch: the ivf config's IVFIndex probes with kernels #6/#7
on the card, and its exact truth is FlatIndex's #1.  The reference pads
the rows to its tile heights; the kernels take any n, so nothing is padded.
"""

from __future__ import annotations

import argparse
import json
import time

CONFIGS = {
    "flat-100k-bf16": (100_000, "bfloat16"),
    "flat-1m-bf16": (1_000_000, "bfloat16"),
    "flat-10m-bf16": (10_000_000, "bfloat16"),
    "flat-10m-int8": (10_000_000, "int8"),
    "ivf-1m-bf16": (1_000_000, "bfloat16"),
    "encoder-minilm": (4096, "bfloat16"),   # ingest embed throughput
}
PATHS = {"xla": "plain_fused", "pallas": "cuda_fused", "packed": "cuda_packed",
         "bucketed": "cuda_bucketed", "floor": "cuda_floor"}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def unit_rows(g, rows: int, d: int, device, dtype):
    """`rows` normal rows of width d drawn on `device` from generator g,
    normalized in f32, cast to dtype."""
    import torch

    x = torch.randn((rows, d), generator=g, device=device, dtype=torch.float32)
    return (x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-9)).to(dtype)


def _run_ivf(n, d, k, qbatch, args, device) -> None:
    """IVF build (k-means on the device) + nprobe sweep vs exact ground
    truth (BASELINE.md config #4 shape, 1M scale)."""
    import numpy as np
    import torch

    from tpu_rag_torch.index import FlatIndex, IVFIndex

    # Clustered (mixture-of-Gaussians) data: uniform random high-dim vectors
    # have no cluster structure, which makes IVF recall trivially
    # nprobe/nlist; real embedding corpora cluster, so the benchmark models
    # that: n_centers centers, sigma controls cluster tightness.
    g = torch.Generator(device=device).manual_seed(args.seed)
    n_centers = min(4096, n)
    centers = torch.randn((n_centers, d), generator=g, device=device)
    assign = torch.randint(0, n_centers, (n,), generator=g, device=device)
    vecs = centers[assign] + 0.35 * torch.randn((n, d), generator=g, device=device)
    probe_rows = torch.randint(0, n, (qbatch,), generator=g, device=device)
    queries = vecs[probe_rows] + 0.2 * torch.randn((qbatch, d), generator=g, device=device)
    vecs, queries = vecs.cpu().numpy(), queries.cpu().numpy()
    ids = [str(i) for i in range(n)]

    exact = FlatIndex(d, dtype="bfloat16", device=device)
    exact.add(ids, vecs)
    truth = exact.search(queries, k)

    ivf = IVFIndex(d, dtype="bfloat16", nlist=int(2 * np.sqrt(n)), device=device)
    ivf.add(ids, vecs)
    t0 = time.time()
    ivf.device_snapshot()  # k-means build + grouping + upload
    _sync(device)
    build_s = time.time() - t0

    sweep = {}
    for nprobe in (1, 4, 8, 16, 32, 64):
        ivf.nprobe = nprobe
        res = ivf.search(queries, k)  # warm
        t0 = time.perf_counter()
        iters = 10
        for _ in range(iters):
            res = ivf.search(queries, k)
        dt = (time.perf_counter() - t0) / iters
        recall = float(np.mean([
            len(set(a) & set(b)) / k for a, b in zip(truth.ids, res.ids)]))
        sweep[nprobe] = {"ms": round(dt * 1000, 2),
                         "qps": round(qbatch / dt, 1),
                         "recall_at_10": round(recall, 4)}
    print(json.dumps({"config": args.config, "n": n, "d": d,
                      "nlist": ivf.nlist, "build_seconds": round(build_s, 1),
                      "nprobe_sweep": sweep}), flush=True)


def _run_encoder(n, args, device) -> None:
    """MiniLM-class embed throughput (ingest build-time axis)."""
    from tpu_rag_torch.models.biencoder import BiEncoder

    enc = BiEncoder(batch=256, seq_len=256, device=device)
    texts = [f"document number {i} about topic {i % 97} with several words "
             f"of content repeated {' lorem ipsum' * 8}" for i in range(n)]
    enc.embed(texts[:256])  # warm
    t0 = time.perf_counter()
    out = enc.embed(texts)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "config": args.config, "n": n,
        "model": "minilm-l6 (384d, seq 256, batch 256)",
        "texts_per_second": round(n / dt, 1),
        "seconds": round(dt, 2),
        "dim": int(out.shape[1]),
    }), flush=True)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="flat-1m-bf16", choices=sorted(CONFIGS))
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--qbatch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--paths", default="xla,pallas,packed,bucketed,floor",
                    help=f"comma-separated subset of {','.join(PATHS)}")
    ap.add_argument("--n", type=int, default=0,
                    help="rows (default: the config's; a small n for a CPU check)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)

    import torch

    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.ops.quant import quantize_int8_rows
    from tpu_rag_torch.ops.topk import dma_floor_scan, fused_matmul_topk, topk_reference

    device = resolve(args.device)
    n, dtype = CONFIGS[args.config]
    n = args.n or n
    d, k, qbatch = args.d, args.k, args.qbatch
    unknown = set(args.paths.split(",")) - set(PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")

    if args.config.startswith("ivf"):
        _run_ivf(n, d, k, qbatch, args, device)
        return
    if args.config.startswith("encoder"):
        _run_encoder(n, args, device)
        return

    # ---- on-device data generation (chunked to bound peak memory)
    chunk = 1_000_000
    dtype_bytes = 1 if dtype == "int8" else 2
    g = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    if dtype == "int8":
        x = torch.empty((n, d), dtype=torch.int8, device=device)
        scales = torch.empty((n,), dtype=torch.float32, device=device)
    else:
        x, scales = torch.empty((n, d), dtype=torch.bfloat16, device=device), None
    for off in range(0, n, chunk):
        c = unit_rows(g, min(chunk, n - off), d, device, torch.bfloat16)
        if dtype == "int8":
            x[off:off + len(c)], scales[off:off + len(c)] = quantize_int8_rows(c)
        else:
            x[off:off + len(c)] = c
        del c
    tags = torch.zeros((n,), dtype=torch.int32, device=device)
    q = torch.randn((qbatch, d), generator=g, device=device).to(torch.bfloat16)
    _sync(device)
    gen_s = time.time() - t0

    def measure(run):
        run()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        _sync(device)
        return (time.perf_counter() - t0) / args.iters

    def scan(mode):
        return lambda: fused_matmul_topk(q, x, k, db_scales=scales, ns_tags=tags,
                                         canon_tags=tags, mode=mode)

    runs = {"xla": lambda: topk_reference(q, x, k, db_scales=scales, ns_tags=tags,
                                          canon_tags=tags),
            "pallas": scan("exact"), "packed": scan("packed"), "bucketed": scan("bucketed"),
            "floor": lambda: dma_floor_scan(x)}
    paths = {PATHS[p]: measure(runs[p]) for p in args.paths.split(",")}

    bytes_scanned = n * d * dtype_bytes
    print(json.dumps({
        "config": args.config,
        "n": n, "d": d, "k": k, "qbatch": qbatch, "dtype": dtype,
        "gen_seconds": round(gen_s, 1),
        "paths_ms": {p: round(v * 1000, 3) for p, v in paths.items()},
        "paths_gbps": {p: round(bytes_scanned / v / 1e9, 1) for p, v in paths.items()},
        "paths_qps": {p: round(qbatch / v, 1) for p, v in paths.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
