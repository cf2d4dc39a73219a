"""Beyond-device-memory rehearsal: HostArenaIVF at a corpus size where the
exhaustive device scan stops being the design (port of
scripts/rehearse_host_ivf.py).

Default 50M x 384 int8 = 19.2 GB of vectors; the reference's TPU chip had
16 GB of memory, so no flat scan could exist there, and the reference
system handles this tier by holding an hnswlib graph in host RAM.  This
tier (index/host_ivf.py) keeps int8 inverted lists in host RAM and runs
the centroid probe and the gathered-union scan (kernel #1; #2 packed) on
the device.

The corpus is BORN ON THE DEVICE (chunked low-rank generator: a seeded
torch.Generator's normals through a fixed basis with a 1/sqrt(i)
spectrum) and only the quantized int8 rows cross to the host.  Ground
truth is the exact scan of the stored rows (f32 queries against the int8
rows times their scales) over every list and the overflow, streamed to
the device in blocks of lists (on the CPU: numpy, as the reference does).
Then latency and recall@k for batches of 1 and --qbatch queries at
nprobe 32, 64 and 128.

  python -m tpu_rag_torch.scripts.rehearse_host_ivf [--n 50000000] [--chunk 250000]
  python -m tpu_rag_torch.scripts.rehearse_host_ivf --n 20000 --nlist 64 --device cpu

run() is the same, returning the index and its queries besides the report.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def low_rank_generator(d: int, device, seed: int):
    """gen(rows) -> (rows, d) unit rows on `device`: normals through a
    random orthogonal basis scaled by 1/sqrt(1..d), from one seeded
    generator (so the chunks of one run differ, and runs agree)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    bq, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=device).cpu())
    basis = (bq * torch.arange(1, d + 1, dtype=torch.float32).rsqrt()[:, None]).to(device)

    def gen(rows: int):
        z = torch.randn((rows, d), generator=g, device=device) @ basis
        return z * torch.rsqrt((z * z).sum(dim=1, keepdim=True) + 1e-9)
    return gen


def exact_truth(ivf, q: np.ndarray, k: int, device) -> np.ndarray:
    """(nq, k) rows of the exact top k of the stored rows: f32 queries
    against each live slot's int8 row times its scale, over every list and
    the overflow; ties to the lowest stored position.  Blocks of lists go
    through `device` (a cuda device streams them there)."""
    import torch

    qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
    best_sc = torch.full((len(q), k), -float("inf"), device=device)
    best_row = torch.full((len(q), k), -1, dtype=torch.int64, device=device)

    def fold(vals, scales, rows) -> None:
        nonlocal best_sc, best_row
        live = rows >= 0
        if not live.any():
            return
        x = torch.from_numpy(vals[live]).to(device).float()
        sc = (qd @ x.T) * torch.from_numpy(scales[live]).to(device)[None, :]
        rw = torch.from_numpy(rows[live].astype(np.int64)).to(device)
        allsc = torch.cat([best_sc, sc], dim=1)
        allrw = torch.cat([best_row, rw[None, :].expand(len(q), -1)], dim=1)
        pick = torch.sort(allsc, dim=1, descending=True, stable=True).indices[:, :k]
        best_sc, best_row = allsc.gather(1, pick), allrw.gather(1, pick)

    per = max(1, 2_000_000 // max(ivf.cap, 1))
    for l0 in range(0, ivf.nlist, per):
        l1 = min(l0 + per, ivf.nlist)
        fold(ivf._vec[l0:l1].reshape(-1, ivf.dim), ivf._scale[l0:l1].reshape(-1),
             ivf._row[l0:l1].reshape(-1))
    if ivf.spilled_rows:
        fold(np.concatenate(ivf._ov_vec), np.concatenate(ivf._ov_scale),
             np.concatenate(ivf._ov_row))
    return best_row.cpu().numpy()


def run(args) -> tuple[dict, object, np.ndarray, np.ndarray]:
    """Build, truth and sweep as main() does: (report, the HostArenaIVF,
    the queries, their exact top-k rows)."""
    import torch

    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.index.host_ivf import HostArenaIVF

    device = resolve(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    d, n, chunk = args.d, args.n, args.chunk
    rep: dict = {"n": n, "dim": d, "nlist": args.nlist, "backend": device.type,
                 "hbm_note": f"{n * d / 1e9:.1f} GB int8 vectors in host RAM; "
                             "the device holds one batch's gathered lists"}
    gen = low_rank_generator(d, device, args.seed)
    ivf = HostArenaIVF(d, nlist=args.nlist, nprobe=64, cap_factor=2.0, expected_rows=n,
                       max_overflow=max(2_000_000, n // 4), device=device)
    t0 = time.perf_counter()
    ivf.train(gen(min(args.train_sample, n)))
    sync()
    rep["train_s"] = round(time.perf_counter() - t0, 1)
    print(f"trained {args.nlist} centroids in {rep['train_s']}s", flush=True)

    t0 = time.perf_counter()
    first = None
    for ci, off in enumerate(range(0, n, chunk)):
        c = gen(min(chunk, n - off))
        if first is None:
            first = c[:args.queries].clone()
        ivf.add(c)   # a device tensor in: only int8 rows + assignments come down
        if (ci + 1) % 20 == 0:
            el = time.perf_counter() - t0
            print(f"  {off + len(c)}/{n} rows in {el:.0f}s "
                  f"({(off + len(c)) / el:.0f} rows/s, rss {rss_gb():.1f} GB)", flush=True)
    sync()
    build_s = time.perf_counter() - t0
    rep["build"] = {"rows": n, "seconds": round(build_s, 1),
                    "rows_per_s": round(n / build_s, 1),
                    "spilled_rows": int(ivf.spilled_rows), "rss_gb": round(rss_gb(), 2)}
    print(f"build: {rep['build']}", flush=True)

    # queries: perturbed copies of known rows (the generator's own noise)
    q = first + 0.25 * gen(args.queries)
    q = (q / q.norm(dim=1, keepdim=True)).cpu().numpy()

    t0 = time.perf_counter()
    truth = exact_truth(ivf, q, args.k, device)
    rep["gt_seconds_host"] = round(time.perf_counter() - t0, 1)
    gt = [set(r.tolist()) for r in truth]
    print(f"exact truth in {rep['gt_seconds_host']}s", flush=True)

    sweep = []
    for qb in ([] if args.skip_serve else [1, args.qbatch]):
        for nprobe in (32, 64, 128):
            qq = q[:qb]
            ivf.search(qq, args.k, nprobe=nprobe)  # warm
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                _, rows = ivf.search(qq, args.k, nprobe=nprobe)
            dt = (time.perf_counter() - t0) / iters
            rec = float(np.mean([len(set(rows[i][rows[i] >= 0].tolist()) & gt[i]) / args.k
                                 for i in range(qb)]))
            row = {"qbatch": qb, "nprobe": nprobe, "ms_per_batch": round(dt * 1e3, 1),
                   "qps": round(qb / dt, 2), "recall_at_10": round(rec, 4),
                   "union_bytes_mb": round(nprobe * qb * ivf.cap * d / 1e6, 1)}
            sweep.append(row)
            print("serve", row, flush=True)
    rep["serve"] = sweep
    rep["rss_gb_final"] = round(rss_gb(), 2)
    return rep, ivf, q, truth


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000_000)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--nlist", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=250_000)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--qbatch", type=int, default=8, help="the larger batch of the sweep")
    ap.add_argument("--train-sample", type=int, default=262_144)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after build + truth")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    rep = run(args)[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
