"""Recall evaluation: index configurations against exact f32 search on the
same corpus (port of scripts/eval_recall.py).

  python -m tpu_rag_torch.scripts.eval_recall                      # persisted index
  python -m tpu_rag_torch.scripts.eval_recall --synthetic 100000   # 100K random rows
  python -m tpu_rag_torch.scripts.eval_recall --configs bf16,int8,bucketed,ivf --k 10

Prints one JSON line per configuration with recall@k and bytes per vector
(the memory side of the trade).  The truth is the plain exact scan
(ops/topk.py topk_reference: f32 scores of the normalized rows, ties to the
lowest row) on the same device, where tpu_rag uses a FlatIndex with its
Pallas scan off; "bucketed" is FlatIndex(search_mode="bucketed") at every
size (kernel #3).  The persisted index runs on the configured device
(DEVICE), a synthetic corpus on --device.

Reading the numbers: on clustered corpora the score gap between ranks k and
k+1 is tiny (~3e-4 at k=10), so recall differences under ~0.02 are near-tie
churn between equally-valid orderings, not retrieval quality.
"""

from __future__ import annotations

import argparse
import json
import os

TRUTH = "exact_f32_plain"


def exact_ids(vecs, queries, ids: list[str], k: int, device) -> list[list[str]]:
    """Top-k ids of the plain exact f32 scan over the normalized rows."""
    import torch

    from tpu_rag_torch.index.flat import _normalize
    from tpu_rag_torch.ops.topk import topk_reference

    x = torch.from_numpy(_normalize(vecs)).to(device)
    q = torch.from_numpy(_normalize(queries)).to(device)
    _, rows = topk_reference(q, x, k)
    return [[ids[r] for r in row if r >= 0] for row in rows.cpu().tolist()]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="bf16,int8,bucketed,ivf")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="evaluate N synthetic clustered rows instead of the persisted index")
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--device", default=os.getenv("DEVICE", "cuda"),
                    help="device of a synthetic run: cuda or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.index import FlatIndex, IVFIndex

    rng = np.random.default_rng(0)
    if args.synthetic:
        device = resolve(args.device)
        n, d = args.synthetic, args.d
        centers = rng.standard_normal((max(64, n // 256), d)).astype(np.float32)
        vecs = (centers[rng.integers(0, len(centers), n)]
                + 0.35 * rng.standard_normal((n, d)).astype(np.float32))
        ids = [str(i) for i in range(n)]
        docs = [""] * n
        metas = [{} for _ in range(n)]
    else:
        from tpu_rag_torch.config import config_from_env
        from tpu_rag_torch.engine import RagEngine

        engine = RagEngine(config_from_env())
        device = engine.device
        state = engine.index.state()
        engine.shutdown()
        vecs, ids = state["vectors"], state["ids"]
        docs, metas = state["documents"], state["metadatas"]
        n, d = vecs.shape
        if n < args.k:
            print(json.dumps({"error": f"corpus too small ({n} rows)"}))
            return

    q_rows = rng.integers(0, n, args.queries)
    queries = (vecs[q_rows]
               + 0.2 * rng.standard_normal((args.queries, d)).astype(np.float32))
    truth = exact_ids(vecs, queries, ids, args.k, device)

    def recall_of(index) -> float:
        res = index.search(queries, args.k)
        return float(np.mean([len(set(a) & set(b)) / args.k
                              for a, b in zip(truth, res.ids)]))

    for cfg in args.configs.split(","):
        cfg = cfg.strip()
        if cfg == "bf16":
            idx = FlatIndex(d, dtype="bfloat16", device=device)
            bytes_per_vec = d * 2
        elif cfg == "int8":
            idx = FlatIndex(d, dtype="int8", device=device)
            bytes_per_vec = d + 4
        elif cfg == "bucketed":
            idx = FlatIndex(d, dtype="bfloat16", search_mode="bucketed", device=device)
            bytes_per_vec = d * 2
        elif cfg == "ivf":
            idx = IVFIndex(d, dtype="bfloat16", nprobe=args.nprobe, device=device)
            bytes_per_vec = d * 2  # plus centroid/padding overhead
        else:
            print(json.dumps({"config": cfg, "error": "unknown config"}))
            continue
        idx.add(ids, vecs, docs, metas)
        print(json.dumps({
            "config": cfg,
            "n": int(n), "d": int(d), "k": args.k,
            "recall_at_k": round(recall_of(idx), 4),
            "bytes_per_vector": bytes_per_vec,
            "vs_exact_f32_bytes": round(bytes_per_vec / (d * 4), 3),
            "truth": TRUTH,
        }), flush=True)
        del idx


if __name__ == "__main__":
    main()
