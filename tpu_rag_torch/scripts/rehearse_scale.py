"""End-to-end rehearsal of BASELINE #3: 1M passages x 768-d through the
real pipeline (port of scripts/rehearse_scale.py).

The reference's config #3 is 1M MS MARCO passages under bge-base-768
(BASELINE.md).  With no network, the rehearsal keeps the SHAPES with seeded
weights and a hybrid corpus, through the REAL serving pipeline:

  1. a bge-base-shaped BiEncoder (768 wide, 12 layers, 12 heads of 64;
     weights seeded by the model name) embeds --real documents of a corpus
     JSONL (make_corpus's, or any with "body"/"summary" texts) through the
     serving tokenize -> bucket -> forward path (models/biencoder.py; the
     attention is kernel #5 at head dim 64 on the card);
  2. the remaining rows are drawn ON THE DEVICE from the real embeddings'
     distribution: their mean plus the top-256 spectrum of the centred rows
     (torch.linalg.svd) times a seeded torch.Generator's normals,
     normalized -- --n rows in all.  Embedding 1M real passages through a
     110M-parameter encoder is what the synthetic tail stands in for;
  3. every row goes in through FlatIndex.add (dtype auto: bf16 below 2M
     rows, so the exact scan, kernel #1, at d 768);
  4. recall@k against f32 exact truth on the host, and QPS, through the
     index API (q 64) and over HTTP (/search, rerank off; then a bench_http
     load in a process of its own, concurrency 64 for 8 s).

The query texts are the --queries texts after the --real ones; a corpus
with no more texts gives the labeled queries ("query") of its first
documents instead.  Prints one JSON line (the reference's keys; the port
adds the tokenizer's backend under "encoder") and returns it from main().
A failed load records {"error": ...} under "http_load", as the reference
does.

  python -m tpu_rag_torch.scripts.rehearse_scale --corpus corpus.jsonl
  python -m tpu_rag_torch.scripts.rehearse_scale --corpus c.jsonl --n 5000 \\
      --real 500 --dim-model tiny --device cpu        # a CPU check
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def read_texts(corpus: str, real: int, queries: int) -> tuple[list[str], list[str]]:
    """(document texts, query texts) of a corpus JSONL, as module docs say."""
    texts, labeled = [], []
    with open(corpus, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            for key in ("body", "summary"):
                t = (d.get(key) or "").strip()
                if t:
                    texts.append(t[:1200])
            if len(labeled) < queries and (d.get("query") or "").strip():
                labeled.append(d["query"].strip()[:1200])
            if len(texts) >= real + queries:
                break
    q_texts = texts[real:real + queries]
    if len(q_texts) < queries:
        q_texts = labeled
    if len(texts) < min(real, 2) or not q_texts:
        raise ValueError(f"{corpus}: {len(texts)} texts, {len(q_texts)} queries")
    return texts[:real], q_texts


def _serve(eng, cfg):
    """The engine behind the real HTTP server on a free port:
    (server, thread, base url)."""
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = HTTPServer(create_app(cfg, engine=eng), "127.0.0.1", port, executor_workers=300)
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(600):
        try:
            urllib.request.urlopen(base + "/health", timeout=0.5)
            return srv, thread, base
        except OSError:
            time.sleep(0.1)
    srv.stop()
    raise RuntimeError("the server did not answer /health in 60 s")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--real", type=int, default=20_000)
    ap.add_argument("--dim-model", default="bge-base")
    ap.add_argument("--corpus", required=True, help="a corpus JSONL (make_corpus's)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=os.getenv("DEVICE", "cuda"), help="cuda or cpu")
    args = ap.parse_args(argv)

    import torch

    from tpu_rag_torch.config import Config
    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.index import FlatIndex
    from tpu_rag_torch.models.biencoder import BiEncoder, spec_for_model

    device = resolve(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rep: dict = {"n": args.n, "model_shape": args.dim_model,
                 "real_rows": args.real, "backend": device.type}

    # the repo's WordPiece vocab where the model's embedding table holds
    # it (bge-base's 30,522 rows do; "tiny" has 1,024), else the hash
    # tokenizer
    vocab = REPO / "examples" / "vocab.txt"
    fits = (vocab.is_file() and len(vocab.read_text(encoding="utf-8").splitlines())
            <= spec_for_model(args.dim_model).vocab_size)
    enc = BiEncoder(args.dim_model, seq_len=128, batch=128, device=device,
                    tokenizer_path=str(vocab) if fits else "")
    rep["dim"] = enc.dim
    rep["encoder"] = {"hidden": enc.spec.hidden, "layers": enc.spec.layers,
                      "heads": enc.spec.heads, "seq_len": enc.seq_len,
                      "tokenizer": getattr(enc.tokenizer, "backend", enc.tokenizer.name)}

    # ---- 1. embed real docs through the serving path
    texts, q_texts = read_texts(args.corpus, args.real, args.queries)
    print(f"embedding {len(texts)} real docs at {enc.dim}-d ...", flush=True)
    enc.embed(texts[:256])  # warm
    t0 = time.perf_counter()
    emb = np.asarray(enc.embed(texts), np.float32)
    embed_s = time.perf_counter() - t0
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    rep["embed_real"] = {"docs": len(texts), "seconds": round(embed_s, 1),
                         "docs_per_s": round(len(texts) / embed_s, 1)}
    print(f"  {rep['embed_real']}", flush=True)

    # ---- 2. the tail from the measured distribution, on the device
    mean = emb.mean(axis=0)
    xc = torch.from_numpy(emb - mean).to(device)
    _, s_vals, vt = torch.linalg.svd(xc, full_matrices=False)
    r_keep = min(256, len(texts) - 1, enc.dim)
    s_keep = s_vals[:r_keep] / float(np.sqrt(len(texts)))
    vt_keep = vt[:r_keep]
    mean_d = torch.from_numpy(mean).to(device)
    del xc
    g = torch.Generator(device=device).manual_seed(42)

    def synth_chunk(rows: int) -> np.ndarray:
        z = torch.randn((rows, r_keep), generator=g, device=device)
        x = mean_d + (z * s_keep) @ vt_keep
        x = x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)
        return x.cpu().numpy()

    # ---- 3. ingest through FlatIndex.add (the serving path's index)
    idx = FlatIndex(enc.dim, dtype="auto", device=device)
    t0 = time.perf_counter()
    step = 100_000
    idx.add([f"real-{i}" for i in range(len(emb))], emb,
            ["real"] * len(emb), [{} for _ in range(len(emb))])
    off = len(emb)
    for ki, start in enumerate(range(len(emb), args.n, step)):
        rows = min(step, args.n - start)
        idx.add([f"syn-{off + i}" for i in range(rows)], synth_chunk(rows),
                ["syn"] * rows, [{} for _ in range(rows)])
        off += rows
        if (ki + 1) % 3 == 0:
            print(f"  ingested {off}/{args.n} rows (rss {rss_gb():.1f} GB)", flush=True)
    idx.device_snapshot()
    sync()
    ingest_s = time.perf_counter() - t0
    rep["ingest"] = {"rows": off, "seconds": round(ingest_s, 1),
                     "rows_per_s": round(off / ingest_s, 1),
                     "dtype_resolved": idx.dtype,
                     "mode_resolved": idx.effective_search_mode(off),
                     "rss_gb": round(rss_gb(), 2)}
    print(f"  {rep['ingest']}", flush=True)

    # ---- 4a. ground truth for the query texts (f32 exact, host)
    qv = np.asarray(enc.embed(q_texts), np.float32)
    qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    master = idx._arena.view  # f32 master rows (host arena)
    t0 = time.perf_counter()
    sims = master @ qv.T                          # one read of the rows
    gt = [set(np.argsort(-sims[:, qi])[:args.k].tolist()) for qi in range(len(qv))]
    del sims
    rep["gt_seconds_host"] = round(time.perf_counter() - t0, 1)

    # ---- 4b. index-API recall + QPS
    res = idx.search(qv, args.k)
    rec_idx = float(np.mean([len(set(res.rows[i]) & gt[i]) / args.k
                             for i in range(len(qv))]))
    qb = 64
    qbig = np.concatenate([qv] * (-(-qb // len(qv))), axis=0)[:qb]
    idx.search(qbig, args.k)
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        idx.search(qbig, args.k)
    sync()
    qps_idx = qb * 10 / (time.perf_counter() - t0)
    rep["index_api"] = {"recall_at_10_vs_f32": round(rec_idx, 4),
                        "qps_qb64": round(qps_idx, 1)}
    print(f"  {rep['index_api']}", flush=True)

    # ---- 5. serve over HTTP: the real engine, /search, recall + load
    with tempfile.TemporaryDirectory(prefix="rehearse_scale_") as tmp:
        cfg = Config(persist_dir=os.path.join(tmp, "vs"),
                     kb_db_path=os.path.join(tmp, "db", "kb.sqlite3"),
                     db_path=os.path.join(tmp, "db", "app.sqlite3"),
                     docs_dir=os.path.join(tmp, "docs"), device=device.type,
                     summarize_mode="off", model_priority=("extractive",))
        eng = RagEngine(cfg, encoder=enc, index=idx)
        srv, thread, base = _serve(eng, cfg)
        try:
            recs, lat = [], []
            for qi, text in enumerate(q_texts):
                req = urllib.request.Request(
                    base + "/search",
                    data=json.dumps({"query": text, "k": args.k, "rerank": False}).encode(),
                    headers={"content-type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    body = json.loads(r.read())
                lat.append((time.perf_counter() - t0) * 1e3)
                got = {h.get("id", "") for h in body.get("hits", [])[:args.k]}
                # row order == insertion order: rows < len(emb) are
                # "real-<r>", the rest "syn-<r>"
                gt_ids = {(f"real-{r}" if r < len(emb) else f"syn-{r}") for r in gt[qi]}
                recs.append(len(got & gt_ids) / args.k)
            rep["http"] = {"recall_at_10_vs_f32": round(float(np.mean(recs)), 4),
                           "p50_ms": round(float(np.median(lat)), 1),
                           "queries": len(q_texts)}
            print(f"  {rep['http']}", flush=True)

            # a short concurrent load through the load generator, in a
            # process of its own
            try:
                out = subprocess.run(
                    [sys.executable, "-m", "tpu_rag_torch.scripts.bench_http",
                     "--base", base, "--mode", "single", "--concurrency", "64",
                     "--duration", "8", "--warmup", "2", "--k", str(args.k)],
                    capture_output=True, text=True, timeout=300, cwd=REPO)
                load = json.loads(out.stdout.strip().splitlines()[-1])
                rep["http_load"] = {kk: load.get(kk) for kk in
                                    ("qps", "p50_ms", "p95_ms", "requests_failed")}
            except (subprocess.SubprocessError, OSError, ValueError, IndexError) as e:
                rep["http_load"] = {"error": f"{type(e).__name__}: {e}"[:160]}
        finally:
            srv.stop()
            thread.join(timeout=30)
            eng.shutdown()

    rep["rss_gb_final"] = round(rss_gb(), 2)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
