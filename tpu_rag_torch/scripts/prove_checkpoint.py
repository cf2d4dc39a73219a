"""Turnkey checkpoint proof (port of scripts/prove_checkpoint.py): given a
HF-format weight directory, one command runs, and gates on, two checks:

1. torch-parity: the port's encoder loaded from the checkpoint (f32) gives
   the same mean-pooled, L2-normalized embeddings as
   `transformers.BertModel.from_pretrained` on identical token ids.
   Skipped (not failed) where transformers is absent or cannot load the
   directory.
2. bundled-corpus recall: embed the checked-in examples/docs corpus with
   the checkpoint (f32 forward: kernel #5's f32 variant at T >= 128 on the
   card), build the serving-default FlatIndex (bf16 + refine) and measure
   recall@k against exact f32 search of the same embeddings, plus the
   self-retrieval rate (title query -> own doc in top k).  With
   --rerank-weights the cross-encoder must load and score a (query,
   positive, negative) triple in the right order.

  python -m tpu_rag_torch.scripts.prove_checkpoint --embedding-weights DIR \\
      [--rerank-weights DIR] [--tokenizer vocab.txt] [--k 10] [--device cuda]

Prints ONE JSON line; exit 0 iff every executed gate passed.  The proof's
forward is f32, so a ModernBERT checkpoint is proven with --device cpu: its
attention on the card takes bf16 only, and the card is refused (exit 2).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[2] / "examples" / "docs"


def _bundled_texts(max_docs: int) -> tuple[list[str], list[str]]:
    """(texts, title_queries) from the checked-in examples corpus."""
    texts, titles = [], []
    for path in sorted(glob.glob(os.path.join(EXAMPLES, "**", "*.json"),
                                 recursive=True))[:max_docs]:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        title = str(doc.get("title", ""))
        body = doc.get("body", "")
        if isinstance(body, dict):
            body = " ".join(str(v) for v in body.values())
        text = " ".join(x for x in (title, str(doc.get("summary", "")), str(body)) if x)[:2000]
        if text.strip():
            texts.append(text)
            titles.append(title or text[:60])
    return texts, titles


def torch_parity(weights: str, enc) -> dict:
    """Max |ours - transformers| over mean-pooled normalized embeddings on
    shared token ids; {"skipped": reason} where transformers cannot load
    the directory."""
    try:
        import transformers
    except ImportError as e:
        return {"skipped": f"transformers unavailable: {e}"}
    try:
        tm = transformers.BertModel.from_pretrained(weights).eval()
    except Exception as e:  # any load failure of a foreign loader is a skip
        return {"skipped": f"transformers could not load the dir: {e}"}

    import numpy as np
    import torch

    from tpu_rag_torch.models.bert import l2_normalize, mean_pool

    spec = enc.spec
    sents = [
        "The moon temple stands on the silver cliff.",
        "Trade caravans cross the iron pass each autumn season.",
        "A short one.",
    ]
    t = min(enc.seq_len, 64)
    ids = np.zeros((len(sents), t), np.int64)
    mask = np.zeros((len(sents), t), np.int64)
    for r, s in enumerate(sents):
        row = enc.tokenizer.tokenize_ids(s)[: t - 2]
        row = [101] + row + [102] if spec.vocab_size > 103 else [1] + row + [2]
        row = [min(i, spec.vocab_size - 1) for i in row]
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    with torch.no_grad():
        hidden = tm(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        m_dev = torch.from_numpy(mask).to(enc.device)
        ours_h = enc.module(torch.from_numpy(ids).to(enc.device), m_dev)
        ours = l2_normalize(mean_pool(ours_h, m_dev).to(torch.float32)).cpu().numpy()
    m = mask[..., None].astype(np.float32)
    ref = (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    ref /= np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-9)
    diff = float(np.max(np.abs(ours - ref)))
    return {"ok": diff < 2e-3, "max_abs_diff": round(diff, 6)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--embedding-weights", required=True)
    ap.add_argument("--rerank-weights", default="")
    ap.add_argument("--tokenizer", default="",
                    help="vocab.txt path; defaults to one inside the weights dir")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-docs", type=int, default=254)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default=os.getenv("DEVICE", "cuda"), help="cuda or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.index import FlatIndex
    from tpu_rag_torch.models.biencoder import BiEncoder, spec_for_model
    from tpu_rag_torch.models.hf_import import spec_from_hf_config

    device = resolve(args.device)
    spec = (spec_from_hf_config(args.embedding_weights)
            or spec_for_model(args.embedding_weights))
    try:
        spec.prepare(device, torch.float32)
    except ValueError as e:
        ap.error(str(e))
    tok_path = args.tokenizer
    if not tok_path:
        cand = os.path.join(args.embedding_weights, "vocab.txt")
        tok_path = cand if os.path.isfile(cand) else ""
    enc = BiEncoder(args.embedding_weights, weights_path=args.embedding_weights,
                    tokenizer_path=tok_path, seq_len=args.seq_len, batch=64,
                    dtype="float32", spec=spec, device=device)

    report: dict = {"embedding_weights": args.embedding_weights,
                    "spec": {"hidden": spec.hidden, "layers": spec.layers,
                             "vocab": spec.vocab_size}}
    report["torch_parity"] = torch_parity(args.embedding_weights, enc)

    texts, titles = _bundled_texts(args.max_docs)
    emb = np.asarray(enc.embed(texts), np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    qv = np.asarray(enc.embed(titles), np.float32)
    qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    k = min(args.k, len(texts))
    gt = np.argsort(-(qv @ emb.T), axis=1)[:, :k]

    idx = FlatIndex(spec.hidden, dtype="bfloat16", device=device)
    idx.add([str(i) for i in range(len(texts))], emb, texts, [{} for _ in texts])
    res = idx.search(qv, k)
    recall = float(np.mean([len(set(res.rows[qi]) & set(gt[qi].tolist())) / k
                            for qi in range(len(titles))]))
    self_hit = float(np.mean([qi in set(res.rows[qi]) for qi in range(len(titles))]))
    report["bundled_recall_at_k"] = {
        "k": k, "docs": len(texts), "recall_vs_f32": round(recall, 4),
        "self_retrieval_rate": round(self_hit, 4), "ok": recall >= 0.98}

    if args.rerank_weights:
        from tpu_rag_torch.models.crossencoder import CrossEncoder

        ce_spec = (spec_from_hf_config(args.rerank_weights)
                   or spec_for_model(args.rerank_weights))
        try:
            ce = CrossEncoder(args.rerank_weights, weights_path=args.rerank_weights,
                              tokenizer_path=tok_path, spec=ce_spec, device=device)
            pos, neg = texts[0], texts[len(texts) // 2 % len(texts)]
            sc = ce.predict([(titles[0], pos), (titles[0], neg)])
            report["rerank"] = {"ok": bool(sc[0] > sc[1]),
                                "pos_score": round(float(sc[0]), 4),
                                "neg_score": round(float(sc[1]), 4)}
        except Exception as e:  # the gate reports the failure, as tpu_rag's does
            report["rerank"] = {"ok": False, "error": str(e)[:200]}

    gates = [v for v in report.values() if isinstance(v, dict) and "ok" in v]
    report["passed"] = all(v["ok"] for v in gates)
    print(json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
