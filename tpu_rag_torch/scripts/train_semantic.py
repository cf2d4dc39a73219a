"""End-to-end semantic-quality pipeline on the port: corpus -> vocab ->
contrastive training -> checkpoint -> LABELED retrieval eval; port of
scripts/train_semantic.py, with the same steps, labels and report keys.

The first-party bi-encoder trains on real English text (Python docstrings,
tpu_rag_torch/scripts/make_corpus.py) and is scored on held-out query->doc
recall@k with ground-truth labels: the query is a docstring's one-line
summary, the target is its body (summary and body share meaning, not
surface form).

Training recipe (Contriever/ICT-style, for an encoder that starts from
seeded weights):
- positives mix labeled (summary -> body-crop) pairs with unsupervised
  (random body crop -> independent random body crop) pairs, so every epoch
  sees fresh views of each document instead of one fixed pair;
- in-batch negatives (InfoNCE), large batch for many negatives;
- linear warmup + cosine-decay learning rate.

  python -m tpu_rag_torch.scripts.make_corpus --out corpus.jsonl
  python -m tpu_rag_torch.scripts.train_semantic --corpus corpus.jsonl \
      --steps 3000 --out semantic

MiniLM-L6 by default; `--model modernbert-large --batch 32 --seq-len 4096
--q-len 64 --body-cut 8192 --lr 1e-4` trains ModernBERT-large on windows of
long documents.

Artifacts in --out: vocab.txt, ckpt/ (a HF BertModel, or ModernBertModel,
directory, served by
EMBEDDING_WEIGHTS=<out>/ckpt TOKENIZER_PATH=<out>/vocab.txt
python -m tpu_rag_torch.serve), quality.json, QUALITY.md.

Baselines evaluated on the same split: the seeded-random encoder, BM25
(SQLite FTS5, the engine of the keyword path) and the product-relevant
hybrid: trained vector + BM25 fused with reciprocal-rank fusion.

Runs on --device (cuda unless told otherwise; cuda without a card raises):
bf16 compute on the card, as tpu_rag trains in bf16 on its accelerator,
f32 on the CPU.  The eval embeds through the port's BiEncoder, whose
attention at T >= 128 is the fused kernel (#5).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sqlite3
import time
from typing import Callable

import numpy as np


def load_corpus(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        docs = [json.loads(line) for line in f]
    if not docs:
        raise SystemExit(f"empty corpus: {path}")
    return docs


def split_holdout(docs: list[dict], frac: float) -> tuple[list[dict], list[dict]]:
    """Deterministic id-hash split so train/eval never leak across runs."""
    mod = max(2, int(round(1.0 / max(frac, 1e-6))))
    train, hold = [], []
    for d in docs:
        h = int.from_bytes(hashlib.blake2b(d["id"].encode(), digest_size=4).digest(), "little")
        (hold if h % mod == 0 else train).append(d)
    return train, hold


def recall_at(ranks: np.ndarray, k: int) -> float:
    return float(np.mean(ranks < k))


def _metric_row(label: str, ranks: np.ndarray, **extra) -> dict:
    out = {"label": label,
           "recall@1": round(recall_at(ranks, 1), 4),
           "recall@5": round(recall_at(ranks, 5), 4),
           "recall@10": round(recall_at(ranks, 10), 4),
           "mrr@10": round(float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0))), 4)}
    out.update(extra)
    print(f"[eval] {label}: {out}")
    return out


def eval_encoder(encoder, docs: list[dict], holdout: list[dict],
                 label: str) -> tuple[dict, np.ndarray]:
    """Index every body; query with held-out summaries; rank of own body.
    Also returns the top-100 doc positions per query (for hybrid fusion),
    all of them on a corpus of 100 docs or fewer (where tpu_rag's
    argpartition at 100 raises)."""
    bodies = [d["body"] for d in docs]
    t0 = time.time()
    demb = encoder.embed(bodies)
    qemb = encoder.embed([d["query"] for d in holdout])
    dt = time.time() - t0
    id_pos = {d["id"]: i for i, d in enumerate(docs)}
    targets = np.array([id_pos[d["id"]] for d in holdout])
    top = min(100, len(docs))
    ranks = np.empty(len(holdout), np.int64)
    top100 = np.empty((len(holdout), top), np.int64)
    for i in range(0, len(holdout), 256):
        scores = qemb[i:i + 256] @ demb.T
        own = scores[np.arange(len(scores)), targets[i:i + 256]]
        ranks[i:i + 256] = (scores > own[:, None]).sum(axis=1)
        part = np.argpartition(-scores, min(100, len(docs) - 1), axis=1)[:, :top]
        order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1)
        top100[i:i + 256] = np.take_along_axis(part, order, axis=1)
    return _metric_row(label, ranks, embed_seconds=round(dt, 1)), top100


def eval_bm25(docs: list[dict], holdout: list[dict]) -> tuple[dict, list[list[int]]]:
    """Lexical baseline: SQLite FTS5 BM25 (the engine of the keyword path).
    Returns top-100 doc positions too."""
    con = sqlite3.connect(":memory:")
    try:
        con.execute("CREATE VIRTUAL TABLE fts USING fts5(body)")
        con.executemany("INSERT INTO fts(rowid, body) VALUES (?, ?)",
                        [(i + 1, d["body"]) for i, d in enumerate(docs)])
        id_pos = {d["id"]: i for i, d in enumerate(docs)}
        ranks = []
        tops: list[list[int]] = []
        for d in holdout:
            target = id_pos[d["id"]] + 1
            terms = [w for w in d["query"].split() if w.isalnum()]
            if not terms:
                ranks.append(10**6)
                tops.append([])
                continue
            q = " OR ".join(terms)
            try:
                rows = con.execute(
                    "SELECT rowid FROM fts WHERE fts MATCH ? ORDER BY bm25(fts) LIMIT 100",
                    (q,)).fetchall()
            except sqlite3.OperationalError:
                rows = []
            hit = [i for i, (rid,) in enumerate(rows) if rid == target]
            ranks.append(hit[0] if hit else 10**6)
            tops.append([rid - 1 for (rid,) in rows])
    finally:
        con.close()
    return _metric_row("bm25_fts5", np.asarray(ranks)), tops


def eval_hybrid_rrf(docs: list[dict], holdout: list[dict],
                    vec_top: np.ndarray, bm_top: list[list[int]],
                    c: int = 60) -> dict:
    """Reciprocal-rank fusion of the trained vector ranking with BM25 — the
    shape retrieval takes in the product (vector + FTS hybrid search)."""
    id_pos = {d["id"]: i for i, d in enumerate(docs)}
    ranks = []
    for qi, d in enumerate(holdout):
        target = id_pos[d["id"]]
        fused: dict[int, float] = {}
        for r, pos in enumerate(vec_top[qi]):
            fused[int(pos)] = fused.get(int(pos), 0.0) + 1.0 / (c + r + 1)
        for r, pos in enumerate(bm_top[qi]):
            fused[pos] = fused.get(pos, 0.0) + 1.0 / (c + r + 1)
        ordered = sorted(fused, key=fused.get, reverse=True)
        ranks.append(ordered.index(target) if target in fused else 10**6)
    return _metric_row("hybrid_trained+bm25_rrf", np.asarray(ranks))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    from tpu_rag_torch.models.biencoder import MODEL_SPECS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="minilm-l6", choices=sorted(MODEL_SPECS),
                    help="the encoder trained (biencoder.MODEL_SPECS); a BERT preset "
                         "takes the corpus vocab's size")
    ap.add_argument("--body-cut", type=int, default=320,
                    help="document crops are drawn from a body's first this many tokens")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--q-len", type=int, default=48)
    ap.add_argument("--lr", type=float, default=4e-4, help="peak LR (warmup+cosine)")
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--crop-prob", type=float, default=0.5,
                    help="fraction of query views that are random body crops "
                         "(Contriever-style) instead of the labeled summary")
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--vocab-size", type=int, default=30522)
    ap.add_argument("--holdout-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate an existing --out checkpoint")
    args = ap.parse_args(argv)
    # steps <= warmup would make the cosine decay_steps non-positive and
    # raise deep into the run — clamp up front
    if args.steps <= args.warmup:
        args.warmup = max(1, args.steps // 10)
        print(f"[train_semantic] warmup clamped to {args.warmup} "
              f"(steps={args.steps})", flush=True)
    return args


def semantic_spec(args):
    """The --model encoder at its published widths (spec.sized_for): a BERT
    preset over the corpus vocab with a position table of the longer of
    --seq-len and --q-len (at least 128); ModernBERT as published, whose
    50,368-row table holds the corpus vocab's ids and whose RoPE reaches
    8,192 positions."""
    from tpu_rag_torch.models.biencoder import MODEL_SPECS

    try:
        return MODEL_SPECS[args.model].sized_for(args.vocab_size, max(args.seq_len, args.q_len))
    except ValueError as e:
        raise SystemExit(f"--model {args.model}, --vocab-size {args.vocab_size}, "
                         f"--seq-len {args.seq_len}: {e}") from None


def build_vocab(docs: list[dict], args, vocab_path: str) -> list[str]:
    from tpu_rag_torch.models.vocab_train import save_vocab, train_wordpiece_vocab

    vocab = train_wordpiece_vocab(
        (d["query"] + "\n" + d["body"] for d in docs), vocab_size=args.vocab_size)
    save_vocab(vocab, vocab_path)
    return vocab


def batch_sampler(train_docs: list[dict], tok, args) -> Callable[[], dict]:
    """Pre-tokenizes the training docs (each body's first `args.body_cut`
    tokens, 320 where args has none) and returns
    a function that draws one batch of numpy {q_ids, q_mask, d_ids, d_mask}.
    Positives: labeled (summary -> body crop) mixed with unsupervised (body
    crop -> independent body crop) — fresh views every epoch, so 18K docs
    yield far more than 18K distinct pairs."""
    from tpu_rag_torch.models.tokenizer import PAD_ID
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
    from tpu_rag_torch.utils.timing import span

    cls_id = getattr(tok, "cls_id", 1)
    sep_id = getattr(tok, "sep_id", 2)
    pad_id = getattr(tok, "pad_id", PAD_ID)
    cut = getattr(args, "body_cut", 320)
    body_toks = [tok.tokenize_ids(d["body"])[:cut] for d in train_docs]
    sum_toks = [tok.tokenize_ids(d["query"])[: args.q_len - 2] for d in train_docs]

    def assemble(rows: list[list[int]], seq: int):
        ids = np.full((len(rows), seq), pad_id, np.int32)
        mask = np.zeros((len(rows), seq), np.int32)
        real = 0
        for i, r in enumerate(rows):
            row = [cls_id] + r[: seq - 2] + [sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
            real += len(row)
        # the padding of the batch: real tokens against the slots written
        GLOBAL_METRICS.inc("train_sample_real_tokens_total", real)
        GLOBAL_METRICS.inc("train_sample_token_slots_total", len(rows) * seq)
        return ids, mask

    rng = np.random.default_rng(args.seed)

    def crop(toks: list[int], lo: int, hi: int) -> list[int]:
        # min(): tpu_rag's draw raises at --seq-len < 34 (lo 32 > hi)
        w = int(rng.integers(min(lo, hi), hi + 1))
        if len(toks) <= w:
            return toks
        start = int(rng.integers(0, len(toks) - w + 1))
        return toks[start : start + w]

    draws = 0

    def sample_batch() -> dict:
        nonlocal draws
        with span("train.sample", step=draws):
            idx = rng.choice(len(train_docs), size=args.batch, replace=False)
            q_rows, d_rows = [], []
            for i in idx:
                if rng.random() < args.crop_prob or not sum_toks[i]:
                    q_rows.append(crop(body_toks[i], 6, args.q_len - 2))
                else:
                    q_rows.append(sum_toks[i])
                d_rows.append(crop(body_toks[i], 32, args.seq_len - 2))
            q_ids, q_mask = assemble(q_rows, args.q_len)
            d_ids, d_mask = assemble(d_rows, args.seq_len)
            draws += 1
            return {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask}

    return sample_batch


def make_trainer(args, spec, device):
    """The contrastive trainer under train_semantic's schedule: warmup to
    --lr, cosine to 2% of it at --steps."""
    from tpu_rag_torch.device import compute_dtype
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay

    schedule = warmup_cosine_decay(0.0, args.lr, args.warmup, args.steps, args.lr * 0.02)
    return ContrastiveTrainer(spec, lr=schedule, tau=args.tau,
                              compute_dtype=compute_dtype(device), seed=args.seed,
                              device=device)


def evaluate(args, spec, docs: list[dict], holdout: list[dict], vocab_path: str,
             ckpt_path: str, device, bm25: tuple[dict, list[list[int]]] | None = None
             ) -> list[dict]:
    """The labeled eval: trained encoder, seeded encoder, BM25, RRF hybrid.
    `bm25` is eval_bm25(docs, holdout) where the caller ran it already (it
    needs no encoder, so it can run beside training)."""
    from tpu_rag_torch.models.biencoder import BiEncoder

    results = []
    trained = BiEncoder("minilm-l6-corpus", weights_path=ckpt_path,
                        tokenizer_path=vocab_path, seq_len=args.seq_len,
                        batch=128, spec=spec, device=device)
    row, vec_top = eval_encoder(trained, docs, holdout, "trained_biencoder")
    results.append(row)
    del trained
    random_enc = BiEncoder("minilm-l6-corpus", tokenizer_path=vocab_path,
                           seq_len=args.seq_len, batch=128, spec=spec, device=device)
    results.append(eval_encoder(random_enc, docs, holdout, "random_weights_round1")[0])
    del random_enc
    bm_row, bm_top = bm25 if bm25 is not None else eval_bm25(docs, holdout)
    results.append(bm_row)
    results.append(eval_hybrid_rrf(docs, holdout, vec_top, bm_top))
    return results


def write_report(args, spec, docs: list[dict], holdout: list[dict], results: list[dict],
                 ckpt_path: str, vocab_path: str) -> dict:
    """quality.json and QUALITY.md in --out."""
    report = {
        "task": "held-out docstring summary -> body retrieval",
        "corpus_docs": len(docs), "holdout_queries": len(holdout),
        "train_steps": args.steps, "batch": args.batch,
        "spec": {"hidden": spec.hidden, "layers": spec.layers,
                 "vocab": args.vocab_size},
        "results": results,
        "serving": {"EMBEDDING_WEIGHTS": ckpt_path, "TOKENIZER_PATH": vocab_path},
    }
    with open(os.path.join(args.out, "quality.json"), "w") as f:
        json.dump(report, f, indent=2)

    lines = ["| encoder | recall@1 | recall@5 | recall@10 | MRR@10 |",
             "|---|---|---|---|---|"]
    for r in results:
        lines.append(f"| {r['label']} | {r['recall@1']} | {r['recall@5']} "
                     f"| {r['recall@10']} | {r['mrr@10']} |")
    table = "\n".join(lines)
    with open(os.path.join(args.out, "QUALITY.md"), "w") as f:
        f.write(f"# Semantic retrieval quality\n\n{json.dumps(report['task'])}, "
                f"{len(docs)} docs, {len(holdout)} held-out queries\n\n{table}\n")
    print(table)
    return report


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.models.tokenizer import load_tokenizer

    device = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    vocab_path = os.path.join(args.out, "vocab.txt")
    ckpt_path = os.path.abspath(os.path.join(args.out, "ckpt"))

    docs = load_corpus(args.corpus)
    train_docs, holdout = split_holdout(docs, args.holdout_frac)
    print(f"corpus: {len(docs)} docs -> {len(train_docs)} train / {len(holdout)} holdout")

    if not args.eval_only:
        print("[1/4] training WordPiece vocab from the corpus ...")
        vocab = build_vocab(docs, args, vocab_path)
        print(f"vocab: {len(vocab)} tokens -> {vocab_path}")

    tok = load_tokenizer(vocab_path, vocab_size=args.vocab_size)
    spec = semantic_spec(args)

    if not args.eval_only:
        print("[2/4] pre-tokenizing training docs (full-length token lists) ...")
        sample_batch = batch_sampler(train_docs, tok, args)
        print(f"[3/4] contrastive training: {args.steps} steps x batch {args.batch} "
              f"on {device} ...")
        trainer = make_trainer(args, spec, device)
        t0 = time.time()
        for step in range(args.steps):
            loss = trainer.train_step(sample_batch())
            if step % 100 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"  step {step:5d}  loss {loss:.4f}  ({dt:.0f}s)", flush=True)
        trainer.save(ckpt_path)
        del trainer
        print(f"checkpoint -> {ckpt_path}")

    print("[4/4] labeled retrieval eval (held-out summary -> body) ...")
    results = evaluate(args, spec, docs, holdout, vocab_path, ckpt_path, device)
    return write_report(args, spec, docs, holdout, results, ckpt_path, vocab_path)


if __name__ == "__main__":
    main()
