"""Train the cross-encoder reranker on labeled pairs with hard negatives,
then measure the rerank LIFT on held-out retrieval; port of
scripts/train_reranker.py, with the same flags, draws, labels and report
keys.

The trunk starts from the trained bi-encoder (train_semantic's --out:
vocab.txt and ckpt/, a HF directory), as ms-marco cross-encoders start
from a pretrained BERT; the pooler and classifier start from seeded
weights.  Pairs are (summary query, body); negatives are the bi-encoder's
top-ranked non-target bodies of the TRAIN split (hard) and random train
bodies.  The loss is the grouped softmax over [positive, negatives...]
(train/ranking.py).  The eval reranks the bi-encoder's top cand_k
candidates of held-out queries through the serving CrossEncoder and
reports recall@k / MRR@10 before and after, the tuned ensemble, and the
seeded reranker it replaces.

  python -m tpu_rag_torch.scripts.train_semantic --corpus c.jsonl --out semantic
  python -m tpu_rag_torch.scripts.train_reranker --corpus c.jsonl \\
      --biencoder semantic --out reranker

Artifacts in --out: ckpt/ (a HF BertForSequenceClassification directory,
served by RERANK_WEIGHTS=<out>/ckpt with the bi-encoder's TOKENIZER_PATH and
RERANK_ENSEMBLE_ALPHA from the report), rerank.json, RERANK.md.

Runs on --device (cuda unless told otherwise; cuda without a card raises):
training in bf16 compute with the plain attention (no kernel: #5 has no
backward), the eval's cross-encoder at T = --seq-len through kernel #5.
Divergence from tpu_rag: a --biencoder whose ckpt/ does not load raises
(tpu_rag silently trains a seeded trunk there) unless --no-biencoder-init.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time

import numpy as np

def load_corpus(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        docs = [json.loads(line) for line in f]
    if not docs:
        raise SystemExit(f"empty corpus: {path}")
    return docs


def split_holdout(docs: list[dict], frac: float) -> tuple[list[dict], list[dict]]:
    """Same deterministic id-hash split as train_semantic, so the reranker
    never trains on the bi-encoder's held-out queries."""
    mod = max(2, int(round(1.0 / max(frac, 1e-6))))
    train, hold = [], []
    for d in docs:
        h = int.from_bytes(hashlib.blake2b(d["id"].encode(), digest_size=4).digest(), "little")
        (hold if h % mod == 0 else train).append(d)
    return train, hold


def rank_metrics(label: str, ranks: np.ndarray) -> dict:
    out = {"label": label,
           "recall@1": round(float(np.mean(ranks < 1)), 4),
           "recall@5": round(float(np.mean(ranks < 5)), 4),
           "recall@10": round(float(np.mean(ranks < 10)), 4),
           "mrr@10": round(float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0))), 4)}
    print(f"[eval] {label}: {out}", flush=True)
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--biencoder", required=True,
                    help="train_semantic --out dir (vocab.txt + ckpt/)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256, help="pairs per step")
    ap.add_argument("--seq-len", type=int, default=160)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=150)
    ap.add_argument("--hard-k", type=int, default=8,
                    help="bi-encoder top-k (non-target) mined as hard negatives")
    ap.add_argument("--mine-rounds", type=int, default=1,
                    help=">1 = iterative mining: after each round the CURRENT "
                         "cross-encoder re-scores each train query's bi-mined "
                         "candidate pool and its top-scoring non-targets "
                         "become the active hard negatives")
    ap.add_argument("--mine-pool", type=int, default=32,
                    help="bi-encoder candidate pool size the CE re-mines from")
    ap.add_argument("--mine-queries", type=int, default=8000,
                    help="train queries re-mined per round (rotating subset)")
    ap.add_argument("--neg-per-pos", type=int, default=3,
                    help="negatives per positive in each batch")
    ap.add_argument("--cand-k", type=int, default=20,
                    help="candidates reranked per held-out query at eval")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="steps between val rerank evals; the served ckpt "
                         "is the best val ensemble recall@10, not the last "
                         "step (0 = off)")
    ap.add_argument("--holdout-frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--no-biencoder-init", action="store_true",
                    help="ablation: train the trunk from scratch instead of "
                         "initializing it from the bi-encoder checkpoint")
    args = ap.parse_args(argv)
    # clamp the schedule before any expensive work: steps <= warmup makes
    # the cosine decay's steps non-positive, which would raise after mining
    if args.steps <= args.warmup:
        args.warmup = max(1, args.steps // 10)
        print(f"[train_reranker] warmup clamped to {args.warmup} "
              f"(steps={args.steps})", flush=True)
    return args


# ------------------------------------------------------------ setup


def extend_positions(pe: np.ndarray, seq_len: int, seed: int) -> np.ndarray:
    """The position table grown to `seq_len` rows by cyclic repeat, the new
    rows jittered by default_rng(seed + 17).normal(0, 0.02): tpu_rag's
    arithmetic, so the table is bit-equal to its."""
    pe = np.asarray(pe, np.float32)
    reps = -(-seq_len // pe.shape[0])
    ext = np.concatenate([pe] * reps, axis=0)[:seq_len]
    jit_rng = np.random.default_rng(seed + 17)
    ext[pe.shape[0]:] += jit_rng.normal(0, 0.02, ext[pe.shape[0]:].shape).astype(np.float32)
    return ext


def load_biencoder(args, device):
    """(BiEncoder, its trunk's state dict or None) from --biencoder: the
    spec from ckpt/config.json.  A ckpt that does not load raises unless
    --no-biencoder-init (then, as tpu_rag does, a seeded bi-encoder mines
    and ranks)."""
    from tpu_rag_torch.models.biencoder import BiEncoder
    from tpu_rag_torch.models.hf_import import load_bert_params, spec_from_hf_config

    vocab_path = os.path.join(args.biencoder, "vocab.txt")
    bi_ckpt = os.path.abspath(os.path.join(args.biencoder, "ckpt"))
    bi_spec = spec_from_hf_config(bi_ckpt)
    sd = load_bert_params(bi_ckpt, bi_spec) if bi_spec is not None else None
    if sd is None and not args.no_biencoder_init:
        raise FileNotFoundError(
            f"no readable bi-encoder checkpoint (config.json + model.safetensors) at "
            f"{bi_ckpt}; pass --no-biencoder-init to train the trunk from seeded weights")
    if sd is None:
        print(f"  no bi-encoder checkpoint at {bi_ckpt}: seeded bi-encoder", flush=True)
    bi = BiEncoder("minilm-l6-corpus", tokenizer_path=vocab_path, seq_len=128, batch=128,
                   spec=bi_spec if sd is not None else None, state_dict=sd, device=device)
    return bi, sd


def reranker_spec(args, vocab_size: int, bi_sd):
    """The cross-encoder's spec and initial trunk: MiniLM-L6 over the vocab,
    or the bi-encoder's architecture with its position table extended to
    --seq-len; clamps args.seq_len to the table."""
    from tpu_rag_torch.models.bert import BertSpec

    spec = BertSpec(hidden=384, layers=6, heads=12, ffn=1536, vocab_size=vocab_size,
                    max_len=max(args.seq_len, 128))
    if args.no_biencoder_init or bi_sd is None:
        return spec, None
    import torch

    from tpu_rag_torch.models.hf_import import spec_from_hf_config

    spec = spec_from_hf_config(os.path.join(args.biencoder, "ckpt"))
    bert = dict(bi_sd)
    if args.seq_len > spec.max_len:
        pe = bert["position_embeddings.weight"].numpy()
        bert["position_embeddings.weight"] = torch.from_numpy(
            extend_positions(pe, args.seq_len, args.seed))
        spec = dataclasses.replace(spec, max_len=args.seq_len)
        print(f"  position table extended {pe.shape[0]} -> {args.seq_len}")
    args.seq_len = min(args.seq_len, spec.max_len)
    print(f"  trunk initialized from the trained bi-encoder ckpt (seq_len -> {args.seq_len})")
    return spec, bert


def pair_rows(q: list[int], b: list[int], seq: int, rng, cls_id: int,
              sep_id: int) -> tuple[list[int], list[int]]:
    """[CLS] query [SEP] body-crop [SEP] and its segment ids.  The query is
    clamped so a few body tokens always fit; a body longer than the room
    left crops to its LEADING window 75% of the time (the view
    CrossEncoder.predict serves), else to a random window."""
    q = q[: max(1, seq - 8)]
    room = seq - len(q) - 3
    if len(b) > room:
        if rng.random() < 0.75:
            b = b[:room]
        else:
            start = int(rng.integers(0, len(b) - room + 1))
            b = b[start: start + room]
    ids = [cls_id] + q + [sep_id] + b + [sep_id]
    types = [0] * (len(q) + 2) + [1] * (len(b) + 1)
    return ids, types


def assemble_pairs(rows, seq: int, pad_id: int):
    ids = np.full((len(rows), seq), pad_id, np.int32)
    mask = np.zeros((len(rows), seq), np.int32)
    types = np.zeros((len(rows), seq), np.int32)
    for i, (r, t) in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
        types[i, : len(t)] = t
    return ids, mask, types


@dataclasses.dataclass
class Data:
    """The corpus as every stage reads it; `rng` is the one numpy stream
    that the crops and the batches draw from, in the reference's order."""
    docs: list[dict]
    train_docs: list[dict]
    holdout: list[dict]
    bodies: list[str]
    id_pos: dict[str, int]
    q_toks: list[list[int]]
    body_toks: list[list[int]]
    cls_id: int
    sep_id: int
    pad_id: int
    rng: np.random.Generator

    def row(self, gq: int, c: int, seq: int):
        """pair_rows of corpus row gq's query and corpus row c's body."""
        return pair_rows(self.q_toks[gq], self.body_toks[c], seq, self.rng,
                         self.cls_id, self.sep_id)

    def rows(self, meta, seq: int):
        """(ids, mask, types) of (query row, body row) corpus pairs."""
        return assemble_pairs([self.row(gq, c, seq) for gq, c in meta], seq, self.pad_id)


def make_data(args, docs, tok) -> Data:
    from tpu_rag_torch.models.tokenizer import PAD_ID

    train_docs, holdout = split_holdout(docs, args.holdout_frac)
    bodies = [d["body"] for d in docs]
    return Data(docs=docs, train_docs=train_docs, holdout=holdout, bodies=bodies,
                id_pos={d["id"]: i for i, d in enumerate(docs)},
                q_toks=[tok.tokenize_ids(d["query"])[:46] for d in docs],
                body_toks=[tok.tokenize_ids(b)[:400] for b in bodies],
                cls_id=getattr(tok, "cls_id", 1), sep_id=getattr(tok, "sep_id", 2),
                pad_id=getattr(tok, "pad_id", PAD_ID),
                rng=np.random.default_rng(args.seed))


def _top(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per row: the k best columns by score (desc), and their scores."""
    part = np.argpartition(-scores, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1)
    cols = np.take_along_axis(part, order, axis=1)
    return cols, np.take_along_axis(scores, cols, axis=1)


@dataclasses.dataclass
class Mined:
    tpos: np.ndarray                     # train doc -> corpus row
    hard_pool: list[np.ndarray]          # per train doc: bi-mined candidates
    hard: list[np.ndarray]               # per train doc: active hard negatives
    val_loc: np.ndarray                  # val slice (train doc positions)
    train_pool: np.ndarray               # train docs batches draw from
    val_tgt: np.ndarray
    val_cand: np.ndarray
    val_bi_sc: np.ndarray


def mine(args, data: Data, bi, demb: np.ndarray) -> Mined:
    """Hard negatives from the TRAIN split only (the held-out distractors
    are never seen in training), and the val slice (excluded from batches
    and re-mining) with its bi-encoder top cand_k train bodies."""
    train_docs = data.train_docs
    tpos = np.array([data.id_pos[d["id"]] for d in train_docs])
    demb_train = demb[tpos]
    tq = bi.embed([d["query"] for d in train_docs])
    pool_k = max(args.hard_k, args.mine_pool if args.mine_rounds > 1 else args.hard_k)
    hard_pool: list[np.ndarray] = []
    for i in range(0, len(train_docs), 512):
        scores = tq[i:i + 512] @ demb_train.T
        top = np.argpartition(-scores, pool_k + 1, axis=1)[:, : pool_k + 1]
        srt = np.argsort(-np.take_along_axis(scores, top, axis=1), axis=1)
        top = np.take_along_axis(top, srt, axis=1)
        for r, target in zip(top, tpos[i:i + 512]):
            cand = tpos[r]
            hard_pool.append(cand[cand != target][:pool_k])
    hard = [hp[: args.hard_k] for hp in hard_pool]

    val_n = min(1000, len(train_docs) // 10)
    stride = max(1, len(train_docs) // max(val_n, 1))
    val_loc = np.arange(0, len(train_docs), stride)[:val_n]
    val_set = set(int(i) for i in val_loc)
    train_pool = np.array([i for i in range(len(train_docs)) if i not in val_set])
    val_cand = np.empty((len(val_loc), args.cand_k), np.int64)
    val_bi_sc = np.empty((len(val_loc), args.cand_k), np.float32)
    for off in range(0, len(val_loc), 512):
        part, sc = _top(tq[val_loc[off:off + 512]] @ demb_train.T, args.cand_k)
        val_cand[off:off + 512] = tpos[part]
        val_bi_sc[off:off + 512] = sc
    return Mined(tpos=tpos, hard_pool=hard_pool, hard=hard, val_loc=val_loc,
                 train_pool=train_pool, val_tgt=tpos[val_loc], val_cand=val_cand,
                 val_bi_sc=val_bi_sc)


# ------------------------------------------------------------ training


def sample_batch(args, data: Data, mined: Mined, n_pos: int):
    """(ids, mask, types) of n_pos groups [positive, neg_per_pos negatives]:
    a hard negative 75% of the time, else a random train body.  Draws and
    crops interleave row by row, in tpu_rag's order."""
    rng, tpos = data.rng, mined.tpos
    rows = []
    for i in rng.choice(mined.train_pool, size=n_pos, replace=False):
        gq = data.id_pos[data.train_docs[i]["id"]]
        rows.append(data.row(gq, gq, args.seq_len))
        for _ in range(args.neg_per_pos):
            if len(mined.hard[i]) and rng.random() < 0.75:
                ni = int(rng.choice(mined.hard[i]))
            else:
                ni = int(tpos[rng.integers(0, len(tpos))])
                if ni == gq:  # train-split-only random negatives
                    ni = int(tpos[(rng.integers(0, len(tpos)))])
            rows.append(data.row(gq, ni, args.seq_len))
    return assemble_pairs(rows, args.seq_len, data.pad_id)


def score_pairs(args, data: Data, trainer, meta) -> np.ndarray:
    """The training module's scores of (query row, body row) pairs, 512 a
    forward."""
    out = np.empty(len(meta), np.float32)
    for off in range(0, len(meta), 512):
        chunk = meta[off:off + 512]
        out[off:off + len(chunk)] = trainer.score(*data.rows(chunk, args.seq_len))
    return out


def _zn(x: np.ndarray) -> np.ndarray:
    return ((x - x.mean(axis=1, keepdims=True))
            / np.maximum(x.std(axis=1, keepdims=True), 1e-6))


def val_eval(args, data: Data, mined: Mined, trainer) -> dict:
    """Rerank quality on the val slice: CE-alone recall@10 and the best
    ensemble recall@10 over the serving alpha grid."""
    meta = [(int(mined.tpos[v]), int(c))
            for j, v in enumerate(mined.val_loc) for c in mined.val_cand[j]]
    ce = score_pairs(args, data, trainer, meta).reshape(len(mined.val_loc), args.cand_k)

    def r10(order_sc: np.ndarray) -> float:
        hit = 0
        for j in range(len(mined.val_loc)):
            rr = mined.val_cand[j][np.argsort(-order_sc[j], kind="stable")]
            w = np.flatnonzero(rr == mined.val_tgt[j])
            hit += int(len(w) > 0 and w[0] < 10)
        return hit / max(len(mined.val_loc), 1)

    zb, zc = _zn(mined.val_bi_sc), _zn(ce)
    ens = {a: r10((1 - a) * zb + a * zc) for a in (0.2, 0.3, 0.4, 0.5)}
    best_a = max(ens, key=ens.get)
    return {"ce_alone": r10(ce), "ensemble": ens[best_a], "alpha": best_a,
            "bi": r10(mined.val_bi_sc)}


def remine(args, data: Data, mined: Mined, trainer, rnd: int) -> None:
    """Iterative mining: the current CE re-scores each selected train
    query's bi-mined pool; its top-scoring non-targets become the active
    negatives."""
    pool = mined.train_pool
    n_sel = min(args.mine_queries, len(pool))
    start = (rnd * n_sel) % len(pool)
    sel = [int(pool[(start + j) % len(pool)]) for j in range(n_sel)]
    meta = []
    for i in sel:
        gq = data.id_pos[data.train_docs[i]["id"]]
        meta.extend((gq, int(c)) for c in mined.hard_pool[i])
    scores = score_pairs(args, data, trainer, meta)
    ptr = 0
    for i in sel:
        m = len(mined.hard_pool[i])
        sc = scores[ptr:ptr + m]
        ptr += m
        mined.hard[i] = mined.hard_pool[i][np.argsort(-sc, kind="stable")[: args.hard_k]]


def make_trainer(args, spec, bert_sd, device):
    from tpu_rag_torch.device import compute_dtype
    from tpu_rag_torch.train.ranking import RankingTrainer

    return RankingTrainer(spec, lr=args.lr, warmup=args.warmup, steps=args.steps,
                          group=1 + args.neg_per_pos, compute_dtype=compute_dtype(device),
                          seed=args.seed, device=device, bert_state_dict=bert_sd)


def train(args, data: Data, mined: Mined, trainer, ckpt_path: str) -> dict:
    """The training loop: steps in --mine-rounds rounds (re-mining between
    them), val evals every --eval-every steps, the loss read and guarded
    every 100; then the best val checkpoint, saved to ckpt_path."""
    n_pos = args.batch // trainer.group
    t0 = time.time()
    rounds = max(1, args.mine_rounds)
    bounds = [args.steps * (r + 1) // rounds for r in range(rounds)]
    step, losses, vals = 0, [], []
    for rnd in range(rounds):
        while step < bounds[rnd]:
            loss = trainer.train_step(*sample_batch(args, data, mined, n_pos))
            losses.append(loss)
            if args.eval_every and step > 0 and step % args.eval_every == 0:
                ev = val_eval(args, data, mined, trainer)
                tag = "  <- best" if trainer.offer(step, ev) else ""
                vals.append({**ev, "step": step})
                print(f"  [val @{step}] ce_alone {ev['ce_alone']:.4f}  "
                      f"ensemble {ev['ensemble']:.4f} (alpha {ev['alpha']})  "
                      f"bi {ev['bi']:.4f}{tag}", flush=True)
            if step % 100 == 0 or step == args.steps - 1:
                print(f"  step {step:5d}  loss {loss:.4f}  ({time.time() - t0:.0f}s)",
                      flush=True)
                snapshot_step = trainer.snapshot_step
                if trainer.guard(step, loss):
                    print(f"  [rollback] loss pinned at chance (~{trainer.chance:.4f}) — restoring "
                          f"step-{snapshot_step} snapshot, peak lr -> "
                          f"{args.lr * trainer.lr_mult:.2e}", flush=True)
            step += 1
        if rnd < rounds - 1:
            tm = time.time()
            remine(args, data, mined, trainer, rnd)
            print(f"  [mine round {rnd + 1}] re-mined "
                  f"{min(args.mine_queries, len(data.train_docs))} queries "
                  f"with the current CE ({time.time() - tm:.0f}s)", flush=True)
    restored = False
    if trainer.best["params"] is not None:
        fin = val_eval(args, data, mined, trainer)
        restored = trainer.restore_best(fin)
        if restored:
            best = trainer.best
            print(f"  restoring best checkpoint (step {best['step']}: val ensemble "
                  f"{best['ensemble']:.4f} / ce_alone {best['ce_alone']:.4f}; final was "
                  f"{fin['ensemble']:.4f} / {fin['ce_alone']:.4f})", flush=True)
    trainer.save(ckpt_path)
    print(f"checkpoint -> {ckpt_path}")
    return {"losses": losses, "val": vals, "best_step": trainer.best["step"],
            "restored_best": restored, "rollbacks": trainer.rollbacks,
            "skipped_steps": trainer.skipped}


# ------------------------------------------------------------ eval


def _candidates(qemb: np.ndarray, demb: np.ndarray, k: int):
    """The bi-encoder's top k corpus rows of each query, and their scores."""
    cand = np.empty((len(qemb), k), np.int64)
    cand_sc = np.empty((len(qemb), k), np.float32)
    for i in range(0, len(qemb), 256):
        cand[i:i + 256], cand_sc[i:i + 256] = _top(qemb[i:i + 256] @ demb.T, k)
    return cand, cand_sc


def heldout_lift(args, data: Data, bi, demb: np.ndarray, ckpt_path: str, spec,
                 vocab_path: str, device):
    """Rerank the bi-encoder's top cand_k of held-out queries with the
    trained CE (the serving CrossEncoder, spec from the checkpoint's
    config.json), the ensemble with alpha tuned on train_docs[-2000:], and
    the seeded CE.  Returns (rows, alpha, val curve)."""
    from tpu_rag_torch.models.crossencoder import CrossEncoder

    holdout = data.holdout
    qemb = bi.embed([d["query"] for d in holdout])
    targets = np.array([data.id_pos[d["id"]] for d in holdout])
    cand, cand_sc = _candidates(qemb, demb, args.cand_k)
    base_ranks = np.empty(len(holdout), np.int64)
    for i in range(0, len(holdout), 256):
        scores = qemb[i:i + 256] @ demb.T
        own = scores[np.arange(len(scores)), targets[i:i + 256]]
        base_ranks[i:i + 256] = (scores > own[:, None]).sum(axis=1)

    def ranks_from(order_scores: np.ndarray) -> np.ndarray:
        ranks = np.full(len(holdout), 10**6, np.int64)
        for i in range(len(holdout)):
            hit = np.flatnonzero(cand[i][np.argsort(-order_scores[i], kind="stable")]
                                 == targets[i])
            if len(hit):
                ranks[i] = hit[0]
        return ranks

    def rerank_ranks(ce, label: str):
        pairs = [(d["query"], data.bodies[int(c)]) for i, d in enumerate(holdout)
                 for c in cand[i]]
        t0 = time.time()
        flat = ce.predict(pairs).reshape(len(holdout), args.cand_k)
        print(f"  scored {len(pairs)} pairs in {time.time() - t0:.0f}s", flush=True)
        return rank_metrics(label, ranks_from(flat)), flat

    results = [rank_metrics("biencoder_top20_no_rerank",
                            np.where(base_ranks < args.cand_k, base_ranks, 10**6))]
    trained_ce = CrossEncoder("minilm-l6-rerank", weights_path=ckpt_path,
                              tokenizer_path=vocab_path, seq_len=args.seq_len, batch=256,
                              device=device)
    row, ce_scores = rerank_ranks(trained_ce, "trained_reranker")
    results.append(row)
    # alpha is tuned on a VALIDATION slice of the TRAIN split, then applied
    # once to the holdout: the tuned value ships as RERANK_ENSEMBLE_ALPHA
    val_docs = data.train_docs[-2000:]
    vcand, vcand_sc = _candidates(bi.embed([d["query"] for d in val_docs]), demb,
                                  args.cand_k)
    vtargets = np.array([data.id_pos[d["id"]] for d in val_docs])
    vce = trained_ce.predict([(d["query"], data.bodies[int(c)])
                              for i, d in enumerate(val_docs) for c in vcand[i]]
                             ).reshape(len(val_docs), args.cand_k)

    def val_recall10(alpha: float) -> float:
        blend = alpha * _zn(vce) + (1 - alpha) * _zn(vcand_sc)
        hits = 0
        for i in range(len(val_docs)):
            hits += int(vtargets[i] in vcand[i][np.argsort(-blend[i], kind="stable")][:10])
        return hits / len(val_docs)

    alphas = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7]
    val_curve = {a: round(val_recall10(a), 4) for a in alphas}
    best_alpha = max(alphas, key=lambda a: val_curve[a])
    print(f"  ensemble alpha tuning (val recall@10): {val_curve} -> alpha={best_alpha}",
          flush=True)
    results.append(rank_metrics(f"ensemble_bi+trained_ce(alpha={best_alpha})",
                                ranks_from(best_alpha * _zn(ce_scores)
                                           + (1 - best_alpha) * _zn(cand_sc))))
    results.append(rank_metrics("ensemble_bi+trained_ce",
                                ranks_from(_zn(cand_sc) + _zn(ce_scores))))
    del trained_ce
    random_ce = CrossEncoder("minilm-l6-rerank", tokenizer_path=vocab_path,
                             seq_len=args.seq_len, batch=256, spec=spec, device=device)
    results.append(rerank_ranks(random_ce, "random_weights_round1")[0])
    return results, best_alpha, val_curve


def probe_pairs(data: Data, n: int) -> list[tuple[str, str]]:
    """The first n // 2 held-out queries with their own body, then the same
    queries with the next body of the corpus."""
    probe = data.holdout[:n // 2]
    nb = len(data.bodies)
    return ([(d["query"], data.bodies[data.id_pos[d["id"]]]) for d in probe]
            + [(d["query"], data.bodies[(data.id_pos[d["id"]] + 1) % nb]) for d in probe])


def logit_spread(logits: np.ndarray) -> dict:
    """The spread of a reranker's logits over probe_pairs: their std, and
    the mean of (own body - neighbour's body); both ~0 on constant logits,
    which a collapsed reranker gives whatever the pair."""
    half = len(logits) // 2
    return {"card_logit_std": float(logits.std()),
            "own_body_minus_neighbour_mean": float((logits[:half] - logits[half:]).mean())}


def write_report(args, data: Data, results: list[dict], best_alpha: float,
                 val_curve: dict, ckpt_path: str, vocab_path: str) -> dict:
    """rerank.json and RERANK.md in --out."""
    n_hold = len(data.holdout)
    report = {
        "task": "rerank the trained bi-encoder's top-20 on held-out "
                "docstring summary -> body retrieval",
        "corpus_docs": len(data.docs), "holdout_queries": n_hold,
        "train_steps": args.steps, "batch_pairs": args.batch,
        "hard_negatives": args.hard_k, "mine_rounds": args.mine_rounds,
        "ensemble_alpha": best_alpha, "ensemble_alpha_val_curve": val_curve,
        "results": results,
        "serving": {"RERANK_WEIGHTS": ckpt_path, "TOKENIZER_PATH": vocab_path,
                    "RERANK_ENSEMBLE_ALPHA": best_alpha},
    }
    with open(os.path.join(args.out, "rerank.json"), "w") as f:
        json.dump(report, f, indent=2)
    lines = ["| ranking | recall@1 | recall@5 | recall@10 | MRR@10 |",
             "|---|---|---|---|---|"]
    for r in results:
        lines.append(f"| {r['label']} | {r['recall@1']} | {r['recall@5']} "
                     f"| {r['recall@10']} | {r['mrr@10']} |")
    table = "\n".join(lines)
    with open(os.path.join(args.out, "RERANK.md"), "w") as f:
        f.write(f"# Reranker quality\n\n{json.dumps(report['task'])}, "
                f"{n_hold} held-out queries\n\n{table}\n")
    print(table)
    return report


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.models.tokenizer import load_tokenizer

    device = resolve(args.device)
    vocab_path = os.path.join(args.biencoder, "vocab.txt")
    ckpt_path = os.path.abspath(os.path.join(args.out, "ckpt"))
    docs = load_corpus(args.corpus)
    tok = load_tokenizer(vocab_path, vocab_size=30522)
    data = make_data(args, docs, tok)
    print(f"corpus: {len(docs)} docs -> {len(data.train_docs)} train / "
          f"{len(data.holdout)} holdout")
    os.makedirs(args.out, exist_ok=True)

    print("[1/4] embedding corpus with the trained bi-encoder (hard-negative "
          "mining + eval candidates) ...", flush=True)
    bi, bi_sd = load_biencoder(args, device)
    demb = bi.embed(data.bodies)
    spec, bert_sd = reranker_spec(args, getattr(tok, "vocab_size", 30522),
                                  None if args.eval_only else bi_sd)
    if not args.eval_only:
        print("[2/4] mining hard negatives (bi-encoder top non-target bodies, "
              "train split only) ...", flush=True)
        mined = mine(args, data, bi, demb)
        print(f"[3/4] ranking training: {args.steps} steps x {args.batch} pairs "
              f"(groups of 1 pos + {args.neg_per_pos} negs) on {device} ...", flush=True)
        trainer = make_trainer(args, spec, bert_sd, device)
        train(args, data, mined, trainer, ckpt_path)
        del trainer

    print("[4/4] rerank lift on held-out retrieval ...", flush=True)
    results, best_alpha, val_curve = heldout_lift(args, data, bi, demb, ckpt_path, spec,
                                                  vocab_path, device)
    return write_report(args, data, results, best_alpha, val_curve, ckpt_path, vocab_path)


if __name__ == "__main__":
    main()
