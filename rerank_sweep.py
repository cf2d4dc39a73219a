#!/usr/bin/env python3
"""Reranker training variants on one NVIDIA GPU: where the ranking loss
goes, and whether the cross-encoder's CLS vector carries the pair.

    python3 rerank_sweep.py                  # the default variants below
    python3 rerank_sweep.py --variants bf16:3e-4:40:400 --biencoder-steps 300,1500

Builds make_corpus's 20,000 docstrings of the installed packages, trains
the bi-encoder with train_semantic's recipe at MiniLM-L6 width for each of
--biencoder-steps, then trains the reranker with train_reranker's pieces
(mining, batches, val evals every 100 steps) once per variant
dtype:lr:warmup:steps.  Every 50 steps it prints the mean loss of those
steps beside ln(group), the last step's gradient norm before clipping, the
spread of the logits within a group and across the batch, and the spread
of the CLS vector across the batch (its per-feature std, averaged): a
trunk whose CLS no longer depends on the pair scores every pair alike.
One JSON line per variant ends it.  It needs the card and the repository
beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEFAULT_VARIANTS = "bf16:3e-4:40:400,f32:3e-4:40:400,bf16:3e-5:40:300"


def semantic(work: Path, corpus: Path, steps: int, device):
    """train_semantic's recipe for `steps` steps: (its --out dir, tokenizer)."""
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts import train_semantic as ts

    out = work / f"semantic{steps}"
    args = ts.parse_args(["--corpus", str(corpus), "--out", str(out), "--steps", str(steps),
                          "--warmup", str(max(30, steps // 15))])
    out.mkdir()
    docs = ts.load_corpus(str(corpus))
    train_docs, _ = ts.split_holdout(docs, args.holdout_frac)
    ts.build_vocab(docs, args, str(out / "vocab.txt"))
    tok = load_tokenizer(str(out / "vocab.txt"), vocab_size=args.vocab_size)
    sample = ts.batch_sampler(train_docs, tok, args)
    trainer = ts.make_trainer(args, ts.semantic_spec(args), device)
    for _ in range(args.steps):
        loss = trainer.train_step(sample())
    trainer.save(str(out / "ckpt"))
    print(f"bi-encoder {steps} steps: loss {loss:.4f}", flush=True)
    return out, tok


def variant(work: Path, corpus: Path, sem: Path, tok, spec_str: str, device) -> dict:
    import numpy as np
    import torch

    from tpu_rag_torch.scripts import train_reranker as tr
    from tpu_rag_torch.train import ranking

    dtype, lr, warmup, steps = spec_str.split(":")
    name = f"{sem.name}:{spec_str}"
    args = tr.parse_args(["--corpus", str(corpus), "--biencoder", str(sem), "--out",
                          str(work / f"rr_{sem.name}_{spec_str.replace(':', '_')}"),
                          "--lr", lr, "--warmup", warmup, "--steps", steps,
                          "--eval-every", "100", "--device", "cuda"])
    data = tr.make_data(args, tr.load_corpus(args.corpus), tok)
    bi, bi_sd = tr.load_biencoder(args, device)
    demb = bi.embed(data.bodies)
    spec, bert_sd = tr.reranker_spec(args, tok.vocab_size, bi_sd)
    mined = tr.mine(args, data, bi, demb)
    del bi, demb
    trainer = ranking.RankingTrainer(
        spec, lr=args.lr, warmup=args.warmup, steps=args.steps, group=1 + args.neg_per_pos,
        compute_dtype={"bf16": torch.bfloat16, "f32": torch.float32}[dtype],
        seed=args.seed, device=device, bert_state_dict=bert_sd)

    norms, seen = [], {}
    clip = ranking.clip_by_global_norm_

    def clip_seen(grads, max_norm):
        norm = clip(grads, max_norm)
        norms.append(float(norm))
        return norm

    ranking.clip_by_global_norm_ = clip_seen
    step = trainer.train_step
    losses = []

    def logged(ids, mask, types):
        loss = step(ids, mask, types)
        losses.append(loss)
        n = len(losses)
        if n % 50 == 0 or n == 1:
            with torch.no_grad():
                t = [torch.as_tensor(np.asarray(a)).to(device, torch.int64)
                     for a in (ids, mask, types)]
                cls = trainer.module.bert(*t)[:, 0, :].float()
                logits = trainer.module(*t).reshape(-1, trainer.group)
            seen.update({"step": n, "loss_mean50": float(np.mean(losses[-50:])),
                         "grad_norm": norms[-1], "chance": trainer.chance,
                         "logit_std_in_group": float(logits.std(dim=1).mean()),
                         "logit_std": float(logits.std()),
                         "cls_std_across_batch": float(cls.std(dim=0).mean())})
            print(f"  {name} {json.dumps(seen)}", flush=True)
        return loss

    trainer.train_step = logged
    t0 = time.perf_counter()
    try:
        summary = tr.train(args, data, mined, trainer, str(work / "ckpt_unused"))
    finally:
        ranking.clip_by_global_norm_ = clip
    out = {"variant": name, "seconds": time.perf_counter() - t0,
           "first20": float(np.mean(losses[:20])), "last20": float(np.mean(losses[-20:])),
           "val": [[v["step"], v["ce_alone"], v["ensemble"], v["bi"]] for v in summary["val"]],
           "last_reading": seen}
    print(json.dumps(out), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma-separated dtype:lr:warmup:steps (dtype bf16 or f32)")
    ap.add_argument("--biencoder-steps", default="300",
                    help="comma-separated step counts of the bi-encoders to start from")
    ap.add_argument("--late-variants", default="bf16:3e-4:40:300",
                    help="variants run over the bi-encoders after the first")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available() or not (REPO / "tpu_rag_torch").is_dir():
        print("rerank_sweep: needs a CUDA device and the repository beside it",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="rerank_sweep_", dir=REPO / "build") as tmp:
        work = Path(tmp)
        corpus = work / "corpus.jsonl"
        subprocess.run([sys.executable, "-m", "tpu_rag_torch.scripts.make_corpus", "--out",
                        str(corpus), "--max-docs", "20000"], cwd=REPO, check=True)
        for i, steps in enumerate(int(s) for s in args.biencoder_steps.split(",")):
            sem, tok = semantic(work, corpus, steps, device)
            for spec_str in (args.variants if i == 0 else args.late_variants).split(","):
                variant(work, corpus, sem, tok, spec_str, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
