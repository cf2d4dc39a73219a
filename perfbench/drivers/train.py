"""Contrastive training: `ContrastiveTrainer.train_step` at the
configuration's `train` settings (scripts/train_semantic.py's: batch,
query and document lengths, tau, AdamW under warm-up and cosine decay).

Set-up: a corpus of `docs` documents is drawn from the seed (a body of
whole words, and a summary of words taken from it in order, each as many
tokens long as the traffic's measured lengths say), train_semantic's own
batch sampler tokenises it with the program's tokenizer, and a trainer is
built with the configuration's weights drawn from the seed on the card.
Its first three steps run through train_step on the sampler's first three
batches.  They warm every shape and give the readings the reference is
held to: the three losses, each leaf's first gradient
(AdamW's first moment after one step, over 1 - beta1) and each leaf's
change after the three steps.  The window then runs the sampler and a
step, as train_semantic's loop does, until `seconds` have passed; the rate
counts the real (non-pad) tokens of every step.  The reference redraws the
first three batches from the same texts with its own tokenizer
(reference/train.py's `batches`).

Traffic keys: docs, body_tokens and summary_tokens (length specs,
textgen.py), slice_s.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np


def corpus(tr: dict, seed: int) -> list[dict]:
    """{"query", "body"} texts of the traffic's documents, from the seed:
    a body of the measured body lengths in whole words, and a summary of
    the measured summary lengths, words taken from the body in order."""
    from perfbench import textgen

    vw = textgen.words()
    rng = np.random.default_rng([int(seed), 4])
    n = tr["docs"]
    blens = textgen.lengths(n, tr["body_tokens"], rng)
    slens = textgen.lengths(n, tr["summary_tokens"], rng)
    out = []
    for body_ids, sl in zip(textgen.word_ids(blens, len(vw), rng), slens):
        keep = np.sort(rng.choice(len(body_ids), size=min(int(sl), len(body_ids)),
                                  replace=False))
        out.append({"query": textgen.join(vw, body_ids[keep]),
                    "body": textgen.join(vw, body_ids)})
    return out


def sampler_args(tcfg: dict, seed: int) -> SimpleNamespace:
    """train_semantic's arguments that its batch sampler reads."""
    return SimpleNamespace(batch=tcfg["batch"], q_len=tcfg["query_len"],
                           seq_len=tcfg["doc_len"], crop_prob=tcfg["crop_prob"], seed=int(seed))


def run(ctx) -> dict:
    import torch

    from perfbench import common, judge, roofline, textgen, weights
    from perfbench.reference import bert as ref_bert
    from perfbench.reference import train as ref_train
    from perfbench.reference.tokenizer import WordPiece
    from perfbench.trace import Slice, Spans
    from tpu_rag_torch.device import compute_dtype
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts.train_semantic import batch_sampler
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    tcfg = cfg["train"]

    # ---- set-up: corpus, tokens, trainer, its first three steps
    marks = [("start", time.monotonic())]
    docs = corpus(tr, seed)
    tok = load_tokenizer(str(textgen.VOCAB), vocab_size=cfg["vocab_size"])
    marks.append(("corpus", time.monotonic()))
    sampler = batch_sampler(docs, tok, sampler_args(tcfg, seed))
    marks.append(("tokenize", time.monotonic()))
    lr = warmup_cosine_decay(0.0, tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    trainer = ContrastiveTrainer(common.port_spec(cfg), lr=lr, tau=tcfg["tau"],
                                 compute_dtype=compute_dtype(dev), device=dev)
    w = weights.seeded_bert(cfg, seed, dev)
    trainer.module.load_state_dict(w)
    del w
    marks.append(("trainer", time.monotonic()))
    params = dict(trainer.module.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses = [trainer.train_step(sampler())]
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    # a step that left no optimizer state reads as a first gradient of 0
    grad = {k: float(trainer.optimizer.state.get(p, {}).get("exp_avg", torch.zeros(1)).norm())
            / (1.0 - beta1) for k, p in params.items()}
    losses += [trainer.train_step(sampler()) for _ in range(2)]
    update = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    del start
    prog = {"losses": losses, "grad": grad, "update": update}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("three steps", time.monotonic()))

    # ---- the window: whole steps
    tokens, steps, bad, slice_steps, sl, traced, spans = 0, 0, 0, [], None, None, Spans()
    done: list[tuple[float, float]] = []
    t0 = time.monotonic()
    while True:
        if ctx.trace and sl is None and traced is None \
                and time.monotonic() - t0 >= (ctx.seconds - tr["slice_s"]) / 2:
            sl = Slice(ctx.tmpdir)
            sl.start()
        with spans("train_semantic.batch_sampler"):
            batch = sampler()
        with spans("ContrastiveTrainer.train_step"):
            loss = trainer.train_step(batch)
        bad += not np.isfinite(loss)
        steps += 1
        step_tokens = int(batch["q_mask"].sum()) + int(batch["d_mask"].sum())
        tokens += step_tokens
        done.append((time.monotonic(), step_tokens))
        if sl is not None:
            slice_steps.append((batch["q_mask"].sum(1), batch["d_mask"].sum(1)))
            if time.monotonic() - sl.t0 >= tr["slice_s"]:
                sl.stop()
                traced, sl = sl, None
        if time.monotonic() - t0 >= ctx.seconds and sl is None:
            break
    elapsed = time.monotonic() - t0
    setup_s = t0 - ctx.t_start
    peak = common.memory_peak(dev)
    trace = traced.read(spans) if traced is not None else None
    ctx.log("set-up s: " + ", ".join(f"{name} {t - p:.2f}" for (_, p), (name, t) in
                                     zip(marks, marks[1:])) + f"; in all {setup_s:.2f}; "
            f"tokens/s by sixths of the window: {common.segment_rates(done, t0, ctx.seconds)}")
    del trainer, params
    common.free_device()

    # ---- judged: the first three steps against the plain reference's
    rtok = WordPiece(textgen.VOCAB)
    ref_batches = [{k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
                   for b in ref_train.batches(docs, rtok.ids, tcfg, seed, rtok.special, 3)]
    w = weights.seeded_bert(cfg, seed, dev)
    with ref_bert.f32_matmul():
        ref = ref_train.three_steps(w, cfg, ref_batches, tcfg)
    del w, ref_batches
    common.free_device()
    nums = judge.train_numbers(prog, ref)
    lim = ctx.limits
    checks = [("failed_steps", float(bad), 0.0),
              ("loss_gap", nums["loss_gap"], lim["loss_gap"]),
              ("grad_gap", nums["grad_gap"], lim["grad_gap"]),
              ("update_gap", nums["update_gap"], lim["update_gap"])]
    ctx.log(f"worst leaves: gradient {nums['grad_leaf']}, change {nums['update_leaf']}; "
            f"left out (no reference gradient): {nums['leaves_left_out']}")

    layer = {"trace": trace, "partial": ["the profiler lost a slice marker"]
             if trace is not None and trace.lost else []}
    if trace is not None:
        layer["flops"] = sum(roofline.train_step_flops(cfg, q.tolist(), d.tolist())
                             for q, d in slice_steps)
    return {"e2e": {"train_tokens_per_s": tokens / elapsed, "setup_s": setup_s},
            "layer_data": layer, "checks": checks, "attempted": steps, "failed": bad,
            "memory_peak_bytes": peak, "device_kind": common.device_kind(dev)}
