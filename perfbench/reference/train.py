"""Plain float32 contrastive training steps of the BERT bi-encoder.

In-batch InfoNCE (logits q . d^T / tau, labels on the diagonal, the mean
of the row-wise and column-wise cross-entropy) on the reference trunk's
embeddings (reference/bert.py), the gradient by autograd, and AdamW as
Loshchilov & Hutter define it with bias correction (betas 0.9 / 0.999, eps
1e-8 added to the corrected second moment's square root, decoupled weight
decay scaled by the step's learning rate), under a linear warm-up from 0
and a cosine decay to `end` (the configuration's schedule).  `quant`
rounds the operands of every product (the control); `keep_rows` keeps
only the first rows of every batch (a fault: half the batch left out).

`batches` redraws the training batches from the documents' texts, with
this reference's own tokenizer, by train_semantic's rule and in the order
of its random draws (numpy's default_rng of the seed): `batch` distinct
documents; for each, the query is a crop of 6 to query_len - 2 tokens of
the body where a uniform draw falls under crop_prob or the summary is
empty, and the summary otherwise; the document a crop of 32 to doc_len - 2
tokens of the body; a crop's width is drawn first, and its start only
where the body is longer than it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import bert


def batches(docs: list[dict], ids, tcfg: dict, seed: int, special: tuple[int, int, int],
            count: int, body_cut: int = 320) -> list[dict]:
    """The first `count` batches ({q_ids, q_mask, d_ids, d_mask}, int32)
    over docs ({"query", "body"} texts) tokenised by `ids`; only the drawn
    documents are tokenised."""
    cls_id, sep_id, pad_id = special
    ql, dl = tcfg["query_len"], tcfg["doc_len"]
    rng = np.random.default_rng(int(seed))
    toks: dict[int, tuple[list[int], list[int]]] = {}

    def doc(i: int):
        if i not in toks:
            toks[i] = (ids(docs[i]["body"])[:body_cut], ids(docs[i]["query"])[:ql - 2])
        return toks[i]

    def crop(t: list[int], lo: int, hi: int) -> list[int]:
        w = int(rng.integers(min(lo, hi), hi + 1))
        if len(t) <= w:
            return t
        s = int(rng.integers(0, len(t) - w + 1))
        return t[s:s + w]

    def assemble(rows: list[list[int]], seq: int):
        out_ids = np.full((len(rows), seq), pad_id, np.int32)
        mask = np.zeros((len(rows), seq), np.int32)
        for j, r in enumerate(rows):
            row = [cls_id, *r[:seq - 2], sep_id]
            out_ids[j, :len(row)] = row
            mask[j, :len(row)] = 1
        return out_ids, mask

    out = []
    for _ in range(count):
        q_rows, d_rows = [], []
        for i in rng.choice(len(docs), size=tcfg["batch"], replace=False):
            body, summ = doc(int(i))
            q_rows.append(crop(body, 6, ql - 2) if rng.random() < tcfg["crop_prob"] or not summ
                          else summ)
            d_rows.append(crop(body, 32, dl - 2))
        (q_ids, q_mask), (d_ids, d_mask) = assemble(q_rows, ql), assemble(d_rows, dl)
        out.append({"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask})
    return out


def schedule(peak: float, warmup: int, steps: int, end: float):
    """lr at a step count: 0 -> peak over `warmup`, cosine to `end` by `steps`."""
    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        frac = min(step - warmup, steps - warmup) / (steps - warmup)
        return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))
    return lr


def info_nce(q: torch.Tensor, d: torch.Tensor, tau: float) -> torch.Tensor:
    logits = q @ d.T / tau
    labels = torch.arange(q.shape[0], device=q.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def three_steps(w0: dict[str, torch.Tensor], cfg: dict, batches: list[dict], tcfg: dict,
                quant=None, keep_rows: int | None = None,
                betas=(0.9, 0.999), eps: float = 1e-8, wd: float = 1e-4) -> dict:
    """Train from w0 over `batches` ({q_ids, q_mask, d_ids, d_mask} int
    tensors on w0's device).  Returns the losses, every leaf's norm of the
    first gradient and of the change after the last step."""
    lr = schedule(tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    losses, grad_norms = [], {}
    for step, b in enumerate(batches):
        rows = slice(0, keep_rows)
        q = bert.embed(params, cfg, b["q_ids"][rows], b["q_mask"][rows], quant)
        d = bert.embed(params, cfg, b["d_ids"][rows], b["d_mask"][rows], quant)
        loss = info_nce(q, d, tcfg["tau"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in zip(params, grads)}
        rate, t = lr(step), step + 1
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                p.mul_(1.0 - rate * wd)
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (v2[k] / (1 - betas[1] ** t)).sqrt().add_(eps)
                p.addcdiv_(m[k], denom, value=-rate / (1 - betas[0] ** t))
    update = {k: float((params[k].detach() - w0[k]).norm()) for k in params}
    return {"losses": losses, "grad": grad_norms, "update": update}
