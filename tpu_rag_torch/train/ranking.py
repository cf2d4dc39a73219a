"""Grouped-softmax ranking training of the cross-encoder on one device: the
step, the optimiser and the divergence guard that scripts/train_reranker.py
of the JAX package writes inline (its lines 316-352 and 459-531).

- Loss: each group of 1 + neg_per_pos logits is [positive, negatives...];
  softmax cross-entropy with label 0, averaged over the groups.
- Optimiser: optax.apply_if_finite(chain(clip_by_global_norm(1.0),
  adamw(schedule)), max_consecutive_errors=100) with schedule =
  warmup_cosine_decay(0, lr * mult, warmup, steps, lr * mult * 0.02):
  - clipping by optax's rule, g / |g| * max only where |g| >= max, with no
    epsilon (torch.nn.utils.clip_grad_norm_ divides by |g| + 1e-6);
  - a step whose gradients hold a non-finite value touches neither the
    parameters, AdamW's moments nor the count that drives the schedule,
    until more than 100 such steps in a row: then it is applied, as optax
    gives up and applies it.
- Model: `CrossEncoderModule(flash=False)` (kernel #5 has no backward, nor
  has tpu_rag's) with f32 parameters and `compute_dtype` compute (bf16 on
  the card, f32 on the CPU).
- Guard: a device copy of the parameters refreshed every 500 steps while
  the 100-step loss reading is healthy; past step max(warmup + 600, 1000)
  a reading at or above ln(group) - 0.03, or non-finite, is "at chance",
  and four in a row restore the copy, halve the peak lr, reset AdamW and
  restart the schedule's count at 0.
- Best-val keeping by (ensemble, ce_alone) tuples; `save` writes a HF
  BertForSequenceClassification directory (models/hf_export.py), which
  the serving CrossEncoder loads without a spec.

Initial weights come from a torch.Generator seeded by `seed`, the trunk
from `bert_state_dict` where given (the bi-encoder checkpoint); flax's init
cannot be redrawn, so parity tests start from
`cross_encoder_params_from_flax` of a tpu_rag tree.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rag_torch.device import resolve
from tpu_rag_torch.models.bert import BertSpec
from tpu_rag_torch.models.biencoder import seeded_state_dict
from tpu_rag_torch.models.crossencoder import CrossEncoderModule
from tpu_rag_torch.models.hf_export import save_cross_encoder
from tpu_rag_torch.train.contrastive import adamw, warmup_cosine_decay

MAX_NORM = 1.0
MAX_CONSECUTIVE_ERRORS = 100
SNAPSHOT_EVERY = 500
AT_CHANCE_MARGIN = 0.03
AT_CHANCE_READINGS = 4


def ranking_loss(logits: torch.Tensor, group: int) -> torch.Tensor:
    """Mean softmax cross-entropy of (n_pos, group) logit groups, label 0."""
    g = logits.to(torch.float32).reshape(-1, group)
    return F.cross_entropy(g, torch.zeros(g.shape[0], dtype=torch.int64, device=g.device))


def _ids(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device, torch.int64)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm is at
    least max_norm, every gradient becomes (g / norm) * max_norm.  Returns
    the norm.  No host sync: below the limit the division and product are
    by 1, which is exact."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class RankingTrainer:
    def __init__(self, spec: BertSpec, *, lr: float, warmup: int, steps: int,
                 group: int, compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                 device: str | torch.device = "cuda",
                 bert_state_dict: dict[str, torch.Tensor] | None = None) -> None:
        self.device = resolve(device)
        self.spec = spec
        self.lr, self.warmup, self.steps, self.group = lr, warmup, steps, group
        self.chance = float(np.log(group))
        self.module = CrossEncoderModule(spec, flash=False, compute_dtype=compute_dtype)
        sd = seeded_state_dict(self.module, spec.hidden, seed)
        if bert_state_dict is not None:
            sd.update({"bert." + k: v for k, v in bert_state_dict.items()})
        self.module.load_state_dict(sd)
        self.module.to(self.device).train()
        self.lr_mult = 1.0
        self.notfinite_count = 0
        self.skipped = 0                  # non-finite steps skipped in all
        self.rollbacks = 0
        self._reset_optimizer()
        self.snapshot, self.snapshot_step = self._copy(), 0
        self.at_chance = 0
        self.best = {"ensemble": -1.0, "ce_alone": -1.0, "step": -1, "params": None}

    # ------------------------------------------------------------ optimiser

    def _reset_optimizer(self) -> None:
        """AdamW's moments and the schedule's count from zero, the schedule
        peaking at lr * lr_mult (the reference rebuilds its optax chain)."""
        peak = self.lr * self.lr_mult
        self.schedule = warmup_cosine_decay(0.0, peak, self.warmup, self.steps, peak * 0.02)
        self.count = 0
        self.optimizer = adamw(self.module.parameters())

    def _copy(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def train_step(self, ids, mask, types) -> float:
        """One update on a batch of n_pos groups of `group` rows ((B, T) int
        arrays, each group [positive, negatives...]); returns the loss
        before it."""
        dev = self.device
        self.optimizer.zero_grad(set_to_none=True)
        loss = ranking_loss(self.module(_ids(ids, dev), _ids(mask, dev), _ids(types, dev)),
                            self.group)
        loss.backward()
        grads = [p.grad for p in self.module.parameters()]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS:
            clip_by_global_norm_(grads, MAX_NORM)
            for g in self.optimizer.param_groups:
                g["lr"] = float(self.schedule(self.count))
            self.optimizer.step()
            self.count += 1
        else:
            self.skipped += 1
        return float(loss.detach())

    # ------------------------------------------------------------ guard

    def guard(self, step: int, loss: float) -> bool:
        """The 100-step reading at `step` (the caller reads every 100th step
        and the last).  Returns True where it rolled back."""
        if step <= max(self.warmup + 600, 1000):
            return False
        if loss >= self.chance - AT_CHANCE_MARGIN or not math.isfinite(loss):
            self.at_chance += 1
        else:
            self.at_chance = 0
            if step % SNAPSHOT_EVERY == 0:
                self.snapshot, self.snapshot_step = self._copy(), step
        if self.at_chance < AT_CHANCE_READINGS:
            return False
        self.lr_mult *= 0.5
        self.module.load_state_dict(self.snapshot)
        self._reset_optimizer()
        self.at_chance = 0
        self.rollbacks += 1
        return True

    # ------------------------------------------------------------ best val

    def offer(self, step: int, ev: dict) -> bool:
        """Keep a copy of the parameters if the val reading `ev`
        ({"ensemble", "ce_alone", ...}) beats the best so far."""
        if (ev["ensemble"], ev["ce_alone"]) > (self.best["ensemble"], self.best["ce_alone"]):
            self.best = {**ev, "step": step, "params": self._copy()}
            return True
        return False

    def restore_best(self, final: dict) -> bool:
        """After training: restore the best kept parameters unless the final
        reading `final` beats them.  Returns True where it restored."""
        if self.best["params"] is None:
            return False
        if (final["ensemble"], final["ce_alone"]) <= (self.best["ensemble"],
                                                      self.best["ce_alone"]):
            self.module.load_state_dict(self.best["params"])
            return True
        return False

    @torch.no_grad()
    def score(self, ids, mask, types) -> np.ndarray:
        """Logits of the current parameters (the training module: plain
        attention, compute dtype), on the host."""
        dev = self.device
        return self.module(_ids(ids, dev), _ids(mask, dev), _ids(types, dev)).cpu().numpy()

    def save(self, path: str | Path) -> None:
        save_cross_encoder(self.module.state_dict(), self.spec, path)
