"""Contrastive (InfoNCE) training of the bi-encoder, on one device or over
a ("data", "model") mesh; port of tpu_rag/train/contrastive.py.

- In-batch negatives: logits = q @ d^T / tau with labels on the diagonal,
  symmetric cross-entropy.
- `BertEncoder(spec, flash=False, remat=True)` with f32 parameters: the
  plain attention (kernel #5 has no backward, nor has tpu_rag's Pallas
  kernel, whose trainer keeps XLA's attention), each layer recomputed in the
  backward pass; forward in `compute_dtype` (bf16 on the card).
- `torch.optim.AdamW` at `optax.adamw`'s defaults: betas 0.9/0.999, eps
  1e-8 and weight decay 1e-4 on every parameter (optax has no mask, so
  LayerNorm scales and biases decay too).  The schedule's value is written
  into the lr before each step, the first step at count 0, as optax counts.

Over a mesh (parallel/mesh.py), as tpu_rag shards the batch over "data"
and the FFN and heads over "model": the master parameters are a
TensorParallelEncoder on the first data position's group (one model rank a
device, parallel/tensor.py's rules; one rank without a "model" axis).  Each
data position embeds its contiguous slice of the batch through its group,
with the masters copied to its devices inside the step (autograd sums
their gradients into the masters; on a device that names the masters' own,
nothing is copied).  The q and d embeddings are gathered in data order on
the first device for the loss, and one AdamW steps the masters.  One
process drives every device, as tpu_rag's single controller does.  Initial
weights are `init_params(spec, seed)`: flax's init cannot
be redrawn in torch, so parity with tpu_rag starts from shared parameters
(`params_from_flax` loaded into `trainer.module`).  Checkpoints are HF
BertModel directories (models/hf_export.py), which `BiEncoder(weights_path=)`
serves without a spec; tpu_rag writes orbax.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rag_torch.device import resolve
from tpu_rag_torch.models.bert import (BertEncoder, BertSpec, TensorParallelEncoder,
                                       l2_normalize, mean_pool)
from tpu_rag_torch.models.biencoder import init_params
from tpu_rag_torch.models.hf_export import save_bert
from tpu_rag_torch.models.hf_import import load_bert_params
from tpu_rag_torch.parallel.mesh import Mesh
from tpu_rag_torch.parallel.tensor import gather_rows
from tpu_rag_torch.utils.timing import span


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, tau: float = 0.05) -> torch.Tensor:
    logits = (q_emb @ d_emb.T) / tau
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule as a function of the step: linear
    from init to peak over `warmup_steps`, then cosine from peak to end over
    `decay_steps - warmup_steps`, then flat at end.  Like optax, raises
    ValueError when the cosine part has no steps."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps - warmup_steps, "
                         f"got {decay_steps} - {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return (init_value - peak_value) * (1.0 - step / warmup_steps) + peak_value
        count = min(step - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adamw(params) -> torch.optim.AdamW:
    """torch's AdamW at optax.adamw's defaults (weight decay 1e-4, where
    torch's is 1e-2); the lr is set before each step from the schedule.
    torch picks its implementation: the multi-tensor (foreach) one on the
    card, the per-tensor loop on the CPU; not the fused kernel, which is
    opt-in (passing fused=False would also turn foreach off)."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


class ContrastiveTrainer:
    def __init__(self, spec: BertSpec, *, lr: float | Callable[[int], float] = 2e-5,
                 tau: float = 0.05, compute_dtype: torch.dtype = torch.float32,
                 seed: int = 0, device: str | torch.device = "cuda",
                 mesh: Mesh | dict[str, int] | None = None) -> None:
        """mesh: a parallel.Mesh with "data" and/or "model" axes (its
        devices replace `device`), or, for one device, None or a dict of
        axis sizes whose product is 1."""
        if isinstance(mesh, dict):
            if math.prod(mesh.values()) > 1:
                raise TypeError(f"mesh {mesh}: a mesh of more than one device is a "
                                f"parallel.Mesh (parallel.mesh_from_spec)")
            mesh = None
        self._groups = [tuple(g) for g in mesh.model_groups()] if mesh is not None else []
        self.device = self._groups[0][0] if self._groups else resolve(device)
        self.spec = spec
        self.tau = tau
        self.schedule = lr if callable(lr) else (lambda _step: lr)
        with span("train.init"):
            with span("train.init.module"):
                if self._groups:
                    self.module = TensorParallelEncoder(spec, self._groups[0], flash=False,
                                                        remat=True, compute_dtype=compute_dtype)
                else:
                    self.module = BertEncoder(spec, flash=False, remat=True,
                                              compute_dtype=compute_dtype).to(self.device)
            with span("train.init.params"):
                self.module.load_state_dict(init_params(spec, seed))
            self.module.train()
            # the first optimizer a process builds imports torch._dynamo
            with span("train.init.optimizer"):
                self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        self.step = 0
        self.optimizer = adamw(self.module.parameters())

    def _embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids and mask -> (B, H) f32 embeddings on self.device; over a
        mesh, data position j embeds the j-th of len(groups) equal slices."""
        if not self._groups:
            hidden = self.module(ids, mask)
            return l2_normalize(mean_pool(hidden, mask).to(torch.float32))
        if ids.shape[0] % len(self._groups):
            raise ValueError(f"batch {ids.shape[0]} is not a multiple of the data axis "
                             f"({len(self._groups)})")
        step = ids.shape[0] // len(self._groups)
        parts = []
        for j, group in enumerate(self._groups):
            ids_j = ids[j * step:(j + 1) * step].to(group[0])
            mask_j = mask[j * step:(j + 1) * step].to(group[0])
            hidden = self.module(ids_j, mask_j, devices=group)
            parts.append(l2_normalize(mean_pool(hidden, mask_j).to(torch.float32)))
        return gather_rows(parts, self.device)

    def train_step(self, batch: dict[str, Any]) -> float:
        """batch: {q_ids, q_mask, d_ids, d_mask}, int (B, L) numpy arrays
        (B a multiple of the data axis).  One AdamW update; returns the loss
        before it.  Its spans (utils/timing.py) are tagged with the step
        it takes; the backward's kernels are launched by autograd's device
        thread while this one waits inside train.backward."""
        with span("train.step", step=self.step):
            with span("train.upload"):
                t = {k: torch.as_tensor(np.asarray(v)).to(self.device, torch.int64)
                     for k, v in batch.items()}
            for group in self.optimizer.param_groups:
                group["lr"] = float(self.schedule(self.step))
            self.optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss = info_nce_loss(self._embed(t["q_ids"], t["q_mask"]),
                                     self._embed(t["d_ids"], t["d_mask"]), self.tau)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                self.optimizer.step()
            self.step += 1
            with span("train.readback"):
                return float(loss.detach())

    def save(self, path: str | Path) -> None:
        """The encoder as a HF BertModel directory (models/hf_export.py);
        over a mesh, the model ranks' shares gathered into one model."""
        save_bert(self.module.state_dict(), self.spec, path)

    def load(self, path: str | Path) -> None:
        """Restore the PARAMETERS only (over a mesh, each rank takes its
        share): AdamW's moments and the schedule's count start again from
        zero, as tpu_rag's load re-initializes its optimizer state
        (checkpoints hold the parameters alone)."""
        sd = load_bert_params(path, self.spec)
        if sd is None:
            raise FileNotFoundError(f"no checkpoint of {self.spec} at {path}")
        self.module.load_state_dict(sd)
        self._reset_optimizer()
