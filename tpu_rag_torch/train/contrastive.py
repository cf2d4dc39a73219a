"""Contrastive (InfoNCE) training of the bi-encoder, on one device or over
a ("data", "model") mesh; port of tpu_rag/train/contrastive.py.

- In-batch negatives: logits = q @ d^T / tau with labels on the diagonal,
  symmetric cross-entropy.
- `spec.encoder(train=True)` with f32 parameters: for a BertSpec
  `BertEncoder(spec, flash=False, remat=True)`, the plain attention (kernel
  #5 has no backward, nor has tpu_rag's Pallas kernel, whose trainer keeps
  XLA's attention), each layer recomputed in the backward pass; forward in
  `compute_dtype` (bf16 on the card).  A ModernBertSpec trains
  `ModernBertEncoder(spec, remat=True)` the same way (its attention,
  ops/ragged_attention.py, has a backward: kernels on the card), on one
  device only: the tensor-parallel rules are BERT's.  Each step adds the
  spec's attention counters (spec.record_attention, from the batch's host
  masks, counting the slots the attention on the trainer's device
  scores), replayed steps too.
- `torch.optim.AdamW` at `optax.adamw`'s defaults: betas 0.9/0.999, eps
  1e-8 and weight decay 1e-4 on every parameter (optax has no mask, so
  LayerNorm scales and biases decay too).  The schedule's value is written
  into the lr before each step, the first step at count 0, as optax counts.
- On one CUDA device the step is replayed as one CUDA graph (PyTorch's
  whole-network capture): the first step of a batch shape runs eagerly on
  a side stream (AdamW's state, cuBLAS and the allocator warmed), the next
  step of that shape captures forward, loss, backward and AdamW into a
  `torch.cuda.CUDAGraph` and replays it, and every later step of that shape
  only copies its batch into the graph's static inputs and replays.  AdamW
  is then `capturable` (its step count, bias correction and lr on the
  device; the lr a 0-dim f32 tensor filled before each step).  One graph
  a trainer: a batch of another shape steps eagerly; two such steps in a
  row capture that shape in place of the old.  The CPU and a mesh always
  step eagerly, with a float lr.

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
weights are `state_dict` where given, else `init_params(spec, seed)`:
flax's init cannot be redrawn in torch, so parity with tpu_rag starts from
shared parameters (`params_from_flax` loaded into `trainer.module`, or
given as `state_dict`).  Checkpoints are HF BertModel (or ModernBertModel)
directories (models/hf_export.py), which `BiEncoder(weights_path=)`
serves without a spec; tpu_rag writes orbax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rag_torch.device import resolve
from tpu_rag_torch.models.bert import BertSpec, TensorParallelEncoder, l2_normalize, mean_pool
from tpu_rag_torch.models.biencoder import init_params
from tpu_rag_torch.models.hf_export import save_bert
from tpu_rag_torch.models.hf_import import load_bert_params
from tpu_rag_torch.models.modernbert import ModernBertSpec
from tpu_rag_torch.parallel.mesh import Mesh
from tpu_rag_torch.parallel.tensor import gather_rows
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
from tpu_rag_torch.utils.timing import span

_BATCH_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask")


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


def adamw(params, capturable: bool = False) -> torch.optim.AdamW:
    """torch's AdamW at optax.adamw's defaults (weight decay 1e-4, where
    torch's is 1e-2); the lr is set before each step from the schedule
    (set_lr).  torch picks its implementation: the multi-tensor (foreach)
    one on the card, the per-tensor loop on the CPU; not the fused kernel,
    which is opt-in (passing fused=False would also turn foreach off).
    capturable=True (the params on one CUDA device) keeps the step count
    and bias correction on the device and takes the lr as a 0-dim f32
    tensor there, so that a CUDA graph can hold the step."""
    params = list(params)
    lr = torch.zeros((), dtype=torch.float32, device=params[0].device) if capturable else 0.0
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, capturable=capturable)


def set_lr(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Write the schedule's value into every group's lr: in place where
    the lr is a tensor (a captured step reads it there), else as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


@dataclass
class _Graph:
    """One captured step: the batch shapes it holds, its static device
    inputs, pinned host buffers the batch is staged through, the event
    after the last copy out of them, and the graph's static loss."""
    key: tuple
    inputs: dict[str, torch.Tensor]
    staging: dict[str, torch.Tensor]
    copied: torch.cuda.Event = field(default_factory=torch.cuda.Event)
    graph: torch.cuda.CUDAGraph | None = None
    loss: torch.Tensor | None = None


class ContrastiveTrainer:
    def __init__(self, spec: BertSpec | ModernBertSpec, *,
                 lr: float | Callable[[int], float] = 2e-5,
                 tau: float = 0.05, compute_dtype: torch.dtype = torch.float32,
                 seed: int = 0, device: str | torch.device = "cuda",
                 mesh: Mesh | dict[str, int] | None = None,
                 state_dict: dict[str, torch.Tensor] | None = None) -> None:
        """mesh: a parallel.Mesh with "data" and/or "model" axes (its
        devices replace `device`), or, for one device, None or a dict of
        axis sizes whose product is 1."""
        if isinstance(mesh, dict):
            if math.prod(mesh.values()) > 1:
                raise TypeError(f"mesh {mesh}: a mesh of more than one device is a "
                                f"parallel.Mesh (parallel.mesh_from_spec)")
            mesh = None
        if mesh is not None and not spec.tensor_parallel:
            raise ValueError(f"{type(spec).__name__} trains on one device: a mesh {mesh.shape} "
                             f"needs tensor-parallel partition rules, and parallel/tensor.py "
                             f"holds BERT's")
        self._groups = [tuple(g) for g in mesh.model_groups()] if mesh is not None else []
        self.device = self._groups[0][0] if self._groups else resolve(device)
        spec.prepare(self.device, compute_dtype)
        # one CUDA device, no mesh: the step may be captured (module
        # docstring); its eager steps run on this side stream
        self._side = (torch.cuda.Stream(self.device)
                      if not self._groups and self.device.type == "cuda" else None)
        self._graph: _Graph | None = None
        self._warmed: tuple | None = None      # the shapes of the last step, if eager here
        self.spec = spec
        self.tau = tau
        self.schedule = lr if callable(lr) else (lambda _step: lr)
        with span("train.init"):
            with span("train.init.module"):
                if self._groups:
                    self.module = TensorParallelEncoder(spec, self._groups[0], flash=False,
                                                        remat=True, compute_dtype=compute_dtype)
                else:
                    # built uninitialised on its device: the state dict
                    # loaded below writes every tensor
                    with torch.device("meta"):
                        self.module = spec.encoder(train=True, compute_dtype=compute_dtype)
                    self.module.to_empty(device=self.device)
            with span("train.init.params"):
                self.module.load_state_dict(init_params(spec, seed) if state_dict is None
                                            else state_dict)
            self.module.train()
            # the first optimizer a process builds imports torch._dynamo
            with span("train.init.optimizer"):
                self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        self._drop_graph()
        self.step = 0
        self.optimizer = adamw(self.module.parameters(), capturable=self._side is not None)

    def _drop_graph(self) -> None:
        """Forget the captured step (it points at this optimizer's state);
        its gradients, in the graph's memory pool, go with it."""
        if self._graph is not None:
            self.module.zero_grad(set_to_none=True)
            self._graph = None
        self._warmed = None

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

    def _loss(self, t: dict[str, torch.Tensor]) -> torch.Tensor:
        return info_nce_loss(self._embed(t["q_ids"], t["q_mask"]),
                             self._embed(t["d_ids"], t["d_mask"]), self.tau)

    def train_step(self, batch: dict[str, Any]) -> float:
        """batch: {q_ids, q_mask, d_ids, d_mask}, int (B, L) numpy arrays
        (B a multiple of the data axis).  One AdamW update; returns the loss
        before it.  Its spans (utils/timing.py) are tagged with the step
        it takes; the backward's kernels are launched by autograd's device
        thread while this one waits inside train.backward.  On one CUDA
        device the step is replayed from a CUDA graph where it can be (the
        module docstring)."""
        with span("train.step", step=self.step):
            key = tuple(np.shape(batch[k]) for k in _BATCH_KEYS)
            if self._side is None:
                loss = self._eager_step(batch)
            elif (self._graph is not None and self._graph.key == key) or self._warmed == key:
                loss = self._graph_step(key, batch)
            else:
                # the warm-up before a capture, on a side stream as
                # PyTorch's capture recipe asks
                current = torch.cuda.current_stream(self.device)
                self._side.wait_stream(current)
                with torch.cuda.stream(self._side):
                    loss = self._eager_step(batch)
                current.wait_stream(self._side)
                self._warmed = key
            self.spec.record_attention(batch["q_mask"], batch["d_mask"], device=self.device)
            self.step += 1
            with span("train.readback"):
                return float(loss.detach())

    def _eager_step(self, batch: dict[str, Any]) -> torch.Tensor:
        with span("train.upload"):
            t = {k: torch.as_tensor(np.asarray(v)).to(self.device, torch.int64)
                 for k, v in batch.items()}
        set_lr(self.optimizer, float(self.schedule(self.step)))
        self.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = self._loss(t)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            self.optimizer.step()
        GLOBAL_METRICS.inc("train_eager_steps_total")
        return loss

    def _graph_step(self, key: tuple, batch: dict[str, Any]) -> torch.Tensor:
        """The step through the graph of these shapes, captured first if
        the trainer holds none (dropping one of other shapes)."""
        g = self._graph
        if g is None or g.key != key:
            self._drop_graph()
            g = _Graph(key, {k: torch.empty(s, dtype=torch.int64, device=self.device)
                             for k, s in zip(_BATCH_KEYS, key)},
                       {k: torch.empty(s, dtype=torch.int64, pin_memory=True)
                        for k, s in zip(_BATCH_KEYS, key)})
        with span("train.upload"):
            g.copied.synchronize()          # the staging buffers' last copy is done
            for k, dst in g.inputs.items():
                g.staging[k].numpy()[...] = np.asarray(batch[k])
                dst.copy_(g.staging[k], non_blocking=True)
            g.copied.record()
        set_lr(self.optimizer, float(self.schedule(self.step)))
        if g.graph is None:
            with span("train.capture"):
                # the gradients are allocated inside the capture, so they
                # are the graph's own static tensors
                self.optimizer.zero_grad(set_to_none=True)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    loss = self._loss(g.inputs)
                    loss.backward()
                    self.optimizer.step()
                    # kept without its autograd graph, which would hold each
                    # parameter's AccumulateGrad node, and the capture's
                    # stream with it, for the eager steps of other shapes
                    g.loss = loss.detach()
            g.graph, self._graph = graph, g
            GLOBAL_METRICS.inc("train_graph_captures_total")
        self._warmed = None
        with span("train.replay"):
            g.graph.replay()
        GLOBAL_METRICS.inc("train_graph_replays_total")
        return g.loss

    def save(self, path: str | Path) -> None:
        """The encoder as a HF BertModel (or ModernBertModel) directory
        (models/hf_export.py);
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
