"""Bi-encoder: batched text -> normalized embedding vectors (port of
tpu_rag/models/biencoder.py).

Texts are tokenized on the host, sorted by length and run in (batch, seq)
buckets on the device; the attention mask is derived on the device from
`ids != pad_id`, so only ids are uploaded (int16 when the vocab allows).

Weights: `state_dict` (e.g. `params_from_flax` of a tpu_rag param tree), a
HF checkpoint at `weights_path` (models/hf_import.py: model.safetensors or
pytorch_model.bin; an orbax directory raises; without `spec=` a config.json
beside the weights sets the architecture, as in the checkpoints the port's
trainer writes), or, where neither gives
weights, weights drawn from a torch.Generator seeded by the model name —
index-time and query-time embeddings agree, which is all retrieval needs.
They are not the JAX package's seeded numbers: parity tests carry params
across instead.

Data and tensor parallelism: with a `mesh` whose "data" axis is larger
than 1, the batch is rounded up to a multiple of that axis and each data
position embeds its contiguous slice of every batch with its own copy of
the weights.  With a "model" axis larger than 1, each data position holds
a tensor-parallel group (Mesh.model_groups: its devices along "model"),
whose TensorParallelEncoder splits the heads and the FFN over them
(parallel/tensor.py); a "model"-only mesh serves with one group.  Groups
that name the same devices share one copy (a device named more than once
holds one replica).  Every slice is launched before any is read back.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from tpu_rag_torch.device import compute_dtype, resolve
from tpu_rag_torch.models.bert import (BertEncoder, BertSpec, TensorParallelEncoder,
                                       l2_normalize, mean_pool)
from tpu_rag_torch.models.hf_import import load_bert_params, spec_from_hf_config
from tpu_rag_torch.models.tokenizer import _special_ids, load_tokenizer

MODEL_SPECS: dict[str, BertSpec] = {
    # parity default: all-MiniLM-L6-v2 (384-d)
    "minilm-l6": BertSpec(hidden=384, layers=6, heads=12, ffn=1536),
    "minilm-l12": BertSpec(hidden=384, layers=12, heads=12, ffn=1536),
    "bge-base": BertSpec(hidden=768, layers=12, heads=12, ffn=3072),
    "bge-small": BertSpec(hidden=384, layers=12, heads=12, ffn=1536),
    "tiny": BertSpec(vocab_size=1024, hidden=64, layers=2, heads=4, ffn=128, max_len=128),
}


def spec_for_model(name: str) -> BertSpec:
    low = name.lower()
    for key, spec in MODEL_SPECS.items():
        if key in low:
            return spec
    if "bge-base" in low or "768" in low:
        return MODEL_SPECS["bge-base"]
    return MODEL_SPECS["minilm-l6"]


def _seed_from_name(name: str) -> int:
    return int.from_bytes(hashlib.blake2b(name.encode(), digest_size=4).digest(), "little")


def seeded_state_dict(module: torch.nn.Module, hidden: int,
                      seed: int) -> dict[str, torch.Tensor]:
    """module's state dict refilled with seeded random weights on the CPU:
    LeCun-normal Linear weights (std 1/sqrt(fan_in)), embeddings with std
    1/sqrt(hidden), zero biases, unit LayerNorm scales."""
    g = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    for name, p in sd.items():
        if name.endswith("_ln.weight"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        elif "embeddings" in name:
            p.copy_(torch.randn(p.shape, generator=g) / hidden ** 0.5)
        else:
            p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** 0.5)
    return sd


def init_params(spec: BertSpec, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random BertEncoder weights (seeded_state_dict)."""
    return seeded_state_dict(BertEncoder(spec), spec.hidden, seed)


class BiEncoder:
    # sequence-length buckets: a batch runs at the smallest bucket >= its
    # longest row; padding is masked in attention and in the mean pool
    SEQ_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(
        self,
        model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
        *,
        weights_path: str = "",
        tokenizer_path: str = "",
        seq_len: int = 256,
        batch: int = 64,
        dtype: str = "bfloat16",
        spec: BertSpec | None = None,
        device: str | torch.device = "cuda",
        state_dict: dict[str, torch.Tensor] | None = None,
        mesh=None,
    ) -> None:
        # one device group a data position (one device each without a
        # "model" axis); empty without a mesh of two or more devices
        self._groups: list[tuple[torch.device, ...]] = []
        if mesh is not None and (mesh.shape.get("data", 1) > 1
                                 or mesh.shape.get("model", 1) > 1):
            self._groups = [tuple(g) for g in mesh.model_groups()]
            device = self._groups[0][0]
        self.device = resolve(device)
        self.model_name = model_name
        if spec is None and weights_path:
            # a checkpoint with a config.json (HF, or models/hf_export.py)
            # fixes its own architecture, position table included
            spec = spec_from_hf_config(weights_path)
        self.spec = spec or spec_for_model(model_name)
        self.batch = batch
        self.compute_dtype = (compute_dtype(self.device) if dtype == "bfloat16"
                              else torch.float32)
        self.seq_len = min(seq_len, self.spec.max_len)
        self.tokenizer = load_tokenizer(tokenizer_path, vocab_size=self.spec.vocab_size)
        tok_vocab = int(getattr(self.tokenizer, "vocab_size", self.spec.vocab_size))
        if tok_vocab > self.spec.vocab_size:
            logging.getLogger("tpu_rag_torch").warning(
                "tokenizer vocab (%d) exceeds the model's embedding table (%d)",
                tok_vocab, self.spec.vocab_size)
        self._id_np_dtype = (np.int16
                             if max(self.spec.vocab_size, tok_vocab) < 2 ** 15
                             else np.int32)
        self.pad_id = _special_ids(self.tokenizer)[2]
        if state_dict is None and weights_path:
            state_dict = load_bert_params(weights_path, self.spec)
        if state_dict is None:
            state_dict = init_params(self.spec, _seed_from_name(model_name))
        # one encoder per distinct group (the first is self.module): a
        # BertEncoder on one device, a TensorParallelEncoder over several
        self._replicas: dict[tuple[torch.device, ...], torch.nn.Module] = {}
        for group in self._groups or [(self.device,)]:
            if group not in self._replicas:
                self._replicas[group] = self._encoder_on(group, state_dict)
        self.module = next(iter(self._replicas.values()))
        unit = max(1, len(self._groups))
        self.batch = -(-self.batch // unit) * unit   # divisible by the data axis

    def _encoder_on(self, group: tuple[torch.device, ...], state_dict) -> torch.nn.Module:
        if len(group) == 1:
            module = BertEncoder(self.spec, compute_dtype=self.compute_dtype)
            module.load_state_dict(state_dict)
            return module.to(group[0]).eval()
        module = TensorParallelEncoder(self.spec, group, compute_dtype=self.compute_dtype)
        module.load_state_dict(state_dict)
        return module.eval()

    @property
    def dim(self) -> int:
        return self.spec.hidden

    def _bucket(self, n: int) -> int:
        # power-of-two batch ladder up to self.batch, each a multiple of
        # the data axis
        unit = max(1, len(self._groups))
        for b in (8, 16, 32, 64, 128, 256, 512):
            if n <= b <= self.batch and b % unit == 0:
                return b
        return max(self.batch, unit)

    def _seq_bucket(self, longest_row: int) -> int:
        for t in self.SEQ_BUCKETS:
            if t >= longest_row and t <= self.seq_len:
                return t
        return self.seq_len

    @torch.no_grad()
    def _forward_on(self, module: torch.nn.Module, ids, device: torch.device) -> torch.Tensor:
        ids_t = torch.as_tensor(ids).to(device).to(torch.int64)
        mask = (ids_t != self.pad_id).to(torch.int32)
        hidden = module(ids_t, mask)
        return l2_normalize(mean_pool(hidden, mask).to(torch.float32))

    @torch.no_grad()
    def forward_ids(self, ids) -> torch.Tensor:
        """(B, T) ids (numpy or tensor, any int dtype) -> (B, dim) f32
        L2-normalized embeddings on the device; mask = ids != pad_id.  On a
        mesh with a data axis each data position embeds a contiguous slice
        of ceil(B / positions) rows through its group."""
        if len(self._groups) <= 1:
            return self._forward_on(self.module, ids, self.device)
        ids_t = torch.as_tensor(ids)
        step = -(-ids_t.shape[0] // len(self._groups))
        parts = [self._forward_on(self._replicas[g], ids_t[i * step:(i + 1) * step], g[0])
                 for i, g in enumerate(self._groups) if i * step < ids_t.shape[0]]
        return torch.cat([p.to(self.device) for p in parts], dim=0)

    def _assemble(self, toks: list[list[int]], b: int, t: int) -> np.ndarray:
        cls_id, sep_id, pad_id = _special_ids(self.tokenizer)
        ids = np.full((b, t), pad_id, self._id_np_dtype)
        for r, body in enumerate(toks):
            row = [cls_id] + body + [sep_id]
            ids[r, : len(row)] = row
        return ids

    def embed(self, texts: list[str]) -> np.ndarray:
        """Batched embed: (len(texts), dim) float32, L2-normalized.  Texts
        are sorted by token length and run in per-batch seq buckets."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        n = len(texts)
        toks = [self.tokenizer.tokenize_ids(t)[: self.seq_len - 2] for t in texts]
        order = sorted(range(n), key=lambda i: len(toks[i]))
        pending = []
        for i in range(0, n, self.batch):
            rows = order[i: i + self.batch]
            t = self._seq_bucket(max(len(toks[j]) for j in rows) + 2)
            ids = self._assemble([toks[j] for j in rows], self._bucket(len(rows)), t)
            pending.append((rows, self.forward_ids(ids)))
        out = np.zeros((n, self.dim), np.float32)
        for rows, emb in pending:
            out[rows] = emb[: len(rows)].cpu().numpy()
        return out

    def tokenize_query_ids(self, texts: list[str], batch: int | None = None) -> np.ndarray:
        """Mask-free, seq-bucketed (B, seq_bucket) ids for the fused serving
        path; int16 when the vocab allows."""
        b = batch or self._bucket(len(texts))
        if len(texts) > b:
            raise ValueError(
                f"{len(texts)} texts exceed the batch capacity {b} — "
                f"split the call (engine microbatch windows do)")
        toks = [self.tokenizer.tokenize_ids(t)[: self.seq_len - 2] for t in texts]
        t = self._seq_bucket(max((len(x) for x in toks), default=0) + 2)
        return self._assemble(toks, b, t)
