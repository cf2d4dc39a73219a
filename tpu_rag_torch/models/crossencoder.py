"""Cross-encoder reranker: (query, doc) pair -> relevance score (port of
tpu_rag/models/crossencoder.py).

The bi-encoder's BERT trunk plus a tanh pooler on the CLS row and a 1-logit
classifier, the HF BertForSequenceClassification layout, so the reference's
ms-marco-MiniLM-L-6-v2 weights import (models/hf_import.py).  Pairs run at a
fixed T = min(seq_len, max_len), 256 by default, so every forward takes the
fused attention (kernel #5) on the card.

Weights: `state_dict` (e.g. `cross_encoder_params_from_flax` of a tpu_rag
param tree), a HF checkpoint at `weights_path` (an orbax directory raises;
without `spec=` a config.json beside the weights sets the architecture, as
in the checkpoints the reranker trainer writes: a corpus vocab, a position
table of 160), or weights drawn from a torch.Generator seeded by the model
name.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu_rag_torch.device import compute_dtype, resolve
from tpu_rag_torch.models.bert import BertEncoder, BertSpec, _linear, params_from_flax
from tpu_rag_torch.models.biencoder import _seed_from_name, seeded_state_dict, spec_for_model
from tpu_rag_torch.models.hf_import import load_cross_encoder_params, spec_from_hf_config
from tpu_rag_torch.models.tokenizer import encode_pair_batch, load_tokenizer


class CrossEncoderModule(nn.Module):
    """(ids, mask, type_ids) -> (B,) f32 logits.  flash=False keeps the
    plain attention at every T, as training needs (kernel #5 has no
    backward); serving keeps the fused one."""

    def __init__(self, spec: BertSpec, *, flash: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.bert = BertEncoder(spec, flash=flash, compute_dtype=compute_dtype)
        self.pooler = nn.Linear(spec.hidden, spec.hidden)
        self.classifier = nn.Linear(spec.hidden, 1)

    def forward(self, ids, mask, type_ids):
        cls = self.bert(ids, mask, type_ids)[:, 0, :]
        pooled = torch.tanh(_linear(cls, self.pooler))
        return _linear(pooled, self.classifier)[:, 0].to(torch.float32)


def cross_encoder_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """tpu_rag's CrossEncoderModule params ({"bert", "pooler", "classifier"},
    nested dicts of arrays) -> CrossEncoderModule state_dict."""
    sd = {"bert." + k: v for k, v in params_from_flax(tree["bert"]).items()}
    for name in ("pooler", "classifier"):
        kernel = torch.from_numpy(np.array(tree[name]["kernel"], dtype=np.float32))
        sd[name + ".weight"] = kernel.T.contiguous()
        sd[name + ".bias"] = torch.from_numpy(np.array(tree[name]["bias"], dtype=np.float32))
    return sd


class CrossEncoder:
    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        *,
        weights_path: str = "",
        tokenizer_path: str = "",
        seq_len: int = 256,
        batch: int = 32,
        dtype: str = "bfloat16",
        spec: BertSpec | None = None,
        device: str | torch.device = "cuda",
        state_dict: dict[str, torch.Tensor] | None = None,
    ) -> None:
        self.device = resolve(device)
        self.model_name = model_name
        if spec is None and weights_path:
            # a checkpoint with a config.json fixes its own architecture
            spec = spec_from_hf_config(weights_path)
        self.spec = spec or spec_for_model(model_name)
        self.compute_dtype = (compute_dtype(self.device) if dtype == "bfloat16"
                              else torch.float32)
        self.seq_len = min(seq_len, self.spec.max_len)
        self.batch = batch
        self.tokenizer = load_tokenizer(tokenizer_path, vocab_size=self.spec.vocab_size)
        if state_dict is None and weights_path:
            state_dict = load_cross_encoder_params(weights_path, self.spec)
        self.module = CrossEncoderModule(self.spec, compute_dtype=self.compute_dtype)
        if state_dict is None:
            state_dict = seeded_state_dict(self.module, self.spec.hidden,
                                           _seed_from_name(model_name))
        self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()

    @torch.no_grad()
    def forward_ids(self, ids, mask, types) -> torch.Tensor:
        """(B, T) int arrays -> (B,) f32 logits on the device."""
        def dev(a):
            return torch.as_tensor(a).to(self.device).to(torch.int64)

        return self.module(dev(ids), dev(mask).to(torch.int32), dev(types))

    def predict(self, pairs: list[tuple[str, str]]) -> np.ndarray:
        """Scores for [query, text] pairs, in chunks of `batch` (a chunk of 8
        or fewer runs at batch 8), each at T = seq_len."""
        if not pairs:
            return np.zeros((0,), np.float32)
        out = np.zeros((len(pairs),), np.float32)
        i = 0
        while i < len(pairs):
            chunk = pairs[i: i + self.batch]
            b = self.batch if len(chunk) > 8 else 8
            ids, mask, types = encode_pair_batch(self.tokenizer, chunk, self.seq_len, batch=b)
            out[i: i + len(chunk)] = self.forward_ids(ids, mask, types)[: len(chunk)].cpu().numpy()
            i += len(chunk)
        return out
