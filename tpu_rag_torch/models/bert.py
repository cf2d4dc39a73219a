"""BERT-family transformer trunk (MiniLM / bge), port of tpu_rag/models/bert.py.

Post-LayerNorm BERT with erf GELU and LayerNorm eps 1e-12, as an nn.Module.
Parameters stay f32; the forward runs in `compute_dtype` (bf16 on the GPU,
f32 on the CPU — set by BiEncoder), with LayerNorm and softmax in f32.

Attention takes the fused kernel (ops/attention.py) when T >= 128, as the
JAX trunk does with flash=True; shorter buckets take plain matmul -> softmax
-> matmul with the JAX path's two-sided mask (query & key) and Flax's
finfo(dtype).min fill.

Tensor parallelism over a mesh "model" axis: `TensorParallelEncoder` runs
one model rank's share of each layer (`BertEncoder(spec, tp=, rank=)`) on
each device of a group, by parallel/tensor.py's partition rules.

`params_from_flax` carries a Flax param tree of tpu_rag's BertEncoder (nested
dicts of numpy arrays) into this module's state_dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_rag_torch.ops.attention import fused_mha
from tpu_rag_torch.parallel.tensor import (check_divisible, gather_state_dict, reduce_partials,
                                           shard_state_dict)


@dataclass(frozen=True)
class BertSpec:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    ffn: int = 1536
    max_len: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12

    # parallel/tensor.py's partition rules are this trunk's
    tensor_parallel: ClassVar[bool] = True

    def encoder(self, *, train: bool = False,
                compute_dtype: torch.dtype = torch.float32) -> nn.Module:
        """The trunk; for training, the plain attention (kernel #5 has no
        backward) with each layer recomputed in the backward pass."""
        if train:
            return BertEncoder(self, flash=False, remat=True, compute_dtype=compute_dtype)
        return BertEncoder(self, compute_dtype=compute_dtype)

    def sized_for(self, vocab_size: int, positions: int) -> "BertSpec":
        """This preset over a vocab of `vocab_size` ids, with a position
        table of `positions` (at least 128)."""
        return replace(self, vocab_size=vocab_size, max_len=max(positions, 128))

    def prepare(self, device, compute_dtype) -> None:
        """Where the trunk will run: BERT's kernels take bf16 and f32 and
        build at their first call."""

    def record_attention(self, *masks, device=None) -> None:
        """A training step's attention counters: BERT keeps none."""

    def hf_names(self) -> dict[str, str]:
        """encoder() state-dict name -> HF BertModel name."""
        from tpu_rag_torch.models.hf_import import bert_hf_names

        return bert_hf_names(self)

    def hf_config(self) -> dict:
        """HF BertModel config.json keys, with erf GELU ("gelu"), as the
        trunk computes."""
        return {"architectures": ["BertModel"], "model_type": "bert",
                "vocab_size": self.vocab_size, "hidden_size": self.hidden,
                "num_hidden_layers": self.layers, "num_attention_heads": self.heads,
                "intermediate_size": self.ffn, "max_position_embeddings": self.max_len,
                "type_vocab_size": self.type_vocab, "layer_norm_eps": self.ln_eps,
                "hidden_act": "gelu"}

    @classmethod
    def from_hf_config(cls, cfg: dict) -> "BertSpec | None":
        """The spec of a HF BertConfig dict, or None where keys are missing."""
        try:
            return cls(vocab_size=int(cfg["vocab_size"]), hidden=int(cfg["hidden_size"]),
                       layers=int(cfg["num_hidden_layers"]),
                       heads=int(cfg["num_attention_heads"]), ffn=int(cfg["intermediate_size"]),
                       max_len=int(cfg.get("max_position_embeddings", 512)),
                       type_vocab=int(cfg.get("type_vocab_size", 2)),
                       ln_eps=float(cfg.get("layer_norm_eps", 1e-12)))
        except (KeyError, ValueError, TypeError):
            return None


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.device, x.dtype),
                    None if lin.bias is None else lin.bias.to(x.device, x.dtype))


def _partial(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """A row-parallel rank's share of lin(x): its input columns, no bias."""
    return F.linear(x, lin.weight.to(x.device, x.dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight.to(x.device),
                        ln.bias.to(x.device), ln.eps).to(x.dtype)


def _two_sided(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, T, T) query & key mask of the plain attention path."""
    return (mask[:, None, None, :] > 0) & (mask[:, None, :, None] > 0)


class SelfAttention(nn.Module):
    """All heads, or with tp > 1 model rank `rank`'s heads / tp of them (at
    the model's own head dim) and their columns of `out`, whose bias rank 0
    holds."""

    def __init__(self, spec: BertSpec, tp: int = 1, rank: int = 0) -> None:
        super().__init__()
        self.heads = spec.heads // tp
        self.head_dim = spec.hidden // spec.heads
        width = self.heads * self.head_dim
        self.query = nn.Linear(spec.hidden, width)
        self.key = nn.Linear(spec.hidden, width)
        self.value = nn.Linear(spec.hidden, width)
        self.out = nn.Linear(width, spec.hidden, bias=rank == 0)

    def heads_out(self, x, mask, attn_mask, flash: bool):
        """The attention of this module's heads: (B, T, heads * head_dim)."""
        b, t, _ = x.shape
        shape = (b, t, self.heads, self.head_dim)
        # each projection's own output: a contiguous (B, T, heads, hd) view
        q = _linear(x, self.query).view(shape)
        k = _linear(x, self.key).view(shape)
        v = _linear(x, self.value).view(shape)
        if flash:
            o = fused_mha(q, k, v, mask)
        else:
            # flax.linen.dot_product_attention: q scaled in compute dtype,
            # masked scores filled with finfo(dtype).min, softmax in f32
            q = q / math.sqrt(self.head_dim)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k)
            s = torch.where(attn_mask, s, torch.full_like(s, torch.finfo(s.dtype).min))
            p = torch.softmax(s.to(torch.float32), dim=-1).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return o.reshape(b, t, self.heads * self.head_dim)

    def forward(self, x, mask, attn_mask, flash: bool):
        return _linear(self.heads_out(x, mask, attn_mask, flash), self.out)


class BertLayer(nn.Module):
    """One layer, or with tp > 1 model rank `rank`'s share of it: its heads,
    ffn / tp columns of `intermediate` and the matching input columns of
    `output`.  Rank 0 also holds the LayerNorms and the biases of `out` and
    `output`, which run once, after the ranks' partials are summed."""

    def __init__(self, spec: BertSpec, tp: int = 1, rank: int = 0) -> None:
        super().__init__()
        self.attention = SelfAttention(spec, tp, rank)
        self.intermediate = nn.Linear(spec.hidden, spec.ffn // tp)
        self.output = nn.Linear(spec.ffn // tp, spec.hidden, bias=rank == 0)
        if rank == 0:
            self.attention_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)
            self.output_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)

    def ffn(self, x) -> torch.Tensor:
        """GELU(intermediate(x)): (B, T, ffn / tp)."""
        return F.gelu(_linear(x, self.intermediate), approximate="none")

    def forward(self, x, mask, attn_mask, flash: bool):
        x = _layer_norm(x + self.attention(x, mask, attn_mask, flash), self.attention_ln)
        return _layer_norm(x + _linear(self.ffn(x), self.output), self.output_ln)


class BertEncoder(nn.Module):
    """Returns final hidden states (B, T, H) in `compute_dtype`.

    flash=False keeps the plain attention at every T: the fused kernel has
    no backward, so training sets it.  remat=True recomputes each layer's
    activations in the backward pass (torch.utils.checkpoint; the JAX
    trunk's nn.remat), trading FLOPs for memory; numerics do not change.

    tp > 1: model rank `rank`'s share of the trunk (BertLayer), which
    TensorParallelEncoder runs; rank 0 also holds the embeddings and every
    LayerNorm, the other ranks hold neither and cannot run alone."""

    def __init__(self, spec: BertSpec, *, flash: bool = True, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32, tp: int = 1,
                 rank: int = 0) -> None:
        super().__init__()
        self.spec = spec
        self.flash = flash
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.tp = tp
        if rank == 0:
            self.word_embeddings = nn.Embedding(spec.vocab_size, spec.hidden)
            self.position_embeddings = nn.Embedding(spec.max_len, spec.hidden)
            self.token_type_embeddings = nn.Embedding(spec.type_vocab, spec.hidden)
            self.embeddings_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)
        self.layers = nn.ModuleList(BertLayer(spec, tp, rank) for _ in range(spec.layers))

    def embed(self, ids, type_ids=None) -> torch.Tensor:
        """LayerNorm(word + position + token type embeddings) on ids' device."""
        dt = self.compute_dtype
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]

        def lookup(table: nn.Embedding, idx) -> torch.Tensor:
            return F.embedding(idx, table.weight.to(idx.device)).to(dt)

        x = (lookup(self.word_embeddings, ids) + lookup(self.position_embeddings, pos)
             + lookup(self.token_type_embeddings, type_ids))
        return _layer_norm(x, self.embeddings_ln)

    def forward(self, ids, mask, type_ids=None):
        if self.tp > 1:
            raise RuntimeError(f"a rank's share of a {self.tp}-way tensor-parallel trunk runs "
                               f"inside TensorParallelEncoder")
        x = self.embed(ids, type_ids)
        flash = self.flash and ids.shape[1] >= 128
        # (B, 1, T, T) two-sided mask, built only for the plain path; the
        # fused kernel masks keys from the (B, T) mask
        attn_mask = None if flash else _two_sided(mask)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                # no op of a layer draws a random number (no dropout), so
                # the RNG state need not be saved for the recompute: the
                # numbers are the same, and a CUDA graph can capture the
                # step (reading the generator's state fails under capture)
                x = checkpoint(layer, x, mask, attn_mask, flash, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, mask, attn_mask, flash)
        return x


class TensorParallelEncoder(nn.Module):
    """BertEncoder's call and output over one tensor-parallel group: model
    rank r's share of every layer (parallel/tensor.py's rules) on
    `devices[r]`, a list that may name one device several times.

    The embeddings, every LayerNorm, the biases of the row-parallel
    projections and the residuals run on the first device.  Each layer
    sends x to every rank's device; each rank projects its own q/k/v
    columns, attends over its heads (kernel #5 at T >= 128 on a card, on its
    own contiguous (B, T, heads / tp, hd) tensors) and multiplies by its
    columns of `out`; the partials are summed on the first device in rank
    order, the bias added, then the residual and the LayerNorm; the FFN
    the same way.  The ranks of one device run one after another.

    Rounding: each rank's partial product leaves its matmul in the compute
    dtype (one bf16 rounding a rank on the card); the sum over ranks and the
    bias are taken in f32 and rounded once more, where the unsharded layer
    rounds once.  In f32 (the CPU) the tests hold the TP trunk within 1e-5
    of the unsharded one; chip_smoke.py holds bf16 on the card at cosine
    >= 0.999 per row.

    forward(..., devices=) runs the group on other devices with the same
    parameters, copied there inside the call (differentiably: the trainer's
    data positions; a no-op where a device is the parameter's own).
    state_dict() and load_state_dict() take the whole model's dict, as
    BertEncoder(spec) names it; `.to()` would put every rank on one device:
    the placement is `devices`'."""

    def __init__(self, spec: BertSpec, devices, *, flash: bool = True, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.spec = spec
        self.flash = flash
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.devices = [torch.device(d) for d in devices]
        check_divisible(spec, len(self.devices))
        self.shards = nn.ModuleList(
            BertEncoder(spec, compute_dtype=compute_dtype, tp=len(self.devices), rank=r).to(dev)
            for r, dev in enumerate(self.devices))

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's state_dict, gathered onto the first device."""
        return gather_state_dict([s.state_dict() for s in self.shards])

    def load_state_dict(self, state_dict: dict[str, torch.Tensor], strict: bool = True) -> None:
        """Load a whole model's state_dict: each rank copies its share."""
        parts = shard_state_dict(state_dict, self.spec, len(self.shards))
        for shard, part in zip(self.shards, parts):
            shard.load_state_dict(part, strict=strict)

    def forward(self, ids, mask, type_ids=None, devices=None):
        devices = self.devices if devices is None else [torch.device(d) for d in devices]
        ids, mask = ids.to(devices[0]), mask.to(devices[0])
        x = self.shards[0].embed(ids, None if type_ids is None else type_ids.to(devices[0]))
        flash = self.flash and ids.shape[1] >= 128
        masks = {dev: mask.to(dev) for dev in devices}
        attn_masks = {dev: None if flash else _two_sided(m) for dev, m in masks.items()}
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.spec.layers):
            if remat:
                x = checkpoint(self._layer, i, x, masks, attn_masks, flash, devices,
                               use_reentrant=False)
            else:
                x = self._layer(i, x, masks, attn_masks, flash, devices)
        return x

    def _layer(self, i: int, x, masks, attn_masks, flash: bool, devices) -> torch.Tensor:
        ranks = [(shard.layers[i], dev) for shard, dev in zip(self.shards, devices)]
        head = ranks[0][0]
        parts = [_partial(layer.attention.heads_out(x.to(dev), masks[dev], attn_masks[dev],
                                                    flash), layer.attention.out)
                 for layer, dev in ranks]
        x = _layer_norm(x + _row_sum(parts, head.attention.out.bias, x.dtype),
                        head.attention_ln)
        parts = [_partial(layer.ffn(x.to(dev)), layer.output) for layer, dev in ranks]
        return _layer_norm(x + _row_sum(parts, head.output.bias, x.dtype), head.output_ln)


def _row_sum(parts: list[torch.Tensor], bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The ranks' partials summed in f32 on the first one's device, plus
    the bias, in `dtype`."""
    total = reduce_partials([p.to(torch.float32) for p in parts])
    return (total + bias.to(total.device)).to(dtype)


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling over tokens (sentence-transformers style)."""
    m = mask[:, :, None].to(hidden.dtype)
    summed = torch.sum(hidden * m, dim=1)
    counts = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return summed / counts


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """Flax BertEncoder params (nested dicts of arrays) -> BertEncoder
    state_dict.  Flax Dense kernels are (in, out) and nn.Linear weights
    (out, in); the attention's query/key/value kernels are (H, heads, hd)
    and its out kernel (heads, hd, H)."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def dense(p) -> tuple[torch.Tensor, torch.Tensor]:
        return t(p["kernel"]).T.contiguous(), t(p["bias"])

    def ln(p) -> tuple[torch.Tensor, torch.Tensor]:
        return t(p["scale"]), t(p["bias"])

    sd: dict[str, torch.Tensor] = {
        "word_embeddings.weight": t(tree["word_embeddings"]["embedding"]),
        "position_embeddings.weight": t(tree["position_embeddings"]["embedding"]),
        "token_type_embeddings.weight": t(tree["token_type_embeddings"]["embedding"]),
    }
    sd["embeddings_ln.weight"], sd["embeddings_ln.bias"] = ln(tree["embeddings_ln"])
    i = 0
    while f"layer_{i}" in tree:
        layer, pre = tree[f"layer_{i}"], f"layers.{i}."
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            kern = t(attn[name]["kernel"])                  # (H, heads, hd)
            sd[pre + f"attention.{name}.weight"] = kern.reshape(kern.shape[0], -1).T.contiguous()
            sd[pre + f"attention.{name}.bias"] = t(attn[name]["bias"]).reshape(-1)
        kern = t(attn["out"]["kernel"])                     # (heads, hd, H)
        sd[pre + "attention.out.weight"] = kern.reshape(-1, kern.shape[-1]).T.contiguous()
        sd[pre + "attention.out.bias"] = t(attn["out"]["bias"])
        sd[pre + "attention_ln.weight"], sd[pre + "attention_ln.bias"] = ln(layer["attention_ln"])
        sd[pre + "intermediate.weight"], sd[pre + "intermediate.bias"] = dense(layer["intermediate"])
        sd[pre + "output.weight"], sd[pre + "output.bias"] = dense(layer["output"])
        sd[pre + "output_ln.weight"], sd[pre + "output_ln.bias"] = ln(layer["output_ln"])
        i += 1
    return sd

