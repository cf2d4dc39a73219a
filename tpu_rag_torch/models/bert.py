"""BERT-family transformer trunk (MiniLM / bge), port of tpu_rag/models/bert.py.

Post-LayerNorm BERT with erf GELU and LayerNorm eps 1e-12, as an nn.Module.
Parameters stay f32; the forward runs in `compute_dtype` (bf16 on the GPU,
f32 on the CPU — set by BiEncoder), with LayerNorm and softmax in f32.

Attention takes the fused kernel (ops/attention.py) when T >= 128, as the
JAX trunk does with flash=True; shorter buckets take plain matmul -> softmax
-> matmul with the JAX path's two-sided mask (query & key) and Flax's
finfo(dtype).min fill.

`params_from_flax` carries a Flax param tree of tpu_rag's BertEncoder (nested
dicts of numpy arrays) into this module's state_dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_rag_torch.ops.attention import fused_mha


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


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight,
                        ln.bias, ln.eps).to(x.dtype)


class SelfAttention(nn.Module):
    def __init__(self, spec: BertSpec) -> None:
        super().__init__()
        self.heads = spec.heads
        self.head_dim = spec.hidden // spec.heads
        self.query = nn.Linear(spec.hidden, spec.hidden)
        self.key = nn.Linear(spec.hidden, spec.hidden)
        self.value = nn.Linear(spec.hidden, spec.hidden)
        self.out = nn.Linear(spec.hidden, spec.hidden)

    def forward(self, x, mask, attn_mask, flash: bool):
        b, t, hidden = x.shape
        shape = (b, t, self.heads, self.head_dim)
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
        return _linear(o.reshape(b, t, hidden), self.out)


class BertLayer(nn.Module):
    def __init__(self, spec: BertSpec) -> None:
        super().__init__()
        self.attention = SelfAttention(spec)
        self.attention_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)
        self.intermediate = nn.Linear(spec.hidden, spec.ffn)
        self.output = nn.Linear(spec.ffn, spec.hidden)
        self.output_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)

    def forward(self, x, mask, attn_mask, flash: bool):
        x = _layer_norm(x + self.attention(x, mask, attn_mask, flash), self.attention_ln)
        h = F.gelu(_linear(x, self.intermediate), approximate="none")
        return _layer_norm(x + _linear(h, self.output), self.output_ln)


class BertEncoder(nn.Module):
    """Returns final hidden states (B, T, H) in `compute_dtype`."""

    def __init__(self, spec: BertSpec, *, flash: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.spec = spec
        self.flash = flash
        self.compute_dtype = compute_dtype
        self.word_embeddings = nn.Embedding(spec.vocab_size, spec.hidden)
        self.position_embeddings = nn.Embedding(spec.max_len, spec.hidden)
        self.token_type_embeddings = nn.Embedding(spec.type_vocab, spec.hidden)
        self.embeddings_ln = nn.LayerNorm(spec.hidden, eps=spec.ln_eps)
        self.layers = nn.ModuleList(BertLayer(spec) for _ in range(spec.layers))

    def forward(self, ids, mask, type_ids=None):
        b, t = ids.shape
        dt = self.compute_dtype
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        pos = torch.arange(t, device=ids.device)[None, :]
        x = (self.word_embeddings(ids).to(dt) + self.position_embeddings(pos).to(dt)
             + self.token_type_embeddings(type_ids).to(dt))
        x = _layer_norm(x, self.embeddings_ln)
        flash = self.flash and t >= 128
        # (B, 1, T, T) two-sided mask, built only for the plain path; the
        # fused kernel masks keys from the (B, T) mask
        attn_mask = (None if flash else
                     (mask[:, None, None, :] > 0) & (mask[:, None, :, None] > 0))
        for layer in self.layers:
            x = layer(x, mask, attn_mask, flash)
        return x


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

