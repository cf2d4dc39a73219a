"""ModernBERT trunk (Warner et al. 2024, arXiv:2412.13663), as
answerdotai/ModernBERT-large's config.json and transformers'
`ModernBertModel` define it.

- Embedding: token table, then a LayerNorm; no position or token-type
  tables (positions enter through RoPE).
- Pre-norm layers: x + attn(attn_norm(x)), then x + mlp(mlp_norm(x)); layer
  0 has no attn_norm; a final_norm after the last layer.  Every LayerNorm
  has no bias; no Linear has a bias.
- Attention: one fused `Wqkv` (hidden -> 3 x hidden, laid out q | k | v,
  each heads x head_dim), RoPE in the rotate-half form on q and k, then
  `Wo`.  Layer i is global where i % global_every == 0 (RoPE base
  global_rope_theta, every key) and local otherwise (base local_rope_theta,
  keys with |i - j| <= window // 2).  Keys at padding are masked.
- MLP: GeGLU.  `Wi` is hidden -> 2 x ffn, split into input and gate;
  Wo(gelu(input) * gate) with erf GELU.

Parameters stay f32; the forward runs its products in `compute_dtype`
(bf16 on the card, f32 on the CPU), LayerNorm and softmax in f32.  The
residual stream stays f32 (a LayerNorm's f32 output plus each block's
compute-dtype output), as mixed-precision training keeps it.  State-dict
names are those of transformers' ModernBertModel, so a checkpoint's names
map one to one (models/hf_import.py).

Both kinds of attention are ops/ragged_attention.py's, given each row's
real length (the mask's row sums, on the device: the masks are real
prefixes, as the tokenizers and the sampler pad at the end) and the
layer's window (w = window // 2 on a local layer, none on a global one).
On the card its hand-written kernels score only the tiles of real pairs:
no tile past a row's end, and on a local layer only the 64-key chunks
within w of a warp's rows; forward and backward are kernels of static
launch shape, so the trainer's CUDA graph captures them.  On the CPU it
runs the plain version: `band_attention` (queries in blocks of w rows,
each against the 3w keys its rows can reach: O(T x window) work and
memory) and `F.scaled_dot_product_attention` under an additive key mask
on global layers.  Either way the padded query rows come out as zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_rag_torch.ops import ragged_attention as ra
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
from tpu_rag_torch.utils.timing import span


@dataclass(frozen=True)
class ModernBertSpec:
    """ModernBERT-large's published sizes by default."""
    vocab_size: int = 50368
    hidden: int = 1024
    layers: int = 28
    heads: int = 16
    ffn: int = 2624                     # intermediate_size: Wi is hidden -> 2 x ffn
    max_len: int = 8192
    global_every: int = 3               # global_attn_every_n_layers
    window: int = 128                   # local_attention: keys within window // 2
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    ln_eps: float = 1e-5                # norm_eps

    # parallel/tensor.py's partition rules are BERT's: one device only
    tensor_parallel: ClassVar[bool] = False

    def is_global(self, layer: int) -> bool:
        return layer % self.global_every == 0

    def encoder(self, *, train: bool = False,
                compute_dtype: torch.dtype = torch.float32) -> "ModernBertEncoder":
        """The trunk; for training, each layer recomputed in the backward
        pass (both attentions have backwards)."""
        return ModernBertEncoder(self, remat=train, compute_dtype=compute_dtype)

    def sized_for(self, vocab_size: int, positions: int) -> "ModernBertSpec":
        """The published model, which must hold `vocab_size` ids and
        `positions` positions (ValueError otherwise)."""
        if vocab_size > self.vocab_size or positions > self.max_len:
            raise ValueError(f"{vocab_size} ids and {positions} positions: ModernBERT holds "
                             f"{self.vocab_size} ids and {self.max_len} positions")
        return self

    def prepare(self, device: torch.device | str, compute_dtype: torch.dtype) -> None:
        """Where the trunk will run: on the card its attention kernels take
        bf16 only (ValueError for another compute dtype; an f32 forward
        runs on the CPU), and their build starts there in a background
        thread, so that it overlaps the caller's set-up."""
        if torch.device(device).type == "cuda":
            if compute_dtype != torch.bfloat16:
                raise ValueError(f"ModernBERT's attention on the card takes bf16 only "
                                 f"(ops/ragged_attention.py), not {compute_dtype}: run it in "
                                 f"bf16, or in f32 on the CPU")
            ra.prepare()

    def record_attention(self, *masks, device: torch.device | str = "cpu") -> None:
        """A training step's attention counters (record_attention), as the
        attention on `device` scores them."""
        record_attention(self, *masks, tiled=torch.device(device).type == "cuda")

    def hf_names(self) -> dict[str, str]:
        """encoder() state-dict name -> HF ModernBertModel name: the same."""
        with torch.device("meta"):
            return {k: k for k in self.encoder().state_dict()}

    def hf_config(self) -> dict:
        """HF ModernBertModel config.json keys; the pad id is the port's
        tokenizers' (transformers' table keeps that row out of training)."""
        from tpu_rag_torch.models.tokenizer import PAD_ID

        return {"architectures": ["ModernBertModel"], "model_type": "modernbert",
                "vocab_size": self.vocab_size, "hidden_size": self.hidden,
                "num_hidden_layers": self.layers, "num_attention_heads": self.heads,
                "intermediate_size": self.ffn, "max_position_embeddings": self.max_len,
                "global_attn_every_n_layers": self.global_every,
                "local_attention": self.window, "global_rope_theta": self.global_rope_theta,
                "local_rope_theta": self.local_rope_theta, "norm_eps": self.ln_eps,
                "norm_bias": False, "attention_bias": False, "mlp_bias": False,
                "hidden_activation": "gelu", "pad_token_id": PAD_ID}

    @classmethod
    def from_hf_config(cls, cfg: dict) -> "ModernBertSpec | None":
        """The spec of a HF ModernBertConfig dict, or None where keys are
        missing.  Biases or another activation than erf GELU raise
        ValueError: the trunk has neither."""
        unsupported = [k for k in ("attention_bias", "mlp_bias", "norm_bias") if cfg.get(k)]
        if cfg.get("hidden_activation", "gelu") != "gelu":
            unsupported.append(f"hidden_activation {cfg['hidden_activation']}")
        if unsupported:
            raise ValueError(f"ModernBERT config with {unsupported}: the port's trunk has no "
                             f"biases and erf GELU only")
        try:
            return cls(vocab_size=int(cfg["vocab_size"]), hidden=int(cfg["hidden_size"]),
                       layers=int(cfg["num_hidden_layers"]),
                       heads=int(cfg["num_attention_heads"]), ffn=int(cfg["intermediate_size"]),
                       max_len=int(cfg["max_position_embeddings"]),
                       global_every=int(cfg["global_attn_every_n_layers"]),
                       window=int(cfg["local_attention"]),
                       global_rope_theta=float(cfg["global_rope_theta"]),
                       local_rope_theta=float(cfg["local_rope_theta"]),
                       ln_eps=float(cfg["norm_eps"]))
        except (KeyError, ValueError, TypeError):
            return None


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.device, x.dtype))


def _norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """Bias-free LayerNorm in f32, returned in `dtype`."""
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight.to(x.device),
                        None, ln.eps).to(dtype)


def rope(t: int, head_dim: int, base: float, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, head_dim) cos and signed sin of positions 0..T-1 at `base`,
    angles in f32 (transformers' default RoPE), returned in `dtype`; the
    sin's first half negated, as _rotate takes it."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.int64).float() / head_dim))
    ang = torch.arange(t, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    sin = ang.sin()
    return torch.cat((ang, ang), dim=-1).cos().to(dtype), torch.cat((-sin, sin), dim=-1).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, signed_sin: torch.Tensor) -> torch.Tensor:
    """RoPE, rotate-half form, on (B, T, H, D) x: x cos + rotate_half(x) sin,
    where rotate_half(x) = [-x2, x1] is [x2, x1] times rope()'s signed sin."""
    halves = x.unflatten(-1, (2, x.shape[-1] // 2)).flip(-2).flatten(-2)
    return torch.addcmul(x * cos[None, :, None, :], halves, signed_sin[None, :, None, :])


class ModernBertLayer(nn.Module):
    def __init__(self, spec: ModernBertSpec, index: int) -> None:
        super().__init__()
        h = spec.hidden
        self.is_global = spec.is_global(index)
        self.heads = spec.heads
        self.half_window = spec.window // 2
        self.attn_norm = None if index == 0 else nn.LayerNorm(h, eps=spec.ln_eps, bias=False)
        self.attn = nn.ModuleDict({"Wqkv": nn.Linear(h, 3 * h, bias=False),
                                   "Wo": nn.Linear(h, h, bias=False)})
        self.mlp_norm = nn.LayerNorm(h, eps=spec.ln_eps, bias=False)
        self.mlp = nn.ModuleDict({"Wi": nn.Linear(h, 2 * spec.ffn, bias=False),
                                  "Wo": nn.Linear(spec.ffn, h, bias=False)})

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                lengths: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, T, hidden) f32 -> the next layer's input; cos and signed sin
        at this layer's RoPE base (rope()); lengths (B,) int32, the rows'
        real lengths on x's device."""
        b, t, hid = x.shape
        h = x.to(dtype) if self.attn_norm is None else _norm(x, self.attn_norm, dtype)
        # one product a row block of Wqkv (and of Wi below): each output is
        # contiguous, so RoPE's and GeGLU's elementwise ops run vectorised
        # where one fused product would leave them strided views
        wqkv = self.attn["Wqkv"].weight.to(h.device, dtype)
        q, k, v = (F.linear(h, part).view(b, t, self.heads, -1) for part in wqkv.chunk(3))
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if self.is_global:
            with span("modernbert.attn_global"):
                o = ra.ragged_attention(q, k, v, lengths)
        else:
            with span("modernbert.attn_local"):
                o = ra.ragged_attention(q, k, v, lengths, self.half_window)
        x = x + _linear(o.reshape(b, t, hid), self.attn["Wo"])
        m = _norm(x, self.mlp_norm, dtype)
        wi = self.mlp["Wi"].weight.to(m.device, dtype)
        gin, gate = (F.linear(m, part) for part in wi.chunk(2))
        return x + _linear(F.gelu(gin, approximate="none") * gate, self.mlp["Wo"])


class ModernBertEncoder(nn.Module):
    """(ids, mask) -> final hidden states (B, T, hidden) in `compute_dtype`,
    BertEncoder's call.  remat=True recomputes each layer in the backward
    pass (torch.utils.checkpoint), numerics unchanged."""

    def __init__(self, spec: ModernBertSpec, *, remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if spec.hidden % spec.heads or (spec.hidden // spec.heads) % 2:
            raise ValueError(f"hidden {spec.hidden} over {spec.heads} heads: RoPE needs an "
                             f"even head size")
        if spec.window < 2:
            raise ValueError(f"local window {spec.window}: it must reach at least one key")
        self.spec = spec
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.embeddings = nn.ModuleDict({
            "tok_embeddings": nn.Embedding(spec.vocab_size, spec.hidden),
            "norm": nn.LayerNorm(spec.hidden, eps=spec.ln_eps, bias=False)})
        self.layers = nn.ModuleList(ModernBertLayer(spec, i) for i in range(spec.layers))
        self.final_norm = nn.LayerNorm(spec.hidden, eps=spec.ln_eps, bias=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """mask: (B, T), each row real on a prefix and pad after it (checked
        where it lies on the CPU; on the card a check would read it back)."""
        spec, dt = self.spec, self.compute_dtype
        t = ids.shape[1]
        if t > spec.max_len:
            raise ValueError(f"{t} positions: the model was trained for {spec.max_len}")
        if mask.device.type == "cpu" and not ra.is_prefix(mask):
            raise ValueError("ModernBERT's attention takes masks that are real on a prefix "
                             "of each row and pad after it")
        table = self.embeddings["tok_embeddings"].weight
        x = _norm(F.embedding(ids, table.to(ids.device)), self.embeddings["norm"], torch.float32)
        hd = spec.hidden // spec.heads
        ropes = {g: rope(t, hd, spec.global_rope_theta if g else spec.local_rope_theta,
                         ids.device, dt) for g in (True, False)}
        lengths = ra.lengths_of(mask.to(ids.device))
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (x, *ropes[layer.is_global], lengths, dt)
            # no op draws a random number, so the RNG state need not be
            # saved for the recompute (and reading it fails under capture)
            x = (checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
                 if remat else layer(*args))
        return _norm(x, self.final_norm, dt)


def attention_counts(spec: ModernBertSpec, lengths, t: int, *,
                     tiled: bool = False) -> tuple[int, int, int]:
    """What one forward's attention computes over rows of these real
    lengths padded to t, counted in query x key pairs summed over layers
    (heads not counted): the local layers' score slots, the global
    layers', and the pairs that are inside the window (local) and between
    real tokens.  The slots are those the path scores: with tiled, the
    card's kernels' visited tiles (ops/ragged_attention.visited_slots);
    else the plain version's (B x the padded blocks' rows x 3w on a local
    layer, B x T x T on a global one)."""
    w = spec.window // 2
    n_global = sum(spec.is_global(i) for i in range(spec.layers))
    n_local = spec.layers - n_global
    lens = np.asarray(lengths, np.int64)
    rows = len(lens)
    if tiled:
        local = n_local * ra.visited_slots(lens, t, w)
        glob = n_global * ra.visited_slots(lens, t, None)
    else:
        local = n_local * rows * (-(-t // w) * w) * 3 * w
        glob = n_global * rows * t * t
    out_of_band = np.maximum(lens - w - 1, 0)
    out_of_band = out_of_band * (out_of_band + 1)       # pairs with |i - j| > w
    real = n_local * int((lens * lens - out_of_band).sum()) + n_global * int((lens * lens).sum())
    return local, glob, real


def record_attention(spec: ModernBertSpec, *masks, tiled: bool = False) -> None:
    """Add attention_counts of (B, T) host masks (numpy) to GLOBAL_METRICS:
    attn_local_key_slots_total, attn_global_key_slots_total and
    attn_real_pairs_total.  Counted on the host from the batch, so a step
    replayed from a CUDA graph (which runs no Python) counts as an eager
    one does."""
    for m in masks:
        m = np.asarray(m)
        local, glob, real = attention_counts(spec, (m > 0).sum(axis=1), m.shape[1], tiled=tiled)
        GLOBAL_METRICS.inc("attn_local_key_slots_total", local)
        GLOBAL_METRICS.inc("attn_global_key_slots_total", glob)
        GLOBAL_METRICS.inc("attn_real_pairs_total", real)
