"""Plain float32 BERT trunk and mean-pooled, L2-normalised embeddings.

The published post-LayerNorm BERT (Devlin et al. 2019, as in
sentence-transformers' MiniLM and BAAI's bge): word + position + token-type
embeddings and a LayerNorm; per layer, multi-head self-attention with keys
at padding masked out, an output projection, residual and LayerNorm, then
an erf-GELU feed-forward, residual and LayerNorm; LayerNorm eps from the
configuration.  Sentence embeddings are the mean of the final hidden states
over real tokens, divided by their L2 norm.

Plain torch on f32 tensors, with TF32 off (`f32_matmul`).  `quant`, where
given, rounds both operands of every matrix product (the control: the same
forward in a lower precision).  It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32_matmul():
    """Full f32 matrix products on the card for the duration (TF32 off)."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax to 448),
    back in f32; the gradient passes straight through."""
    with torch.no_grad():
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = 448.0 / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def _mm(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.T


def _linear(x, w, b, quant):
    return _mm(x, w, quant) + b


def hidden_states(w: dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                  mask: torch.Tensor, quant=None) -> torch.Tensor:
    """(B, T) ids and 0/1 mask -> (B, T, hidden) f32 final hidden states."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = h // nh
    eps = cfg["layer_norm_eps"]
    b, t = ids.shape
    pos = torch.arange(t, device=ids.device)
    x = (w["word_embeddings.weight"][ids] + w["position_embeddings.weight"][pos][None]
         + w["token_type_embeddings.weight"][0][None, None])
    x = F.layer_norm(x, (h,), w["embeddings_ln.weight"], w["embeddings_ln.bias"], eps)
    keep = (mask > 0)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."

        def proj(name, inp):
            return _linear(inp, w[p + f"attention.{name}.weight"],
                           w[p + f"attention.{name}.bias"], quant)

        q = proj("query", x).view(b, t, nh, hd).transpose(1, 2)
        k = proj("key", x).view(b, t, nh, hd).transpose(1, 2)
        v = proj("value", x).view(b, t, nh, hd).transpose(1, 2)
        if quant is not None:
            q, k, v = quant(q), quant(k), quant(v)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~keep, float("-inf"))
        a = torch.softmax(s, dim=-1)
        if quant is not None:
            a = quant(a)
        o = (a @ v).transpose(1, 2).reshape(b, t, h)
        x = F.layer_norm(x + proj("out", o), (h,), w[p + "attention_ln.weight"],
                         w[p + "attention_ln.bias"], eps)
        f = F.gelu(_linear(x, w[p + "intermediate.weight"], w[p + "intermediate.bias"], quant))
        x = F.layer_norm(x + _linear(f, w[p + "output.weight"], w[p + "output.bias"], quant),
                         (h,), w[p + "output_ln.weight"], w[p + "output_ln.bias"], eps)
    return x


def embed(w, cfg, ids, mask, quant=None) -> torch.Tensor:
    """(B, hidden) f32 sentence embeddings: masked mean, L2-normalised."""
    x = hidden_states(w, cfg, ids, mask, quant)
    m = mask[:, :, None].to(torch.float32)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True).clamp(min=1e-12)

