"""Plain float32 ModernBERT forward (answerdotai/ModernBERT-large's
config.json, transformers' ModernBertModel with its eager attention).

Token embedding and a bias-free LayerNorm; per layer i, x + Wo(attn(
attn_norm(x))) (no attn_norm at layer 0) and x + Wo(gelu(input) * gate)
with input, gate = Wi(mlp_norm(x)) split in two; a final bias-free
LayerNorm.  Attention: Wqkv's output is q | k | v, heads of
hidden / heads; RoPE (rotate-half, angles in f32) at global_rope_theta
where i % global_attn_every_n_layers == 0, else at local_rope_theta;
scores q.k / sqrt(head_dim) with keys at padding, and on local layers
pairs with |i - j| > local_attention // 2, filled with finfo(f32).min
(transformers' fill) before the softmax.  GELU is erf GELU.

`w` is a state dict under transformers' ModernBertModel names (the port's
ModernBertEncoder names), `cfg` a dict of its config.json keys.  The whole
T x T score matrix is built on every layer: this is for small shapes.
Plain torch on f32 tensors with TF32 off (`f32_matmul`); it imports
nothing of the port.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32_matmul():
    """Full f32 matrix products on a card for the duration (TF32 off)."""
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


def _rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """RoPE on (B, heads, T, head_dim) x at `base`."""
    t, d = x.shape[-2:]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.int64).float() / d))
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1).to(x.device)
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * ang.cos() + rot * ang.sin()


def hidden_states(w: dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, T) ids and 0/1 mask -> (B, T, hidden) f32 final hidden states."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = h // nh, cfg["norm_eps"]
    b, t = ids.shape

    def norm(x, name):
        return F.layer_norm(x, (h,), w[name], None, eps)

    x = norm(w["embeddings.tok_embeddings.weight"][ids], "embeddings.norm.weight")
    pos = torch.arange(t, device=ids.device)
    band = (pos[:, None] - pos[None, :]).abs() <= cfg["local_attention"] // 2
    real_key = (mask > 0)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        is_global = i % cfg["global_attn_every_n_layers"] == 0
        a = x if i == 0 else norm(x, p + "attn_norm.weight")
        qkv = (a @ w[p + "attn.Wqkv.weight"].T).view(b, t, 3, nh, hd).transpose(1, 3)
        q, k, v = qkv.unbind(2)                                # (B, heads, T, hd)
        base = cfg["global_rope_theta"] if is_global else cfg["local_rope_theta"]
        q, k = _rope(q, base), _rope(k, base)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        keep = real_key if is_global else real_key & band
        s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, h)
        x = x + o @ w[p + "attn.Wo.weight"].T
        gin, gate = (norm(x, p + "mlp_norm.weight") @ w[p + "mlp.Wi.weight"].T).chunk(2, dim=-1)
        x = x + (F.gelu(gin) * gate) @ w[p + "mlp.Wo.weight"].T
    return norm(x, "final_norm.weight")


def embed(w, cfg, ids, mask) -> torch.Tensor:
    """(B, hidden) f32 sentence embeddings: the mean of the final hidden
    states over real tokens, L2-normalised (the port's pooling)."""
    x = hidden_states(w, cfg, ids, mask)
    m = mask[:, :, None].to(torch.float32)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True).clamp(min=1e-12)
