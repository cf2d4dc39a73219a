"""ModernBERT's seeded weights and model FLOPs, for the cells of a
ModernBERT configuration (a configuration file's dict of HF config keys).

Weights: the names and shapes of transformers' ModernBertModel state dict
(`embeddings.tok_embeddings.weight`, `layers.{i}.attn.Wqkv.weight`, ...),
which the program's ModernBertEncoder shares; nn.Linear weights are (out,
in).  One normal draw of every element comes from a torch.Generator on the
device; each tensor is a scaled slice of it: Linear weights LeCun-normal
(std 1/sqrt(fan_in)), the token table std 1/sqrt(hidden), LayerNorm scales
1 + 0.02 N(0, 1).  The published model has no biases.

FLOPs of a contrastive step, as `mfu.train` counts them here: 6 x the
parameters outside the token table x the real tokens, plus the attention
over each row's real length L, forward x 3: 4 L^2 hidden on every global
layer and 4 L min(L, local_attention + 1) hidden on every local one.  No
recomputation, padding or masked score is counted.
"""

from __future__ import annotations

import torch


def _global(cfg: dict, i: int) -> bool:
    return i % cfg["global_attn_every_n_layers"] == 0


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """name -> shape of every parameter of the trunk."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    out: dict[str, tuple[int, ...]] = {"embeddings.tok_embeddings.weight": (cfg["vocab_size"], h),
                                       "embeddings.norm.weight": (h,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        if i:
            out[p + "attn_norm.weight"] = (h,)
        out[p + "attn.Wqkv.weight"] = (3 * h, h)
        out[p + "attn.Wo.weight"] = (h, h)
        out[p + "mlp_norm.weight"] = (h,)
        out[p + "mlp.Wi.weight"] = (2 * f, h)
        out[p + "mlp.Wo.weight"] = (h, f)
    out["final_norm.weight"] = (h,)
    return out


def seeded(cfg: dict, seed: int, device: str | torch.device) -> dict[str, torch.Tensor]:
    """f32 parameters of the trunk, drawn from `seed` on `device` in one
    call; the same seed and device give the same tensors."""
    shp = shapes(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(sum(torch.Size(s).numel() for s in shp.values()), generator=g,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, s in shp.items():
        n = torch.Size(s).numel()
        x = flat[at:at + n].view(s)
        if len(s) == 1:
            x.mul_(0.02).add_(1.0)
        elif name == "embeddings.tok_embeddings.weight":
            x.mul_(cfg["hidden_size"] ** -0.5)
        else:
            x.mul_(s[1] ** -0.5)
        out[name] = x
        at += n
    return out


def nonembedding_params(cfg: dict) -> int:
    """Parameters outside the token table."""
    return sum(torch.Size(s).numel() for name, s in shapes(cfg).items()
               if name != "embeddings.tok_embeddings.weight")


def forward_flops(cfg: dict, real_lens) -> float:
    """Model FLOPs of one forward over rows of these real lengths."""
    h, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_global = sum(_global(cfg, i) for i in range(layers))
    band = cfg["local_attention"] + 1
    lens = [int(x) for x in real_lens]
    attn = 4.0 * h * (n_global * sum(n * n for n in lens)
                      + (layers - n_global) * sum(n * min(n, band) for n in lens))
    return 2.0 * nonembedding_params(cfg) * sum(lens) + attn


def train_step_flops(cfg: dict, q_lens, d_lens) -> float:
    """Model FLOPs of one contrastive step: forward and backward (3x the
    forward) of both towers."""
    return 3.0 * (forward_flops(cfg, q_lens) + forward_flops(cfg, d_lens))
