"""Seeded BERT weights, made on the device in one draw.

Both sides of a comparison get these tensors: the program loads them as
its state dict, the plain reference reads them as they are.  The names and
shapes are those of a BERT trunk's state dict (`word_embeddings.weight`,
`layers.{i}.attention.query.weight`, ...): nn.Linear weights are
(out, in).  One normal draw of every element comes from a torch.Generator
on the device; each tensor is a scaled slice of it: Linear weights
LeCun-normal (std 1/sqrt(fan_in)), embeddings std 1/sqrt(hidden), biases
and LayerNorm shifts std 0.02, LayerNorm scales 1 + 0.02 N(0, 1), so every
parameter of the forward takes part in the comparison.
"""

from __future__ import annotations

import torch


def bert_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """name -> shape of every parameter of the trunk that `cfg` (a
    configuration file's dict, HF config keys) describes."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    shapes: dict[str, tuple[int, ...]] = {
        "word_embeddings.weight": (cfg["vocab_size"], h),
        "position_embeddings.weight": (cfg["max_position_embeddings"], h),
        "token_type_embeddings.weight": (cfg["type_vocab_size"], h),
        "embeddings_ln.weight": (h,),
        "embeddings_ln.bias": (h,),
    }
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for name in ("query", "key", "value", "out"):
            shapes[p + f"attention.{name}.weight"] = (h, h)
            shapes[p + f"attention.{name}.bias"] = (h,)
        shapes[p + "intermediate.weight"] = (f, h)
        shapes[p + "intermediate.bias"] = (f,)
        shapes[p + "output.weight"] = (h, f)
        shapes[p + "output.bias"] = (h,)
        for ln in ("attention_ln", "output_ln"):
            shapes[p + f"{ln}.weight"] = (h,)
            shapes[p + f"{ln}.bias"] = (h,)
    return shapes


def _scale(name: str, shape: tuple[int, ...], hidden: int) -> tuple[float, float]:
    """(offset, std) of the parameter's distribution."""
    if "embeddings.weight" in name:
        return 0.0, hidden ** -0.5
    if name.endswith("_ln.weight"):
        return 1.0, 0.02
    if name.endswith(".bias"):
        return 0.0, 0.02
    return 0.0, shape[1] ** -0.5


def seeded_bert(cfg: dict, seed: int, device: str | torch.device) -> dict[str, torch.Tensor]:
    """f32 parameters of the trunk, drawn from `seed` on `device` in one
    call; the same seed and device give the same tensors."""
    shapes = bert_shapes(cfg)
    total = sum(torch.Size(s).numel() for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        offset, std = _scale(name, shape, cfg["hidden_size"])
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(offset)
        at += n
    return out


def seeded_unit_rows(n: int, d: int, seed: int, device: str | torch.device,
                     block: int = 1 << 18) -> torch.Tensor:
    """(n, d) f32 rows of unit norm, drawn from `seed` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) ^ 0x5EED_0F_0C)
    x = torch.randn((n, d), generator=g, device=device, dtype=torch.float32)
    for i in range(0, n, block):
        x[i:i + block] /= torch.linalg.vector_norm(x[i:i + block], dim=1, keepdim=True)
    return x
