"""Device resolution for the port's entry points.

Everything runs on the device the caller names.  "cuda" on a host without a
usable card raises: nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch.device for `device`, raising if it is a CUDA device
    and torch cannot reach a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (Config.device / DEVICE=cpu) to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda or cpu")
    return dev


def compute_dtype(device: torch.device) -> torch.dtype:
    """Encoder compute dtype: bf16 on the GPU, f32 on the CPU (parameters
    stay f32 either way) — the JAX package's rule of bf16 on the TPU and
    f32 elsewhere."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
