"""Operations of each model step, and the peak they are held against.

Peak: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit:
989 TFLOP/s bf16.  A share of the peak is the model's operations over the
peak times the time measured, so it cannot pass 100% unless the
operations are counted too high or the time leaves out part of the work.
A kernel's bytes and operations, for its roofline share, go here beside
the cell that first reads them.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12


def encoder_params(cfg: dict) -> int:
    """Parameters of the trunk outside the embedding tables (weights and
    biases of every Linear, LayerNorm scales and shifts)."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    return cfg["num_hidden_layers"] * per_layer


def encoder_forward_flops(cfg: dict, real_lens) -> float:
    """Model FLOPs of one forward over sequences of these real lengths: 2
    per non-embedding parameter a token, plus Q.K^T and P.V over the real
    positions (4 * T^2 * hidden a sequence a layer)."""
    h, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    tokens = sum(int(x) for x in real_lens)
    attn = 4.0 * h * layers * sum(int(x) ** 2 for x in real_lens)
    return 2.0 * encoder_params(cfg) * tokens + attn


def train_step_flops(cfg: dict, q_lens, d_lens) -> float:
    """Model FLOPs of one contrastive step: forward and backward (3x the
    forward) of both towers, no recomputation counted, plus the B x B
    similarity matrix (forward and backward)."""
    b = len(q_lens)
    sim = 3 * 2.0 * b * b * cfg["hidden_size"]
    return 3.0 * (encoder_forward_flops(cfg, q_lens) + encoder_forward_flops(cfg, d_lens)) + sim
