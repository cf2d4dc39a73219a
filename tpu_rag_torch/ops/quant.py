"""Int8 row quantization for index snapshots (port of tpu_rag/ops/quant.py).

Symmetric per-row int8: scale = max|row| / 127 (1.0 for an all-zero row),
values = round(row / scale) with round-half-to-even, clipped to +-127.  Plain
torch on whatever device the rows live on; the JAX package leaves this to XLA
as well.  XLA rewrites the division by the constant 127 as a multiplication
by f32(1/127), which differs from a true division in the last bit of ~6% of
the scales and so moves a few values across a rounding boundary; the default
here does the same, so its values equal the JAX package's device values.
`true_division=True` gives the JAX package's host mirror instead
(_quantize_int8_np, which flat.py uses for residuals and appends).
"""

from __future__ import annotations

import numpy as np
import torch

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8_rows(x: torch.Tensor, *, true_division: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, d) float -> (values int8 (n, d), scales float32 (n,))."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=1)
    scales = torch.where(absmax > 0,
                         absmax / 127.0 if true_division else absmax * _INV_127,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def quantize_int8_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of quantize_int8_rows for small numpy chunks
    (tpu_rag/index/flat.py _quantize_int8_np), with a true division by 127
    as in the JAX package's mirror."""
    absmax = np.max(np.abs(x), axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales
