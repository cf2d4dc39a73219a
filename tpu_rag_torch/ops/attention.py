"""Fused multi-head self-attention for the encoder forward (port of
tpu_rag/ops/attention.py).

`fused_mha(q, k, v, mask)` with q/k/v (B, T, H, D) computes, per (batch,
head), softmax(Q.K^T / sqrt(D), keys with mask 0 set to -1e30).V with scores
and softmax in f32 and the output in the input dtype.  Only the key side is
masked: pad query rows come out as values the callers' masked mean-pool
drops.  Forward only: on the card a q/k/v that requires grad raises (the
kernel has no backward; training uses the encoder's plain attention).  On a
CUDA tensor it launches csrc/attention.cu (kernel #5: for
bf16, Q.K^T and P.V on the tensor cores over a cp.async ring of 64-key K/V
chunks (all of T at D 32, five at D 64) and an online softmax a chunk,
T <= 512; for f32, register
micro-tiles on the CUDA cores over the same kind of ring, any T; both one
block per 128-query tile) or raises; on a CPU tensor it
runs the plain version below, which repeats the JAX kernel's arithmetic.
"""

from __future__ import annotations

import math

import torch

from tpu_rag_torch import _build

_MASK_VALUE = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_T_MAX = 512          # bf16: the encoders' longest sequence bucket, as far as it is checked


def fused_mha_plain(q, k, v, mask):
    """Plain version of kernel #5, on any device: the JAX kernel's order of
    operations (f32 scores scaled after the dot, -1e30 key fill, softmax
    normalised before the bf16 cast of the probabilities)."""
    b, t, h, d = q.shape
    qh = q.permute(0, 2, 1, 3).to(torch.float32)
    kh = k.permute(0, 2, 1, 3).to(torch.float32)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    keep = (mask > 0)[:, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, _MASK_VALUE))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(torch.float32),
                     v.permute(0, 2, 1, 3).to(torch.float32))
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def _fused_mha_cuda(q, k, v, mask):
    """Launch kernel #5 of csrc/attention.cu.  Forward only: the kernel has
    no backward (nor has tpu_rag's), so a call that autograd would have to
    differentiate raises rather than return an output with no gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "fused_mha (kernel #5) has no backward: run it under torch.no_grad(), "
            "or build the encoder with flash=False to train through the plain "
            "attention")
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mha supports f32 and bf16, got {q.dtype}")
    if d not in _HEAD_DIMS or (q.dtype == torch.bfloat16 and t > _T_MAX):
        raise ValueError(f"fused_mha supports D in {_HEAD_DIMS} and, in bf16, T <= {_T_MAX}; "
                         f"got D={d}, T={t}, {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_mha needs contiguous (B, T, H, D) q/k/v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("fused_mha needs 16-byte aligned q/k/v (its 16-byte async copies)")
    if mask.shape != (b, t) or mask.device != q.device:
        raise ValueError(f"mask must be (B, T) = {(b, t)} on {q.device}")
    mask32 = mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", "tr_mha",
                         [_build.P] * 5 + [_build.I] * 5 + [_build.P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask32.data_ptr(),
                 out.data_ptr(), b, t, h, d, _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "tr_mha", "attention")
    _fused_mha_cuda.launches += 1
    if q.dtype == torch.float32:
        _fused_mha_cuda.f32_launches += 1
    return out


_fused_mha_cuda.launches = 0        # every launch of #5
_fused_mha_cuda.f32_launches = 0    # those in f32 (mha_f32_kernel)


def fused_mha(q, k, v, mask):
    """Fused self-attention: q/k/v (B, T, H, D) -> (B, T, H, D); `mask` is
    the (B, T) token mask (nonzero = real token)."""
    if q.device.type == "cuda":
        return _fused_mha_cuda(q, k, v, mask)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fused_mha_plain(q, k, v, mask)
