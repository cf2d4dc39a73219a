"""Attention over rows padded at the end, in a window or over every key:
ModernBERT's local and global layers (models/modernbert.py), forward and
backward.

`ragged_attention(q, k, v, lengths, window)` with q/k/v (B, T, H, D)
computes, per (row b, head h), softmax_j(q_i . k_j / sqrt(D)) . v_j over
the keys j < lengths[b] with |i - j| <= window (every key below
lengths[b] where window is None).  The contract on the callers' masks:
each row's real tokens are its first lengths[b] (the tokenizers and
train_semantic's sampler pad at the end), so `lengths_of(mask)`, the
mask's row sums, says all there is to say about it.  Query rows at or past
lengths[b] come out as zeros and take no gradient, nor do keys there: no
real token and no pooled embedding depends on them.

On a CUDA tensor it runs csrc/ragged_attention.cu (bf16, D 64, any T and
window; a forward kernel on wgmma that saves each row's log-sum-exp, and a
backward of two kernels on mma.sync, dQ and then dK/dV, with no atomics)
through a torch.autograd.Function, or raises on what the kernels do not
take; the lengths stay on the device, so a step captured in a CUDA graph
replays with the batch's own lengths.  Each kernel's loops are bounded by
the row's length and the window: a 128-row tile past the row's end writes
its zeros and exits, a unit of rows past it (a forward warpgroup's 64, a
backward warp's 16) computes nothing, and each unit scores only the
64-key chunks its rows reach (`visited_slots` counts the forward's).  On a CPU tensor it runs the plain version below: the banded and
full attentions under additive masks (band_attention, global_attention),
with the padded query rows zeroed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rag_torch import _build

LIBRARY = "ragged_attention"
HEAD_DIM = 64
TILE = 128          # rows of a block: queries (forward, dQ) or keys (dK/dV) (kTile)
CHUNK = 64          # rows of a ring stage on the other side (kChunk)
UNIT_ROWS = 64      # query rows the forward scores as one unit: a warpgroup's (kWgRows)

_lock = threading.Lock()
_runs: dict[int, torch.Tensor] = {}     # device index -> the kernels' run counters


def lengths_of(mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32 real lengths of a (B, T) mask of real prefixes, on its
    device (no host readback)."""
    return mask.sum(dim=1, dtype=torch.int32)


def is_prefix(mask: torch.Tensor) -> bool:
    """Whether every row of a (B, T) mask is real on a prefix and pad after
    it: the contract ragged_attention takes (reads the mask on the host)."""
    real = mask > 0
    pos = torch.arange(mask.shape[1], device=mask.device)[None, :]
    return bool(torch.equal(real, pos < lengths_of(mask)[:, None]))


# ---------------------------------------------------------------- plain version


def key_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 1, 1, T) additive mask of the global layers: 0 at real keys,
    finfo(dtype).min at padding (transformers' fill)."""
    keep = (mask > 0)[:, None, None, :]
    return torch.zeros(keep.shape, dtype=dtype, device=mask.device).masked_fill(
        ~keep, torch.finfo(dtype).min)


def band_bias(mask: torch.Tensor, w: int, dtype: torch.dtype) -> torch.Tensor:
    """(B * nblk, 1, w, 3w) additive mask of band_attention: block n holds
    query positions n*w .. n*w + w - 1 and keys n*w - w .. n*w + 2w - 1; a
    pair is kept where |i - j| <= w and the key is a real token of the row
    (inside it, mask > 0)."""
    b, t = mask.shape
    nblk = -(-t // w)
    real = F.pad((mask > 0).to(torch.int8), (w, nblk * w - t + w)).unfold(1, 3 * w, w) > 0
    rows = torch.arange(w, device=mask.device)[:, None]
    keys = torch.arange(3 * w, device=mask.device)[None, :] - w
    keep = real[:, :, None, :] & ((rows - keys).abs() <= w)
    return torch.zeros(keep.shape, dtype=dtype, device=mask.device).masked_fill(
        ~keep, torch.finfo(dtype).min).view(b * nblk, 1, w, 3 * w)


def band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   w: int) -> torch.Tensor:
    """Local attention of (B, T, H, D) q, k, v under band_bias's (B * nblk,
    1, w, 3w) mask: each block of w queries against its 3w keys.  The batch
    is taken as one sequence of B * nblk blocks (rows padded to whole
    blocks), so the blocks' queries are a view of q and the windows'
    keys a view of k, unfolded with one zero block before the first and
    after the last; a window reaching into the next or previous row, or
    past either end, holds keys that band_bias masks.  Work and memory are
    O(T x w)."""
    b, t, h, d = q.shape
    nblk = -(-t // w)
    if nblk * w != t:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, nblk * w - t)) for x in (q, k, v))

    def windows(x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.reshape(b * nblk * w, h, d), (0, 0, 0, 0, w, w))
        return x.unfold(0, 3 * w, w).transpose(2, 3)             # (B * nblk, H, 3w, D)

    qb = q.reshape(b * nblk, w, h, d).transpose(1, 2)
    o = F.scaled_dot_product_attention(qb, windows(k), windows(v), attn_mask=bias)
    return o.transpose(1, 2).reshape(b, nblk * w, h, d)[:, :t]


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Attention of (B, T, H, D) q, k, v over every key under key_bias's
    (B, 1, 1, T) mask."""
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       attn_mask=bias)
    return o.transpose(1, 2)


def ragged_attention_plain(q, k, v, lengths, window: int | None = None) -> torch.Tensor:
    """The plain version, on any device: band_attention (window w) or
    global_attention under the masks of these lengths, the padded query
    rows zeroed."""
    real = torch.arange(q.shape[1], device=q.device)[None, :] < lengths.to(q.device)[:, None]
    if window is None:
        o = global_attention(q, k, v, key_bias(real, q.dtype))
    else:
        o = band_attention(q, k, v, band_bias(real, window, q.dtype), window)
    return o * real[:, :, None, None].to(o.dtype)


def visited_slots(lengths, t: int, window: int | None) -> int:
    """Query x key slots that the forward kernel scores over rows of these
    real lengths padded to t, one head of one layer: for each warpgroup of
    64 query rows with a real row, 64 x 64 slots for each 64-key chunk of
    its block's key range that its rows reach (ragged_fwd_kernel's loop
    bounds; the backward's warps of 16 rows visit a subset of the same
    tiles, and their transposes)."""
    total = 0
    for n in np.clip(np.asarray(lengths, np.int64), 0, t):
        if n == 0:
            continue
        r0 = np.arange(0, n, UNIT_ROWS)                    # warpgroups with a real row
        if window is None:
            chunks = np.full(r0.shape, -(-n // CHUNK))
        else:
            w = window
            i0 = r0 // TILE * TILE
            lo = np.maximum(i0 - w, 0) // CHUNK * CHUNK
            hi = np.minimum(np.minimum(i0 + TILE, n) + w, n)
            # chunks lo + CHUNK m below hi that reach [r0 - w, r0 + 63 + w]
            first = -(-(np.maximum(r0 - w - (CHUNK - 1), lo) - lo) // CHUNK)
            last = (np.minimum(hi - 1, r0 + UNIT_ROWS - 1 + w) - lo) // CHUNK
            chunks = np.maximum(last - first + 1, 0)
        total += int(chunks.sum()) * UNIT_ROWS * CHUNK
    return total


# ---------------------------------------------------------------- CUDA


def prepare() -> None:
    """Start building the kernels' library in the background where a card
    is present, so that the build overlaps the caller's set-up; the first
    launch waits for it."""
    if torch.cuda.is_available():
        _build.prebuild(LIBRARY)


def _device_index(device: torch.device) -> int:
    """The kernels' device state, made once a device, outside any capture
    (the first call of a shape is eager): each kernel's shared-memory limit
    and the run counters."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _lock:
        if idx not in _runs:
            init = _build.function(LIBRARY, "tr_ragged_init", [])
            with torch.cuda.device(idx):
                _build.check(init(), "tr_ragged_init", LIBRARY)
            _runs[idx] = torch.zeros(3, dtype=torch.int64, device=torch.device("cuda", idx))
    return idx


def device_runs(device: torch.device | str = "cuda") -> dict[str, int]:
    """The kernels' runs on the device as they count them there (a replayed
    CUDA graph's too): forward, backward (each dQ + dK/dV pair) and banded
    (forward runs with a window).  Synchronises."""
    device = torch.device(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    runs = _runs.get(idx)
    vals = runs.tolist() if runs is not None else [0, 0, 0]
    return dict(zip(("forward", "backward", "banded"), vals))


def _check(q, k, v, lengths) -> None:
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype != torch.bfloat16 or d != HEAD_DIM:
        raise ValueError(f"ragged_attention's kernels take bf16 at head dim {HEAD_DIM}; "
                         f"got {q.dtype}, D={d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("ragged_attention needs contiguous (B, T, H, D) q/k/v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("ragged_attention needs 16-byte aligned q/k/v (16-byte async copies)")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 or lengths.device != q.device:
        raise ValueError(f"lengths must be ({b},) int32 on {q.device}")


def _forward_cuda(q, k, v, lengths, w: int):
    """One launch of ragged_fwd_kernel: (o, lse), lse (B, H, T) f32."""
    _check(q, k, v, lengths)
    idx = _device_index(q.device)
    b, t, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function(LIBRARY, "tr_ragged_fwd", [_build.P] * 6 + [_build.I] * 4
                         + [_build.P] * 2)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, t, h, w, _runs[idx].data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tr_ragged_fwd", LIBRARY)
    _forward_cuda.launches += 1
    _forward_cuda.banded_launches += w >= 0
    return o, lse


def _backward_cuda(q, k, v, o, do, lse, lengths, w: int):
    """ragged_dq_kernel then ragged_dkv_kernel: (dq, dk, dv)."""
    idx = _device_index(q.device)
    b, t, h, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    fn = _build.function(LIBRARY, "tr_ragged_bwd", [_build.P] * 11 + [_build.I] * 4
                         + [_build.P] * 2)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), b, t, h, w, _runs[idx].data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tr_ragged_bwd", LIBRARY)
    _backward_cuda.launches += 1
    return dq, dk, dv


_forward_cuda.launches = 0          # forward launches
_forward_cuda.banded_launches = 0   # those with a window
_backward_cuda.launches = 0         # backward calls (a dQ and a dK/dV launch each)


class _RaggedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, w):
        o, lse = _forward_cuda(q, k, v, lengths, w)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.w = w
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        if not do.is_contiguous() or do.data_ptr() % 16:
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _backward_cuda(q, k, v, o, do, lse, lengths, ctx.w)
        return dq, dk, dv, None, None


def ragged_attention(q, k, v, lengths, window: int | None = None) -> torch.Tensor:
    """Attention of (B, T, H, D) q, k, v over each row's first lengths[b]
    keys, within `window` of the query (None: every key); lengths (B,)
    int32 on q's device (lengths_of).  Pad query rows come out as zeros."""
    if window is not None and window < 0:
        raise ValueError(f"window {window}: None for every key, else >= 0")
    if q.device.type == "cuda":
        w = -1 if window is None else int(window)
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return _RaggedAttention.apply(q, k, v, lengths, w)
        return _forward_cuda(q, k, v, lengths, w)[0]
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return ragged_attention_plain(q, k, v, lengths, window)
