"""Fused similarity matmul + top-k selection (port of tpu_rag/ops/topk.py).

`fused_matmul_topk` keeps the signature and return contract of the JAX
function: (scores (q, k) f32, ids (q, k) int32), ids of -1 (score -inf) where
fewer than k rows matched, ties to the lowest row.  On a CUDA tensor it
launches the hand-written kernels of csrc/topk.cu (#1 exact, #2 packed, #3
bucketed) or raises; on a CPU tensor it runs their plain PyTorch versions
below, which repeat the kernels' arithmetic.  The global merge of per-tile
candidates is torch, as JAX merges outside Pallas with lax.top_k, and uses a
stable sort so the lowest row wins a tie (torch.topk documents no tie
order).  `dma_floor_scan` is the read-rate probe (#4).

Dropped from the JAX module: QP_MAX query chunking, default_block_n's VMEM
budgets and the compiler params (TPU tiling), and the packed mode's 14-bit
lane field and 16,384-row tile cap (a single max-reduce per pass on the TPU;
the port's sorted lists break ties by row).  The exact and packed scans
select at most K_MAX = 1024 rows, on every device; JAX's kernel has no cap.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tpu_rag_torch import _build
from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops.quant import quantize_int8_rows

# Tag value marking padded (non-existent) DB rows; real tag ids are >= 0 and
# a filter value of -1 means "no filter on this tag".
PAD_TAG = -(2**31)

BUCKET = 128          # bucketed mode: one candidate per 128 consecutive rows
K_MAX = 1024          # largest k the exact and packed scans select
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def select_topk(scores: torch.Tensor, ids: torch.Tensor | None, k: int):
    """Top-k along dim 1 with ties to the lowest position: a stable sort
    keeps equal scores in their order, and callers lay candidates out in
    ascending row order.  Pads to k with -inf/-1; -inf slots get id -1."""
    q, m = scores.shape
    k_eff = min(k, m)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k_eff]
    top_sc = scores.gather(1, order)
    top_id = order if ids is None else ids.gather(1, order)
    top_id = top_id.to(torch.int32)
    if k_eff < k:
        top_sc = torch.cat([top_sc, top_sc.new_full((q, k - k_eff), -math.inf)], 1)
        top_id = torch.cat([top_id, top_id.new_full((q, k - k_eff), -1)], 1)
    top_id = torch.where(torch.isneginf(top_sc), torch.full_like(top_id, -1), top_id)
    return top_sc, top_id


def _tag_mask(ns, canon, want_ns: int, want_canon: int) -> torch.Tensor:
    ok = ns != PAD_TAG
    if want_ns >= 0:
        ok &= ns == want_ns
    if want_canon >= 0:
        ok &= canon == want_canon
    return ok


# ------------------------------------------------------------ plain versions


def _scan_scores_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon,
                       *, apply_qscale: bool) -> torch.Tensor:
    """(nq, n) f32 masked scores, the kernels' arithmetic: bf16/f32 products
    summed in f32; int8 sums are exact integers in f32 (|sum| < 2^24 for
    d <= 1024), then (acc * query scale) * row scale."""
    acc = q.to(torch.float32) @ x.to(torch.float32).T
    if x.dtype == torch.int8:
        if apply_qscale:
            acc = acc * qscale[:, None]
        acc = acc * scale[None, :]
    ok = _tag_mask(ns, canon, want_ns, want_canon)
    return torch.where(ok[None, :], acc, torch.full_like(acc, -math.inf))


def _exact_scan_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Plain version of kernel #1: exact top-k over all rows."""
    s = _scan_scores_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon,
                           apply_qscale=True)
    return select_topk(s, None, k)


def packed_k_scan(k: int, n: int) -> int:
    """Refine oversample for packed selection: rows whose scores round to the
    same 18 bits are ranked by row, not score, so the scan keeps max(4k, 64)
    candidates to cover the ties at rank k, and the caller re-scores them."""
    return min(max(4 * k, 64), max(n, 1))


def round18(s: torch.Tensor) -> torch.Tensor:
    """Kernel #2's score resolution: keep the top 18 bits of each f32 pattern
    (sign, exponent, 9 mantissa bits).  The JAX kernel packs the sortable
    key's top 18 bits beside a 14-bit lane and rebuilds the score with a
    low-bit fill; that round trip gives exactly these values, -inf included,
    and they order as the keys do."""
    return (s.contiguous().view(torch.int32) & -(1 << 14)).view(torch.float32)


def _packed_scan_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Plain version of kernel #2: the top k of the rounded scores, ties to
    the lowest row, returning the rounded scores."""
    s = _scan_scores_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon,
                           apply_qscale=True)
    return select_topk(round18(s), None, k)


def _bucketed_scan_plain(q, x, scale, ns, canon, want_ns, want_canon):
    """Plain version of kernel #3: (nq, ceil(n/128)) bucket maxima and their
    rows (first row among ties), without the int8 query scale."""
    s = _scan_scores_plain(q, x, scale, ns, canon, None, want_ns, want_canon,
                           apply_qscale=False)
    nq, n = s.shape
    nb = -(-n // BUCKET)
    if nb * BUCKET != n:
        s = torch.cat([s, s.new_full((nq, nb * BUCKET - n), -math.inf)], 1)
    bmax, barg = s.view(nq, nb, BUCKET).max(dim=2)
    base = torch.arange(nb, device=s.device, dtype=torch.int64) * BUCKET
    return bmax, (base[None, :] + barg).to(torch.int32)


# ------------------------------------------------------------ CUDA kernels

_SCAN_ARGS = [_build.P] * 6 + [_build.I] * 11 + [_build.P] * 4
_SCAN_MODE = {"bucketed": 0, "exact": 1, "packed": 2}
_SEED_MIN_WORK = 512      # nq * k from which exact/packed scans seed their thresholds
_SEED_ROWS_MIN = 32_768   # rows of the seeding scan (at least 32 k)


class ScanPlan(NamedTuple):
    """Launch geometry of one scan: `qc` queries per block, each block
    scanning `block_rows` consecutive rows (a multiple of BUCKET) through a
    ring of `stages` stages (pipe_scan_kernel: row tiles; box_scan_kernel:
    boxes of 128 rows x 128 bytes), `blocks` blocks per query chunk, `smem`
    bytes of shared memory a block."""
    qc: int
    stages: int
    block_rows: int
    blocks: int
    smem: int


def _scan_plan(n: int, d: int, nq: int, k: int, dtype: torch.dtype, sms: int,
               mode: str = "exact") -> ScanPlan:
    """Launch geometry of the scan kernels, a pure function of the shapes.

    The query chunk is the power of two 8..64 that covers nq (f32: 1 for one
    query), halved while fewer than two ring stages fit beside the lists and
    the queries; the ring takes as many stages (at most 8) as the rest of a
    block's shared memory holds.  The kernel of a dtype, its stages and its
    bytes are csrc/layout.h's (box_route, box_scan_smem, pipe_rows,
    pipe_smem), read through native/layout.cc: box_scan_kernel (f32 and
    bf16) has one-box stages, whatever d, so a 64-query chunk fits at d
    768; pipe_scan_kernel (int8) has stages of full-depth rows.  Each
    block scans one contiguous range of rows: one block per SM for all the
    chunks together, or, for f32, a wave of one block per SM for each chunk
    (the FMA pipes, not the bytes, bound a chunk from ~40 queries)."""
    kk = k if mode != "bucketed" else 0
    code, m = _DTYPE_CODE[dtype], _SCAN_MODE[mode]
    lay = layout()
    qc = 1 if nq == 1 and dtype == torch.float32 else 8
    while 1 < qc < min(nq, 64):
        qc *= 2
    while (stages := lay.tr_scan_fit(code, d, qc, kk, m)) < 2:
        if qc <= 8:
            raise ValueError(f"scan does not fit shared memory at d={d}, k={k}")
        qc //= 2
    per_chunk = sms if dtype == torch.float32 else max(1, sms // -(-nq // qc))
    block_rows = _round_up(-(-n // per_chunk), BUCKET)
    return ScanPlan(qc, stages, block_rows, -(-n // block_rows),
                    lay.tr_scan_smem(code, d, qc, kk, m, stages))


def _seed_rows(n: int, nq: int, k: int) -> int:
    """Rows of the seeding scan of an exact/packed scan, or 0.

    Every block keeps its own sorted list and, on its own, inserts some
    k (1 + ln(rows / k)) rows per query before its list's last entry is
    high; with many queries that insertion costs more than the product.  So
    where nq * k >= 512 and the database is at least 8x the sample, the
    wrapper first scans the first max(32768, 32 k) rows: the k-th best
    score of that sample is a lower bound of each query's k-th best score
    over all rows (the sample is a subset), and the full scan then lets
    only rows scoring at least that bound reach its lists.  Exact: a row
    below the bound cannot be among the top k; rows equal to it still
    compete, ties to the lowest row."""
    rows = _round_up(max(_SEED_ROWS_MIN, 32 * k), BUCKET)
    if nq * k < _SEED_MIN_WORK or n < 8 * rows:
        return 0
    return rows


def _list_scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k, mode):
    """Kernel #1 or #2 of csrc/topk.cu, seeded where _seed_rows says so;
    returns the per-block candidates and the number of launches."""
    rows = _seed_rows(x.shape[0], q.shape[0], k)
    seed = None
    if rows:
        cut = (lambda t: None if t is None else t[:rows])
        sc, _ = _scan_cuda(q, x[:rows], cut(scale), ns[:rows], canon[:rows], qscale,
                           want_ns, want_canon, k, mode)
        seed = torch.topk(sc, k, dim=1).values[:, k - 1].contiguous()
    return _scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k, mode,
                      seed=seed), 2 if rows else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_depth(k: int) -> None:
    if not 0 < k <= K_MAX:
        raise ValueError(f"exact and packed scans select 1 <= k <= {K_MAX}, got {k}")


def _scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k, mode, seed=None):
    """Launch kernel #1 (exact), #2 (packed) or #3 (bucketed) of csrc/topk.cu;
    `seed` (nq,) f32 is a lower bound of each query's k-th score (exact and
    packed)."""
    n, d = x.shape
    nq = q.shape[0]
    for name, t, dt in (("queries", q, x.dtype), ("database", x, x.dtype),
                        ("ns_tags", ns, torch.int32), ("canon_tags", canon, torch.int32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported database dtype {x.dtype}")
    if d % 16 != 0:
        raise ValueError(f"the CUDA scan needs d % 16 == 0, got d={d}")
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("the scan copies by TMA and needs 16-byte aligned queries and database")
    if ns.shape != (n,) or canon.shape != (n,):
        raise ValueError("ns/canon tags must be (n,)")
    exact = mode != "bucketed"       # a sorted list of k per query (#1, #2)
    if exact:
        _check_depth(k)
    is_int8 = x.dtype == torch.int8
    needs = [("db_scales", scale, (n,))] + ([("query scales", qscale, (nq,))]
                                            if exact else [])
    for name, t, shape in needs:
        if is_int8 and (t is None or t.shape != shape or t.dtype != torch.float32
                        or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"int8 scan needs contiguous f32 {name} of shape {shape}")
    kk = k if exact else 0
    plan = _scan_plan(n, d, nq, kk, x.dtype, _sm_count(x.device), mode)
    cols = plan.blocks * k if exact else -(-n // BUCKET)
    out_sc = torch.empty((nq, cols), dtype=torch.float32, device=x.device)
    out_id = torch.empty((nq, cols), dtype=torch.int32, device=x.device)
    fn = _build.function("topk", "tr_scan", _SCAN_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), x.data_ptr(),
                 scale.data_ptr() if is_int8 else None, ns.data_ptr(),
                 canon.data_ptr(), qscale.data_ptr() if is_int8 and exact else None,
                 n, d, nq, int(want_ns), int(want_canon), plan.block_rows, plan.qc, kk,
                 _SCAN_MODE[mode], _DTYPE_CODE[x.dtype], plan.stages,
                 None if seed is None else seed.data_ptr(),
                 out_sc.data_ptr(), out_id.data_ptr(), stream)
    _build.check(err, "tr_scan", "topk")
    return out_sc, out_id


def _exact_scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Kernel #1: per-block exact top-k, merged here (stable, lowest row)."""
    (cand_sc, cand_id), launches = _list_scan_cuda(q, x, scale, ns, canon, qscale,
                                                   want_ns, want_canon, k, "exact")
    _exact_scan_cuda.launches += launches
    if x.dtype == torch.float32:
        _exact_scan_cuda.f32_launches += launches
    return select_topk(cand_sc, cand_id, k)


def _packed_scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Kernel #2: per-block top-k of the rounded scores, merged here (stable,
    lowest row)."""
    (cand_sc, cand_id), launches = _list_scan_cuda(q, x, scale, ns, canon, qscale,
                                                   want_ns, want_canon, k, "packed")
    _packed_scan_cuda.launches += launches
    if x.dtype == torch.float32:
        _packed_scan_cuda.f32_launches += launches
    return select_topk(cand_sc, cand_id, k)


def _bucketed_scan_cuda(q, x, scale, ns, canon, want_ns, want_canon):
    """Kernel #3: (nq, ceil(n/128)) bucket maxima and rows."""
    out = _scan_cuda(q, x, scale, ns, canon, None, want_ns, want_canon, 0,
                     "bucketed")
    _bucketed_scan_cuda.launches += 1
    if x.dtype == torch.float32:
        _bucketed_scan_cuda.f32_launches += 1
    return out


# each wrapper's launches, and those on f32 rows (the f32 kernel)
_exact_scan_cuda.launches = _exact_scan_cuda.f32_launches = 0
_packed_scan_cuda.launches = _packed_scan_cuda.f32_launches = 0
_bucketed_scan_cuda.launches = _bucketed_scan_cuda.f32_launches = 0


def exact_scan(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Kernel #1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _exact_scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    _check_depth(k)
    return _exact_scan_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon, k)


def packed_scan(q, x, scale, ns, canon, qscale, want_ns, want_canon, k):
    """Kernel #2 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _packed_scan_cuda(q, x, scale, ns, canon, qscale, want_ns, want_canon, k)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    _check_depth(k)
    return _packed_scan_plain(q, x, scale, ns, canon, qscale, want_ns, want_canon, k)


def bucketed_scan(q, x, scale, ns, canon, want_ns, want_canon):
    """Kernel #3 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _bucketed_scan_cuda(q, x, scale, ns, canon, want_ns, want_canon)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _bucketed_scan_plain(q, x, scale, ns, canon, want_ns, want_canon)


# ------------------------------------------------------------ read-rate probe


def _read_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel #4: the f32 sum of every element."""
    return x.reshape(-1).to(torch.float32).sum()


def _read_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel #4 of csrc/topk.cu: per-block f32 sums of 16-byte vector
    loads, added here."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the read-rate probe needs a contiguous, 16-byte aligned tensor")
    sms = _sm_count(x.device)
    partial = torch.empty((8 * sms,), dtype=torch.float32, device=x.device)
    fn = _build.function("topk", "tr_read_sum",
                         [_build.P, ctypes.c_longlong, _build.I, _build.I, _build.P, _build.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype], partial.numel(),
                 partial.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tr_read_sum", "topk")
    _read_sum_cuda.launches += 1
    return partial.sum()


_read_sum_cuda.launches = 0


def dma_floor_scan(x: torch.Tensor, *, bn: int = 0) -> torch.Tensor:
    """Read-rate probe (kernel #4): the f32 sum of every element of an
    (n, d) f32, bf16 or int8 matrix, as a 0-d tensor.  Its only work is one
    streaming read, so its time is the floor a scan over the same matrix
    can reach on this card.  `bn` is accepted for the JAX signature (its
    tile height); any n is taken."""
    del bn
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        return _read_sum_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _read_sum_plain(x)


# ------------------------------------------------------------ public API


def _want_pair(wants, want_ns: int, want_canon: int) -> tuple[int, int]:
    if wants is None:
        return int(want_ns), int(want_canon)
    w = torch.as_tensor(wants).reshape(-1).tolist()
    return int(w[0]), int(w[1])


def fused_matmul_topk(
    queries: torch.Tensor,
    database: torch.Tensor,
    k: int,
    *,
    db_scales: torch.Tensor | None = None,
    ns_tags: torch.Tensor | None = None,
    canon_tags: torch.Tensor | None = None,
    want_ns: int = -1,
    want_canon: int = -1,
    block_n: int = 2048,
    assume_padded: bool = False,
    wants=None,
    mode: str = "exact",
):
    """Top-k inner-product search: returns (scores (q,k) f32, ids (q,k) i32).

    mode="exact": exact top-k, ties to the lowest row (kernel #1).
    mode="packed": the top k at 18-bit score resolution (round18), ties to
      the lowest row, returning the rounded scores (kernel #2).  Rows whose
      scores agree to ~2^-9 relative tie, so callers oversample
      (packed_k_scan) and re-score; quasi-exact and opt-in only.
    mode="bucketed": one candidate per 128 consecutive rows (its max), then
      the top k of those — approximate, recall ~>0.99 for k << n/128
      (kernel #3).  The per-query int8 scale is applied after selection.

    queries:  (q, d) float32/bfloat16
    database: (n, d) float32/bfloat16, or int8 with db_scales (n,) float32;
      int8 scans quantize the queries too (int8 x int8, both scales applied).
    ns_tags / canon_tags: optional (n,) int32 tag ids (>= 0, PAD_TAG for
      padding rows); want_ns / want_canon (or `wants`, a (want_ns,
      want_canon) pair) keep rows with that tag, -1 = no filter.  A filter
      on a tag array that is absent is ignored.
    `block_n` and `assume_padded` are accepted for the JAX signature: the
    kernels handle any n, so nothing is padded here.  Exact and packed
    select at most K_MAX = 1024 rows.
    """
    del block_n, assume_padded
    if mode not in ("exact", "packed", "bucketed"):
        raise ValueError(f"unknown scan mode {mode!r}")
    want_ns, want_canon = _want_pair(wants, want_ns, want_canon)
    n, d = database.shape
    dev = database.device
    q = queries.shape[0]
    # a filter on a tag array that does not exist cannot be evaluated:
    # ignore it (topk_reference semantics) — real rows get tag 0 below
    if ns_tags is None:
        want_ns = -1
    if canon_tags is None:
        want_canon = -1
    ns = (torch.zeros((n,), dtype=torch.int32, device=dev) if ns_tags is None
          else ns_tags.to(torch.int32).contiguous())
    canon = (torch.zeros((n,), dtype=torch.int32, device=dev) if canon_tags is None
             else canon_tags.to(torch.int32).contiguous())
    is_int8 = database.dtype == torch.int8
    if is_int8:
        scale = (torch.ones((n,), dtype=torch.float32, device=dev) if db_scales is None
                 else db_scales.to(torch.float32).contiguous())
        q_in, qscale = quantize_int8_rows(queries.to(torch.float32))
        q_in = q_in.contiguous()
    else:
        scale = qscale = None
        q_in = queries.to(database.dtype).contiguous()
    x = database.contiguous()
    if n == 0 or q == 0:
        return (torch.full((q, k), -math.inf, device=dev),
                torch.full((q, k), -1, dtype=torch.int32, device=dev))

    if mode == "exact":
        return exact_scan(q_in, x, scale, ns, canon, qscale, want_ns, want_canon, k)
    if mode == "packed":
        return packed_scan(q_in, x, scale, ns, canon, qscale, want_ns, want_canon, k)
    cand_sc, cand_id = bucketed_scan(q_in, x, scale, ns, canon, want_ns, want_canon)
    top_sc, top_id = select_topk(cand_sc, cand_id, k)
    if is_int8:
        # per-query scale deferred past selection (ranking-invariant; -inf
        # winners stay -inf since scales are > 0)
        top_sc = top_sc * qscale[:, None]
    return top_sc, top_id


def topk_reference(
    queries: torch.Tensor,
    database: torch.Tensor,
    k: int,
    *,
    db_scales: torch.Tensor | None = None,
    ns_tags: torch.Tensor | None = None,
    canon_tags: torch.Tensor | None = None,
    want_ns: int = -1,
    want_canon: int = -1,
):
    """Plain exhaustive search, the counterpart of topk_xla_reference: f32
    queries against the rows (int8 rows through bf16, scores rescaled by the
    row scales); used for the small append block, as the JAX package uses
    XLA there, and as ground truth in tests."""
    x = database
    if x.dtype == torch.int8:
        scores = queries.to(torch.float32) @ x.to(torch.bfloat16).to(torch.float32).T
        if db_scales is None:
            db_scales = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
        scores = scores * db_scales[None, :].to(torch.float32)
    else:
        scores = queries.to(torch.float32) @ x.to(torch.float32).T
    n = x.shape[0]
    ok = torch.ones((n,), dtype=torch.bool, device=x.device)
    if ns_tags is not None:
        ok &= ns_tags != PAD_TAG
        if int(want_ns) >= 0:
            ok &= ns_tags == int(want_ns)
    if canon_tags is not None and int(want_canon) >= 0:
        ok &= canon_tags == int(want_canon)
    scores = torch.where(ok[None, :], scores, torch.full_like(scores, -math.inf))
    return select_topk(scores, None, k)
