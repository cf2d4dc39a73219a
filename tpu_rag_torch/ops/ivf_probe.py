"""IVF probes (port of tpu_rag/ops/ivf_probe.py).

Two entry points with the JAX functions' signatures and return contracts:

- `ivf_probe_pallas`, the per-list probe: each query takes its nprobe
  nearest centroids (f32 matmul, ties to the lowest centroid), and kernel #6
  (csrc/ivf_probe.cu) selects the exact top k_eff = min(k, cap) slots of
  each probed list, ties to the lowest slot.  Each list is split over a
  cluster of blocks as _list_plan lays it out; the blocks' sorted partial
  lists merge exactly in distributed shared memory.  The
  merge over the nprobe * k_eff candidates is torch, as the JAX package
  merges outside Pallas: a stable sort over candidates laid out
  probe-major, rank-minor, which equals the reference's lax.top_k over the
  flat scores.  Returns (Q, min(k, nprobe * k_eff)) scores and rows.
- `ivf_probe_batched`, the batch-shared probe: the lists the whole batch
  probes are deduplicated, and kernel #7 scores each list of that union once
  against every query, keeping each query's top m (`bucket_m`) slots of
  every 128-slot bucket.  Each query then merges only the candidates of its
  own nprobe lists (through the inverse map of the dedup).  Approximate by
  design; needs cap % 128 == 0.  Returns (Q, k), padded with -inf/-1.

Rows come from `row_lists[list * cap + slot]`; -inf scores get row -1.  With
int8 lists the queries are quantized too (int8 x int8 with the row scale in
the kernel) and the per-query scale is applied after the merge.

On a CUDA tensor the kernels run (or raise); on a CPU tensor their plain
versions below, which repeat the kernels' arithmetic.  Differences from the
JAX module:
- bf16 lists: both probes cast the queries to bf16 and accumulate in f32.
  The JAX per-list probe does the same; the JAX batched probe keeps f32
  queries against bf16 lists (tpu_rag/ops/ivf_probe.py:356-358, ADVICE r5),
  so on queries that are not bf16 numbers the port's batched probe scores
  bf16 products where the reference scores f32 x bf16 ones
  (tests/test_torch_ivf.py pins the bf16 batched probe).
- The dedup keeps the union's size on the device (sort + first-of-run
  flags, as the JAX function does) rather than torch.unique, which waits
  for the size on the host; kernel #7 reads it from device memory.
- Dropped as TPU-only: the `interpret` flag, the (1, 1, cap) reshapes, the
  query padding to 8 rows, and _K_EFF_MAX as a compile-size guard (the
  routing rule in index/ivf.py keeps K_EFF_MAX).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tpu_rag_torch import _build
from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops.quant import quantize_int8_rows
from tpu_rag_torch.ops.topk import (_DTYPE_CODE, BUCKET, PAD_TAG, _sm_count, _tag_mask,
                                    _want_pair, select_topk)

# Largest per-list k the per-list probe selects; above it the IVF index
# routes to its plain reference probe (index/ivf.py).
K_EFF_MAX = 128
_PLAIN_LIST_CHUNK = 64     # lists per step of the batched plain version


def _top_lists(q: torch.Tensor, centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(Q, nprobe) int64 nearest centroids by inner product, ties to the
    lowest centroid (lax.top_k's order; torch.topk documents none)."""
    sims = q.to(torch.float32) @ centroids.to(torch.float32).T
    return torch.sort(sims, dim=1, descending=True, stable=True).indices[:, :nprobe]


def _prep_queries(q: torch.Tensor, vec_lists: torch.Tensor):
    """Queries in the lists' dtype: (int8 values, per-query scales) for int8
    lists, bf16 for bf16 lists, f32 for f32 lists."""
    if vec_lists.dtype == torch.int8:
        q8, qscale = quantize_int8_rows(q.to(torch.float32))
        return q8.contiguous(), qscale
    return q.to(vec_lists.dtype).contiguous(), None


# ------------------------------------------------------------ plain versions


def _probe_list_plain(q_in, lists, vec_lists, scale_lists, ns_lists, canon_lists,
                      want_ns: int, want_canon: int, k_eff: int):
    """Plain version of kernel #6: (Q, nprobe, k_eff) scores and local slots
    of each probed list's top k_eff, sorted (score desc, slot asc), slot -1
    for -inf.  bf16/f32 products summed in f32; int8 sums are exact integers
    in f32 (|sum| < 2^24 for d <= 1024), times the row scale."""
    x = vec_lists[lists]                                     # (Q, nprobe, cap, d)
    s = torch.einsum("qd,qpcd->qpc", q_in.to(torch.float32), x.to(torch.float32))
    if vec_lists.dtype == torch.int8:
        s = s * scale_lists[lists]
    ok = _tag_mask(ns_lists[lists], canon_lists[lists], want_ns, want_canon)
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    order = torch.sort(s, dim=2, descending=True, stable=True).indices[..., :k_eff]
    sc = s.gather(2, order)
    return sc, torch.where(torch.isneginf(sc), -1, order).to(torch.int32)


def _probe_batched_plain(q_in, uniq, n_uniq, vec_lists, scale_lists, ns_lists,
                         canon_lists, want_ns: int, want_canon: int, m: int):
    """Plain version of kernel #7: (U, Q, m * nb) top-m scores and local
    slots of each 128-slot bucket of the union's lists, pass-major then
    bucket; first slot on ties; union slots past n_uniq and -inf winners
    give -inf/-1.  Walks the union in chunks to bound memory."""
    nq = q_in.shape[0]
    u_max = uniq.shape[0]
    cap = vec_lists.shape[1]
    nb = cap // BUCKET
    dev = vec_lists.device
    out_sc = torch.empty((u_max, nq, m * nb), dtype=torch.float32, device=dev)
    out_id = torch.empty((u_max, nq, m * nb), dtype=torch.int32, device=dev)
    lane = torch.arange(BUCKET, device=dev)
    base = torch.arange(nb, device=dev) * BUCKET
    qf = q_in.to(torch.float32)
    for u0 in range(0, u_max, _PLAIN_LIST_CHUNK):
        lst = uniq[u0:u0 + _PLAIN_LIST_CHUNK].long()
        c = lst.shape[0]
        s = torch.einsum("qd,ucd->uqc", qf, vec_lists[lst].to(torch.float32))
        if vec_lists.dtype == torch.int8:
            s = s * scale_lists[lst][:, None, :]
        ok = _tag_mask(ns_lists[lst], canon_lists[lst], want_ns, want_canon)[:, None, :]
        live = (torch.arange(u0, u0 + c, device=dev) < n_uniq)[:, None, None]
        s = torch.where(ok & live, s, torch.full_like(s, -math.inf))
        s3 = s.view(c, nq, nb, BUCKET)
        for p in range(m):
            bmax = s3.amax(dim=3)
            barg = torch.where(s3 == bmax[..., None], lane, BUCKET).amin(dim=3)
            out_sc[u0:u0 + c, :, p * nb:(p + 1) * nb] = bmax
            out_id[u0:u0 + c, :, p * nb:(p + 1) * nb] = torch.where(
                torch.isneginf(bmax), -1, base + barg).to(torch.int32)
            if p + 1 < m:
                s3 = torch.where(lane == barg[..., None], -math.inf, s3)
    return out_sc, out_id


# ------------------------------------------------------------ CUDA kernels

_LIST_ARGS = [_build.P] * 6 + [_build.I] * 12 + [_build.P] * 3
_BATCHED_ARGS = [_build.P] * 7 + [_build.I] * 12 + [_build.P] * 3
_BUCKET_M_MAX = 4          # bucket winners a query keeps


class BucketPlan(NamedTuple):
    """Launch geometry of kernel #7.  bf16/int8 (pipe_bucket_kernel): `qc`
    queries a block, a ring of `stages` stages of `rows` rows (128, one
    bucket, or 64), `blocks` blocks a query chunk, each walking a contiguous
    range of the live (union slot, bucket) items (_bucket_ranges) of at most
    `items` items (at n_uniq = u_max).  f32 (batched_bucket_kernel): `qc`
    queries a block, a ring of `stages` one-box stages (128 rows x 32
    floats), `blocks` blocks a query chunk walking the same ranges; rows
    128.  `smem`: bytes of shared memory a block."""
    qc: int
    rows: int
    stages: int
    blocks: int
    items: int
    smem: int


def _bucket_ranges(n_items: int, blocks: int) -> list[tuple[int, int]]:
    """The item range [begin, end) of each block of a query chunk, as
    pipe_bucket_kernel computes it on the device from the live union:
    n_items * b // blocks to n_items * (b + 1) // blocks."""
    return [(n_items * b // blocks, n_items * (b + 1) // blocks) for b in range(blocks)]


def _bucket_plan(u_max: int, nb: int, nq: int, d: int, dtype: torch.dtype,
                 sms: int) -> BucketPlan:
    """Launch geometry of kernel #7, a pure function of the shapes.

    The query chunk is the power of two 8..64 (f32: 16..64) that covers
    nq, halved while fewer than two ring stages fit; the ring takes as many
    stages (at most 8) as the rest of a block's shared memory holds.  A
    stage's rows and a block's bytes are csrc/layout.h's (bucket_rows,
    bucket_smem, f32_bucket_smem), read through native/layout.cc.
    bf16/int8: one block per SM and query chunk.  f32: one block per SM for
    each query chunk (the FMA pipes bound a chunk: the chunks run one wave
    after another)."""
    code, f32 = _DTYPE_CODE[dtype], dtype == torch.float32
    lay = layout()
    qc = 16 if f32 else 8
    while qc < min(nq, 64):
        qc *= 2
    while (stages := lay.tr_bucket_fit(code, d, qc)) < 2:
        if qc == (16 if f32 else 8):
            raise ValueError(f"batched probe does not fit shared memory at d={d}")
        qc //= 2
    blocks = sms if f32 else max(1, sms // -(-nq // qc))
    return BucketPlan(qc, lay.tr_bucket_rows(code, d, qc), stages, blocks,
                      -(-u_max * nb // blocks), lay.tr_bucket_smem(code, d, qc, stages))


# ---- kernel #6's launch plan (probe_split_kernel on bf16/int8 lists,
# probe_f32_kernel on f32 lists)

_LIST_SPLIT_MAX = 8        # blocks of one list: a thread-block cluster
_LIST_PER_SM_MAX = 7       # blocks an SM holds: 2,048 threads over 288 (8 consumer warps + 1)


class ListPlan(NamedTuple):
    """Launch geometry of kernel #6: each (query, probe) list split over
    `split` blocks (one cluster) walking _list_ranges, a ring of `stages`
    stages of `rows` rows (bf16/int8: 128 or 64; f32: 128 rows of one
    32-float box), `blocks` blocks in all, `per_sm` of them resident on an
    SM at once, `smem` bytes of shared memory a block."""
    split: int
    rows: int
    stages: int
    blocks: int
    per_sm: int
    smem: int


def _list_ranges(cap: int, split: int) -> list[tuple[int, int]]:
    """The slot range [begin, end) of each block of a list, as
    probe_split_kernel computes it: whole 128-slot buckets, nb * r // split
    of nb = ceil(cap / 128), the last range ending at cap."""
    nb = -(-cap // BUCKET)
    return [(min(cap, BUCKET * (nb * r // split)), min(cap, BUCKET * (nb * (r + 1) // split)))
            for r in range(split)]


@functools.lru_cache(maxsize=256)
def _list_plan(nq: int, nprobe: int, cap: int, d: int, dtype: torch.dtype, k: int,
               sms: int) -> ListPlan:
    """Launch geometry of kernel #6, a pure function of the shapes.

    The split (1-8 blocks a list, at most one a bucket) minimises the
    buckets the busiest SM walks, ceil(lists * split / sms) blocks of
    ceil(nb / split) buckets each, ties to the smaller split: at one query
    and nprobe 64 that is 2 (128 blocks on 132 SMs, where 64 would leave
    half the card idle), at three queries 2 (384 blocks, 94% of the even
    share).  Then as many of the SM's blocks as fit with two stages stay
    resident at once (at most 7), and each takes as many stages of
    128 rows as its share of the SM's shared memory holds where two fit,
    else of 64 rows: a stage costs the consumer warps a wait, a product
    and a merge, so fewer, larger stages win (bf16 at one query: two
    128-row stages 0.077 ms, four 64-row 0.083 ms of device time, NVIDIA
    H100 80GB HBM3 at 700 W, probe_sweep.py --list).

    f32 lists (one-box stages of 128 rows): a block's fixed cost (its
    start, the two merges) weighs more beside its few tiles, so the split
    is the largest that keeps every block in one wave of one an SM, and
    the ring takes the stages of a block's share at two or more resident
    blocks (six at d 384): at cap 1024, nprobe 16, d 384 one query (split
    8) 0.0223 ms where eight stages took 0.0362, three queries (split 2)
    0.0379 ms where the rule above (split 8, three an SM) took 0.0563
    (device time, NVIDIA H100 80GB HBM3 at 700 W, probe_sweep.py --list
    --f32)."""
    code, f32 = _DTYPE_CODE[dtype], dtype == torch.float32
    lay = layout()
    nb = -(-cap // BUCKET)
    n_lists = nq * nprobe

    def busiest(split):
        return -(-n_lists * split // sms) * -(-nb // split)

    if f32:
        split = max(1, min(_LIST_SPLIT_MAX, nb, sms // n_lists))
    else:
        split = min(range(1, min(_LIST_SPLIT_MAX, nb) + 1), key=lambda s_: (busiest(s_), s_))
    blocks = n_lists * split
    most = min(-(-blocks // sms), _LIST_PER_SM_MAX)
    for per_sm in range(max(2, most) if f32 else most, 0, -1):
        rows = lay.tr_list_rows(code, d, k, per_sm)
        stages = lay.tr_list_fit(code, d, k, rows, per_sm)
        if stages >= 2:
            return ListPlan(split, rows, stages, blocks, per_sm,
                            lay.tr_list_smem(code, d, k, stages, rows))
    raise ValueError(f"per-list probe does not fit shared memory at d={d}, k={k}")


def _check_lists(q_in, vec_lists, scale_lists, ns_lists, canon_lists) -> int:
    """Validate the common inputs of both kernels; returns the dtype code."""
    nlist, cap, d = vec_lists.shape
    dev = vec_lists.device
    for name, t, dt, shape in (
            ("queries", q_in, vec_lists.dtype, (q_in.shape[0], d)),
            ("vec_lists", vec_lists, vec_lists.dtype, (nlist, cap, d)),
            ("ns_lists", ns_lists, torch.int32, (nlist, cap)),
            ("canon_lists", canon_lists, torch.int32, (nlist, cap)),
            ("scale_lists", scale_lists, torch.float32, (nlist, cap))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dt} tensor of shape "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if vec_lists.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported list dtype {vec_lists.dtype}")
    if d % 16 != 0:
        raise ValueError(f"the CUDA probes need d % 16 == 0, got d={d}")
    return _DTYPE_CODE[vec_lists.dtype]


def _probe_list_cuda(q_in, lists, vec_lists, scale_lists, ns_lists, canon_lists,
                     want_ns: int, want_canon: int, k_eff: int):
    """Launch kernel #6 as _list_plan lays it out."""
    code = _check_lists(q_in, vec_lists, scale_lists, ns_lists, canon_lists)
    nlist, cap, d = vec_lists.shape
    nq, nprobe = lists.shape
    if not 0 < k_eff <= min(K_EFF_MAX, cap):
        raise ValueError(f"the per-list probe selects 1 <= k <= min({K_EFF_MAX}, cap), "
                         f"got {k_eff}")
    if cap % 4:
        raise ValueError(f"the per-list probe needs cap % 4 == 0 (bf16/int8 lists copy "
                         f"their tags in 16-byte units), got cap={cap}")
    bulk = [("queries", q_in), ("vec_lists", vec_lists)]
    if vec_lists.dtype != torch.float32:
        bulk += [("ns_lists", ns_lists), ("canon_lists", canon_lists)]
    if vec_lists.dtype == torch.int8:
        bulk.append(("scale_lists", scale_lists))
    for name, t in bulk:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the per-list probe copies by TMA and needs "
                             f"16-byte aligned tensors")
    plan = _list_plan(nq, nprobe, cap, d, vec_lists.dtype, k_eff, _sm_count(vec_lists.device))
    lists32 = lists.to(device=vec_lists.device, dtype=torch.int32).contiguous()
    out_sc = torch.empty((nq * nprobe, k_eff), dtype=torch.float32, device=vec_lists.device)
    out_id = torch.empty((nq * nprobe, k_eff), dtype=torch.int32, device=vec_lists.device)
    fn = _build.function("ivf_probe", "tr_probe_list", _LIST_ARGS)
    with torch.cuda.device(vec_lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_in.data_ptr(), lists32.data_ptr(), vec_lists.data_ptr(),
                 scale_lists.data_ptr(), ns_lists.data_ptr(), canon_lists.data_ptr(),
                 nlist, nq, nprobe, cap, d, int(want_ns), int(want_canon), k_eff, code,
                 plan.split, plan.rows, plan.stages, out_sc.data_ptr(), out_id.data_ptr(),
                 stream)
    _build.check(err, "tr_probe_list", "ivf_probe")
    _probe_list_cuda.launches += 1
    if vec_lists.dtype == torch.float32:
        _probe_list_cuda.f32_launches += 1
    return out_sc.view(nq, nprobe, k_eff), out_id.view(nq, nprobe, k_eff)


def _probe_batched_cuda(q_in, uniq, n_uniq, vec_lists, scale_lists, ns_lists,
                        canon_lists, want_ns: int, want_canon: int, m: int):
    """Launch kernel #7 as _bucket_plan lays it out; union slots past the
    device-resident n_uniq come out -inf/-1."""
    code = _check_lists(q_in, vec_lists, scale_lists, ns_lists, canon_lists)
    nlist, cap, d = vec_lists.shape
    nq, u_max = q_in.shape[0], uniq.shape[0]
    if cap % BUCKET:
        raise ValueError(f"the batched probe needs cap % {BUCKET} == 0, got cap={cap}")
    if not 1 <= m <= _BUCKET_M_MAX:
        raise ValueError(f"the batched probe keeps 1 <= m <= {_BUCKET_M_MAX}, got {m}")
    for name, t in (("uniq", uniq), ("n_uniq", n_uniq)):
        if t.device != vec_lists.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor on {vec_lists.device}")
    bulk = [("queries", q_in), ("vec_lists", vec_lists), ("ns_lists", ns_lists),
            ("canon_lists", canon_lists)]
    if vec_lists.dtype == torch.int8:
        bulk.append(("scale_lists", scale_lists))
    for name, t in bulk:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the batched probe copies by TMA and needs "
                             f"16-byte aligned tensors")
    plan = _bucket_plan(u_max, cap // BUCKET, nq, d, vec_lists.dtype,
                        _sm_count(vec_lists.device))
    out_sc = torch.empty((u_max, nq, m * (cap // BUCKET)), dtype=torch.float32,
                         device=vec_lists.device)
    out_id = torch.empty((u_max, nq, m * (cap // BUCKET)), dtype=torch.int32,
                         device=vec_lists.device)
    fn = _build.function("ivf_probe", "tr_probe_batched", _BATCHED_ARGS)
    with torch.cuda.device(vec_lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_in.data_ptr(), uniq.data_ptr(), n_uniq.data_ptr(), vec_lists.data_ptr(),
                 scale_lists.data_ptr(), ns_lists.data_ptr(), canon_lists.data_ptr(),
                 nlist, nq, u_max, cap, d, int(want_ns), int(want_canon), plan.qc, m, plan.stages,
                 plan.blocks, code, out_sc.data_ptr(), out_id.data_ptr(), stream)
    _build.check(err, "tr_probe_batched", "ivf_probe")
    _probe_batched_cuda.launches += 1
    if vec_lists.dtype == torch.float32:
        _probe_batched_cuda.f32_launches += 1
    return out_sc, out_id


_probe_list_cuda.launches = 0           # every launch of #6
_probe_list_cuda.f32_launches = 0       # those on f32 lists (probe_f32_kernel)
_probe_batched_cuda.launches = 0        # every launch of #7
_probe_batched_cuda.f32_launches = 0    # those on f32 lists (batched_bucket_kernel)


def probe_list_topk(q_in, lists, vec_lists, scale_lists, ns_lists, canon_lists,
                    want_ns: int, want_canon: int, k_eff: int):
    """Kernel #6 on a CUDA tensor, its plain version on a CPU tensor."""
    if vec_lists.device.type == "cuda":
        return _probe_list_cuda(q_in, lists, vec_lists, scale_lists, ns_lists,
                                canon_lists, want_ns, want_canon, k_eff)
    if vec_lists.device.type != "cpu":
        raise ValueError(f"unsupported device {vec_lists.device}")
    return _probe_list_plain(q_in, lists, vec_lists, scale_lists, ns_lists,
                             canon_lists, want_ns, want_canon, k_eff)


def probe_batched_buckets(q_in, uniq, n_uniq, vec_lists, scale_lists, ns_lists,
                          canon_lists, want_ns: int, want_canon: int, m: int):
    """Kernel #7 on a CUDA tensor, its plain version on a CPU tensor."""
    if vec_lists.device.type == "cuda":
        return _probe_batched_cuda(q_in, uniq, n_uniq, vec_lists, scale_lists,
                                   ns_lists, canon_lists, want_ns, want_canon, m)
    if vec_lists.device.type != "cpu":
        raise ValueError(f"unsupported device {vec_lists.device}")
    return _probe_batched_plain(q_in, uniq, n_uniq, vec_lists, scale_lists, ns_lists,
                                canon_lists, want_ns, want_canon, m)


# ------------------------------------------------------------ public API


def _rows_of(lists, local, row_lists, cap: int) -> torch.Tensor:
    """(Q, c) host rows of (Q, nprobe, c/nprobe) local slots of the probed
    lists, -1 where the slot is -1."""
    qn = lists.shape[0]
    gidx = lists[:, :, None] * cap + local.clamp(min=0).long()
    rows = row_lists.reshape(-1)[gidx.reshape(qn, -1)]
    return torch.where(local.reshape(qn, -1) < 0, -1, rows)


def ivf_probe_pallas(q, centroids, vec_lists, scale_lists, ns_lists, canon_lists,
                     row_lists, wants, *, nprobe: int, k: int):
    """Per-list probe: returns (scores (Q, k_out), rows (Q, k_out)),
    k_out = min(k, nprobe * min(k, cap)), the same as the plain probe
    (index/ivf.py _probe_impl) up to the summation order of the scores.

    q: (Q, d) f32; vec_lists: (nlist, cap, d) f32/bf16/int8 with
    scale_lists (nlist, cap) f32; ns/canon/row_lists: (nlist, cap) int32;
    wants: the (want_ns, want_canon) pair, -1 = no filter."""
    want_ns, want_canon = _want_pair(wants, -1, -1)
    qn = q.shape[0]
    cap = vec_lists.shape[1]
    lists = _top_lists(q, centroids, nprobe)
    q_in, qscale = _prep_queries(q, vec_lists)
    k_eff = min(k, cap)
    sc_l, id_l = probe_list_topk(q_in, lists, vec_lists, scale_lists, ns_lists,
                                 canon_lists, want_ns, want_canon, k_eff)
    # candidates probe-major, rank-minor: for equal scores the stable sort
    # keeps the flat (probe, slot) order the plain probe ranks over
    flat_rows = _rows_of(lists, id_l, row_lists, cap)
    top_sc, top_rows = select_topk(sc_l.reshape(qn, -1), flat_rows,
                                   min(k, nprobe * k_eff))
    if qscale is not None:
        # per-query int8 scale: positive, so -inf sentinels survive
        top_sc = top_sc * qscale[:, None]
    return top_sc, top_rows


def _dedup(lists: torch.Tensor, nlist: int):
    """Union of the probed lists without a host sync: (uniq (u_max,) int32,
    n_uniq (1,) int32, qslots (Q, nprobe) int64 — each draw's slot in uniq).
    Slots past n_uniq hold 0 and are never gathered."""
    v = lists.reshape(-1)
    s_flat, perm = torch.sort(v, stable=True)
    first = torch.ones_like(s_flat, dtype=torch.bool)
    first[1:] = s_flat[1:] != s_flat[:-1]
    slot = torch.cumsum(first, 0) - 1
    n_uniq = first.sum(dtype=torch.int32).reshape(1)
    u_max = min(v.numel(), nlist)
    uniq = torch.zeros((u_max,), dtype=torch.int32, device=v.device).scatter_(
        0, slot, s_flat.to(torch.int32))
    qslots = torch.empty_like(slot).scatter_(0, perm, slot).view(lists.shape)
    return uniq, n_uniq, qslots


def ivf_probe_batched(q, centroids, vec_lists, scale_lists, ns_lists, canon_lists,
                      row_lists, wants, *, nprobe: int, k: int, bucket_m: int = 2):
    """Batch-shared probe: same signature and candidate semantics as
    ivf_probe_pallas (each query ranked over its own nprobe nearest lists),
    but each list of the batch's probe union is read once and scored against
    every query.  Selection keeps the top `bucket_m` (1-4) slots of each
    128-slot bucket.  Returns (scores (Q, k), rows (Q, k)); rows -1 where
    fewer than k candidates survive the filters.  Requires cap % 128 == 0."""
    qn = q.shape[0]
    nlist, cap, _ = vec_lists.shape
    if cap % BUCKET:
        raise ValueError(f"ivf_probe_batched: cap={cap} must be a multiple "
                         f"of {BUCKET} (whole buckets)")
    want_ns, want_canon = _want_pair(wants, -1, -1)
    m = max(1, min(int(bucket_m), 4))
    lists = _top_lists(q, centroids, nprobe)
    uniq, n_uniq, qslots = _dedup(lists, nlist)
    q_in, qscale = _prep_queries(q, vec_lists)
    sc_l, id_l = probe_batched_buckets(q_in, uniq, n_uniq, vec_lists, scale_lists,
                                       ns_lists, canon_lists, want_ns, want_canon, m)
    # per-query gather of its own nprobe lists' bucket winners: (Q, nprobe, m*nb)
    gi = qslots[:, :, None].expand(-1, -1, sc_l.shape[2])
    cand_sc = sc_l.transpose(0, 1).gather(1, gi).reshape(qn, -1)
    local = id_l.transpose(0, 1).gather(1, gi)
    top_sc, top_rows = select_topk(cand_sc, _rows_of(lists, local, row_lists, cap), k)
    if qscale is not None:
        top_sc = top_sc * qscale[:, None]
    return top_sc, top_rows
