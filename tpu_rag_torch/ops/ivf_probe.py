"""IVF probes (port of tpu_rag/ops/ivf_probe.py).

Two entry points with the JAX functions' signatures and return contracts:

- `ivf_probe_pallas`, the per-list probe: each query takes its nprobe
  nearest centroids (f32 matmul, ties to the lowest centroid), and kernel #6
  (csrc/ivf_probe.cu) selects the exact top k_eff = min(k, cap) slots of
  each probed list, ties to the lowest slot.  The merge over the nprobe *
  k_eff candidates is torch, as the JAX package merges outside Pallas: a
  stable sort over candidates laid out probe-major, rank-minor, which equals
  the reference's lax.top_k over the flat scores.  Returns (Q, min(k,
  nprobe * k_eff)) scores and rows.
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

import ctypes
import math
from typing import NamedTuple

import torch

from tpu_rag_torch import _build
from tpu_rag_torch.ops.quant import quantize_int8_rows
from tpu_rag_torch.ops.topk import (_DTYPE_CODE, _ELT, _SMEM_MAX, BUCKET, PAD_TAG,
                                    _f32_smem, _round_up, _sm_count, _tag_mask,
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

_LIST_ARGS = [_build.P] * 6 + [_build.I] * 8 + [_build.P] * 3
_BATCHED_ARGS = [_build.P] * 7 + [_build.I] * 12 + [_build.P] * 3
_BUCKET_WARPS = 8
_BUCKET_STAGES_MAX = 8
_BUCKET_M_MAX = 4
_BUCKET_QREG_BYTES = 384  # int8 query rows up to this many bytes stay in registers


def _smem_bytes(kind: int, code: int, d: int, qc: int, k: int, stages: int = 0) -> int:
    """csrc/ivf_probe.cu's tr_probe_smem_bytes: a block's shared memory."""
    fn = _build.load("ivf_probe").tr_probe_smem_bytes
    fn.argtypes = [_build.I] * 6
    fn.restype = ctypes.c_size_t
    return int(fn(kind, code, d, qc, k, stages))


class BucketPlan(NamedTuple):
    """Launch geometry of kernel #7.  bf16/int8 (pipe_bucket_kernel): `qc`
    queries a block, a ring of `stages` stages of `rows` rows (128, one
    bucket, or 64), `blocks` blocks a query chunk, each walking a contiguous
    range of the live (union slot, bucket) items (_bucket_ranges) of at most
    `items` items (at n_uniq = u_max).  f32 (batched_bucket_kernel): each
    list's buckets split over `blocks` blocks of `items` buckets, rows 128,
    stages 0.  `smem`: bytes of shared memory a block."""
    qc: int
    rows: int
    stages: int
    blocks: int
    items: int
    smem: int


def _bucket_tiles(qc: int, rows: int) -> tuple[int, int, int, int]:
    """pipe_bucket_kernel's warp tiling of a stage (bucket_mtw, bucket_wr):
    (m16 row tiles a warp, row tiles of warps, query groups of warps, n8
    query tiles a warp).  At 64 queries and 128 rows a warp multiplies 32
    rows x 32 queries: ~197 KB of ldmatrix a bucket, where 16 x 64 reads
    ~246 KB (every query fragment again every 16 rows), and a thread selects
    for 8 query columns, not 16."""
    nt = qc // 8
    mtw = (2 if nt >= 2 else 1) if rows == 128 else (2 if nt >= 4 else 1)
    wr = rows // (16 * mtw)
    wq = min(_BUCKET_WARPS // wr, nt)
    return mtw, wr, wq, nt // wq


def _bucket_smem(elt: int, d: int, qc: int, stages: int, rows: int) -> int:
    """Shared-memory bytes of pipe_bucket_kernel (bucket_smem): 1024 bytes of
    slack to align the base to the swizzle unit, the queries (rows padded to
    an odd number of 16-byte units), `stages` stages of `rows` rows stored as
    128-byte column blocks (the tensor map's boxes) with their ns, canon and
    scale, each rounded up to 1024 bytes, two tables of the warps' winners
    (row tiles x queries x 4, score and slot) and one mbarrier per possible
    stage.  int8 query rows of at most 384 bytes live in registers, and are
    staged in the last ring stage rather than beside the ring."""
    kbytes = _round_up(d * elt, 32)
    qreg = elt == 1 and kbytes <= _BUCKET_QREG_BYTES
    wr = _bucket_tiles(qc, rows)[1]
    stage = _round_up(-(-d * elt // 128) * rows * 128 + 3 * rows * 4, 1024)
    queries = 0 if qreg else _round_up(qc * (kbytes + 16), 1024)
    return (1024 + queries + stages * stage + 2 * wr * qc * _BUCKET_M_MAX * 8
            + _BUCKET_STAGES_MAX * 8)


def _bucket_rows(elt: int, d: int, qc: int) -> int:
    """Rows of a ring stage (bucket_rows): 128, one bucket, where three such
    stages fit; else 64, a bucket in two stages."""
    fixed = _bucket_smem(elt, d, qc, 0, 128)
    stage = _bucket_smem(elt, d, qc, 1, 128) - fixed
    return 128 if fixed < _SMEM_MAX and (_SMEM_MAX - fixed) // stage >= 3 else 64


def _bucket_ranges(n_items: int, blocks: int) -> list[tuple[int, int]]:
    """The item range [begin, end) of each block of a query chunk, as
    pipe_bucket_kernel computes it on the device from the live union:
    n_items * b // blocks to n_items * (b + 1) // blocks."""
    return [(n_items * b // blocks, n_items * (b + 1) // blocks) for b in range(blocks)]


def _bucket_plan(u_max: int, nb: int, nq: int, d: int, dtype: torch.dtype,
                 sms: int) -> BucketPlan:
    """Launch geometry of kernel #7, a pure function of the shapes.

    bf16/int8: the query chunk is the power of two 8..64 that covers nq,
    halved while fewer than two ring stages fit; the ring takes as many
    stages (at most 8) of _bucket_rows rows as the rest of the 232,448 bytes
    hold; one block per SM and query chunk.  f32: chunks of 16..64 queries
    and each list's buckets split until ~2 blocks per SM exist."""
    chunks = lambda qc: -(-nq // qc)  # noqa: E731
    if dtype == torch.float32:
        qc = min(64, _round_up(nq, 16))
        while qc > 16 and _f32_smem(d, qc, 0, "bucketed") > _SMEM_MAX:
            qc -= 16
        smem = _f32_smem(d, qc, 0, "bucketed")
        if smem > _SMEM_MAX:
            raise ValueError(f"batched probe does not fit shared memory at d={d}")
        nsplit = min(nb, max(1, -(-2 * sms // (u_max * chunks(qc)))))
        items = -(-nb // nsplit)
        return BucketPlan(qc, BUCKET, 0, -(-nb // items), items, smem)
    elt = _ELT[dtype]
    qc = 8
    while qc < min(nq, 64):
        qc *= 2
    while True:
        rows = _bucket_rows(elt, d, qc)
        fixed = _bucket_smem(elt, d, qc, 0, rows)
        stage = _bucket_smem(elt, d, qc, 1, rows) - fixed
        stages = min(_BUCKET_STAGES_MAX, max(0, _SMEM_MAX - fixed) // stage)
        if stages >= 2:
            break
        if qc == 8:
            raise ValueError(f"batched probe does not fit shared memory at d={d}")
        qc //= 2
    blocks = max(1, sms // chunks(qc))
    return BucketPlan(qc, rows, stages, blocks, -(-u_max * nb // blocks),
                      fixed + stages * stage)


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
    """Launch kernel #6: one block per (query, probe)."""
    code = _check_lists(q_in, vec_lists, scale_lists, ns_lists, canon_lists)
    nlist, cap, d = vec_lists.shape
    nq, nprobe = lists.shape
    if not 0 < k_eff <= min(K_EFF_MAX, cap):
        raise ValueError(f"the per-list probe selects 1 <= k <= min({K_EFF_MAX}, cap), "
                         f"got {k_eff}")
    if _smem_bytes(0, code, d, 16, k_eff) > _SMEM_MAX:
        raise ValueError(f"per-list probe does not fit shared memory at d={d}")
    lists32 = lists.to(device=vec_lists.device, dtype=torch.int32).contiguous()
    out_sc = torch.empty((nq * nprobe, k_eff), dtype=torch.float32, device=vec_lists.device)
    out_id = torch.empty((nq * nprobe, k_eff), dtype=torch.int32, device=vec_lists.device)
    fn = _build.function("ivf_probe", "tr_probe_list", _LIST_ARGS)
    with torch.cuda.device(vec_lists.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_in.data_ptr(), lists32.data_ptr(), vec_lists.data_ptr(),
                 scale_lists.data_ptr(), ns_lists.data_ptr(), canon_lists.data_ptr(),
                 nq, nprobe, cap, d, int(want_ns), int(want_canon), k_eff, code,
                 out_sc.data_ptr(), out_id.data_ptr(), stream)
    _build.check(err, "tr_probe_list", "ivf_probe")
    _probe_list_cuda.launches += 1
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
    if vec_lists.dtype != torch.float32:
        bulk = [("queries", q_in), ("vec_lists", vec_lists), ("ns_lists", ns_lists),
                ("canon_lists", canon_lists)]
        if vec_lists.dtype == torch.int8:
            bulk.append(("scale_lists", scale_lists))
        for name, t in bulk:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16/int8 batched probe copies by TMA "
                                 f"and needs 16-byte aligned tensors")
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
    return out_sc, out_id


_probe_list_cuda.launches = 0
_probe_batched_cuda.launches = 0


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
