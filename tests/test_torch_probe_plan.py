"""Kernel #7's launch geometry (tpu_rag_torch/ops/ivf_probe.py _bucket_plan)
and the semantics its selection must keep, checked on the CPU.

The plan is a pure function of the shapes: every live (union slot, bucket)
item is walked by exactly one block, the ranges are contiguous, and every
plan fits one H100 block's shared memory with at least two ring stages.
The plans' bytes, stage rows and warp tiling are csrc/layout.h's, the code
the kernels size their shared memory with, built for the host by
native/layout.cc; here they are held against the layouts written out.
The plain version of #7 (_probe_batched_plain, the knock-out sequence of
the TPU kernel) is held against a sort by (score desc, slot asc) per
bucket: the order the kernel's shuffle merges and row-tile fold keep."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops import ivf_probe as ip
from tpu_rag_torch.ops.topk import _DTYPE_CODE, BUCKET, PAD_TAG

SMS = 132  # H100 SXM
D_ALL = (64, 384, 768)
STAGES_MAX = 8     # ring stages of a probe block


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("nq", [1, 4, 8, 9, 33, 64, 80, 200])
def test_live_items_covered_once_in_contiguous_ranges(dtype, nq):
    nb = 31                                                   # cap 3968
    for u_max in (1, 7, 466, 2048):
        plan = ip._bucket_plan(u_max, nb, nq, 384, dtype, SMS)
        for n_uniq in sorted({1, u_max // 2 + 1, u_max - 1, u_max} - {0}):
            ranges = ip._bucket_ranges(n_uniq * nb, plan.blocks)
            assert len(ranges) == plan.blocks
            assert ranges[0][0] == 0 and ranges[-1][1] == n_uniq * nb
            for (_, end), (begin, _) in zip(ranges, ranges[1:]):
                assert end == begin                           # contiguous, in block order
            assert all(0 <= e - b <= plan.items for b, e in ranges)
            lens = [e - b for b, e in ranges]
            assert max(lens) - min(lens) <= 1                 # balanced on the device
        chunks = -(-nq // plan.qc)
        if dtype == torch.float32:
            assert plan.blocks == SMS             # a wave for each query chunk
        else:
            assert plan.blocks * chunks <= SMS or plan.blocks == 1


a1024 = lambda x: -(-x // 1024) * 1024  # noqa: E731


def _bucket_layout(elt: int, d: int, qc: int, stages: int, rows: int) -> int:
    """pipe_bucket_kernel's layout written out: slack to align to 1024,
    queries (inside the ring where int8 queries live in registers), stages
    of 128-byte column blocks with three tag arrays, the two winner tables
    (of the kernel's row tiles of warps), the mbarriers."""
    kbytes = -(-d * elt // 32) * 32
    wr = rows // (16 * layout().tr_bucket_mtw(qc // 8, rows))
    queries = 0 if elt == 1 and kbytes <= 384 else a1024(qc * (kbytes + 16))
    stage = a1024(-(-d * elt // 128) * 128 * rows + 12 * rows)
    return 1024 + queries + stages * stage + 2 * wr * qc * 4 * 8 + 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", D_ALL)
def test_every_plan_fits_with_two_stages(dtype, d):
    elt = 1 if dtype == torch.int8 else 2
    rows_of = lambda qc: layout().tr_bucket_rows(_DTYPE_CODE[dtype], d, qc)  # noqa: E731
    for nq in range(1, 129):
        plan = ip._bucket_plan(2048, 31, nq, d, dtype, SMS)
        assert plan.qc in (8, 16, 32, 64)
        assert 2 <= plan.stages <= STAGES_MAX
        assert plan.rows in (64, 128) and plan.rows == rows_of(plan.qc)
        assert plan.smem <= 232_448
        # the same bytes as the layout written out
        assert plan.smem == _bucket_layout(elt, d, plan.qc, plan.stages, plan.rows)
        kbytes = -(-d * elt // 32) * 32
        stage = a1024(-(-d * elt // 128) * 128 * plan.rows + 12 * plan.rows)
        qreg = elt == 1 and kbytes <= 384
        assert not qreg or plan.qc * (kbytes + 16) <= stage     # the queries fit a stage
        # a stage is a whole bucket where three such stages fit
        assert (plan.rows == 128) == (_bucket_layout(elt, d, plan.qc, 3, 128) <= 232_448)
        # the chunk is the smallest power of two >= nq (at most 64) unless
        # two stages did not fit beside it
        want = min(64, max(8, 1 << (nq - 1).bit_length()))
        assert plan.qc == want or (plan.qc < want and _bucket_layout(
            elt, d, 2 * plan.qc, 2, rows_of(2 * plan.qc)) > 232_448)
        # one more stage would not fit (or the ring is at its most)
        assert plan.stages == STAGES_MAX or _bucket_layout(
            elt, d, plan.qc, plan.stages + 1, plan.rows) > 232_448


@pytest.mark.parametrize("qc", [8, 16, 32, 64])
@pytest.mark.parametrize("rows", [64, 128])
def test_warp_tiles_cover_a_stage(qc, rows):
    """pipe_bucket_kernel's warp tiling (csrc/layout.h's bucket_mtw and
    bucket_wr; the kernel's query groups kWQ = min(8 / kWR, nt) and n8
    tiles a warp kNTW = nt / kWQ)."""
    nt = qc // 8
    mtw, wr = layout().tr_bucket_mtw(nt, rows), layout().tr_bucket_wr(nt, rows)
    wq = min(8 // wr, nt)
    ntw = nt // wq
    assert wr * 16 * mtw == rows                              # every row, once
    assert wq * ntw * 8 == qc                                 # every query, once
    assert wr * wq <= 8 and ntw in (1, 2, 4)
    if (qc, rows) == (64, 128):
        assert (16 * mtw, 8 * ntw) == (32, 32)                # the q 64 warp tile


def test_main_path_shapes_keep_whole_buckets_in_flight():
    """ivf-4M (int8, d 384): a stage is one bucket, and the stages being
    filled hold at least 100 KB at 64 queries; bf16 at d 384 takes half
    buckets beside 64 queries."""
    for nq in (4, 8, 64, 80):
        plan = ip._bucket_plan(2048, 31, nq, 384, torch.int8, SMS)
        assert plan.rows == 128
        assert (plan.stages - 1) * 128 * 384 >= 98_304
    assert ip._bucket_plan(2048, 31, 64, 384, torch.bfloat16, SMS).rows == 64
    assert ip._bucket_plan(2048, 31, 80, 384, torch.int8, SMS).blocks == SMS // 2


def test_f32_plans_fit():
    """batched_bucket_kernel's layout written out: slack, queries in rows of
    whole boxes + 4 floats, one-box stages with ns and canon, the winner
    tables (4 row tiles of 32 rows), the mbarriers."""
    for d in D_ALL:
        for nq in (1, 8, 16, 33, 64, 80):
            plan = ip._bucket_plan(2048, 31, nq, d, torch.float32, SMS)
            assert plan.qc in (16, 32, 64) and 2 <= plan.stages <= STAGES_MAX
            want = (1024 + a1024(plan.qc * (-(-d // 32) * 32 + 4) * 4)
                    + plan.stages * a1024(128 * 128 + 2 * 128 * 4) + 2 * 4 * plan.qc * 4 * 8 + 64)
            assert plan.smem == want <= 232_448


def test_plan_rejects_what_cannot_fit():
    with pytest.raises(ValueError):
        ip._bucket_plan(16, 31, 8, 8192, torch.bfloat16, SMS)


# ------------------------------------------------------------ semantics


def _bucket_inputs(seed: int, dtype: torch.dtype, nq: int = 5, nlist: int = 6,
                   cap: int = 384, d: int = 32):
    """Lists with the cases the kernel's merges must get right: ties across
    16-row tiles of one bucket, an all-PAD bucket, a bucket with fewer live
    slots than m, tags for the filters, and dead union slots."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    x[1, 100] = x[1, 20]                      # slots 20 and 100: warps 0 and 3
    x[1, 21] = x[1, 20]                       # and one inside the same tile
    x[2, 300] = x[2, 260]                     # bucket 2 of list 2
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[0] = x[1, 20]
    q[1] = x[2, 260]
    ns = rng.integers(0, 3, (nlist, cap)).astype(np.int32)
    canon = rng.integers(0, 2, (nlist, cap)).astype(np.int32)
    ns[0, 128:256] = PAD_TAG                  # an all-PAD bucket
    ns[3, 256:] = PAD_TAG
    ns[3, 300] = 1                            # one live slot in a bucket
    ns[4, :254] = PAD_TAG                     # two live slots in bucket 1
    ns[1, [20, 21, 100]] = 1
    canon[1, [20, 21, 100]] = 0
    scale = (rng.random((nlist, cap)).astype(np.float32) + 0.5)
    scale[1, [20, 21, 100]] = 1.5            # the self match leads its bucket
    if dtype == torch.int8:
        xt = torch.from_numpy(np.clip(np.round(x * 40), -127, 127).astype(np.int8))
        qt = torch.from_numpy(np.clip(np.round(q * 40), -127, 127).astype(np.int8))
    else:
        xt, qt = torch.from_numpy(x).to(dtype), torch.from_numpy(q).to(dtype)
        scale = np.ones_like(scale)
    uniq = torch.tensor([1, 2, 0, 3, 4, 5, 0, 0], dtype=torch.int32)   # u_max 8
    n_uniq = torch.tensor([6], dtype=torch.int32)                       # 2 dead slots
    return (qt, uniq, n_uniq, xt, torch.from_numpy(scale), torch.from_numpy(ns),
            torch.from_numpy(canon))


def _sorted_top_m(args, want_ns, want_canon, m):
    """Per (slot, query, bucket): sort the 128 slots by (score desc, slot
    asc) and keep the first m; -inf winners and dead slots give -inf/-1."""
    q, uniq, n_uniq, x, scale, ns, canon = args
    nb = x.shape[1] // BUCKET
    out_sc = torch.full((len(uniq), q.shape[0], m * nb), -math.inf)
    out_id = torch.full((len(uniq), q.shape[0], m * nb), -1, dtype=torch.int32)
    for u in range(int(n_uniq[0])):
        lst = int(uniq[u])
        s = q.float() @ x[lst].float().T                       # (Q, cap)
        if x.dtype == torch.int8:
            s = s * scale[lst][None, :]
        ok = ns[lst] != PAD_TAG
        if want_ns >= 0:
            ok &= ns[lst] == want_ns
        if want_canon >= 0:
            ok &= canon[lst] == want_canon
        s = torch.where(ok[None, :], s, torch.full_like(s, -math.inf))
        for qi in range(q.shape[0]):
            for b in range(nb):
                keys = sorted(range(BUCKET), key=lambda r: (-float(s[qi, b * BUCKET + r]), r))
                for p, r in enumerate(keys[:m]):
                    v = float(s[qi, b * BUCKET + r])
                    out_sc[u, qi, p * nb + b] = v
                    out_id[u, qi, p * nb + b] = b * BUCKET + r if v > -math.inf else -1
    return out_sc, out_id


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("wants", [(-1, -1), (1, 0)], ids=["nofilter", "filtered"])
def test_plain_bucket_top_m_is_the_sorted_order(dtype, m, wants):
    args = _bucket_inputs(11, dtype)
    got_sc, got_id = ip._probe_batched_plain(*args, *wants, m)
    want_sc, want_id = _sorted_top_m(args, *wants, m)
    assert torch.equal(got_id, want_id)
    assert torch.equal(torch.isneginf(got_sc), torch.isneginf(want_sc))
    fin = torch.isfinite(want_sc)
    torch.testing.assert_close(got_sc[fin], want_sc[fin], rtol=0, atol=1e-5)
    nb = args[3].shape[1] // BUCKET
    # the tie across warps (slots 20 and 100) and inside a tile (21): query
    # 0 against list 1 (union slot 0), bucket 0
    assert got_id[0, 0, :min(m, 3) * nb:nb].tolist() == [20, 21, 100][:m]
    assert (got_id[6:] == -1).all() and torch.isneginf(got_sc[6:]).all()   # dead slots
    assert (got_id[2, :, [1 + p * nb for p in range(m)]] == -1).all()      # all-PAD bucket


def test_plain_keeps_fewer_live_slots_than_m():
    args = _bucket_inputs(12, torch.int8)
    sc, ids = ip._probe_batched_plain(*args, -1, -1, 4)
    nb = 3
    # list 3 (union slot 3), bucket 2: one live slot; list 4 (slot 4),
    # bucket 1: slots 254 and 255 live
    assert ids[3, :, 2].tolist() == [300] * 5
    assert (ids[3, :, [2 + p * nb for p in (1, 2, 3)]] == -1).all()
    assert sorted(ids[4, 0, [1, 1 + nb]].tolist()) == [254, 255]
    assert (ids[4, :, [1 + 2 * nb, 1 + 3 * nb]] == -1).all()
    assert torch.isneginf(sc[4, :, [1 + 2 * nb, 1 + 3 * nb]]).all()


# ------------------------------------------------------------ kernel #6's plan

LIST_D_ALL = D_ALL
LIST_K_ALL = (1, 40, 128)


@pytest.mark.parametrize("cap", [3968, 1000, 128])
def test_list_ranges_cover_each_list_once_in_slot_order(cap):
    nb = -(-cap // BUCKET)
    for split in range(1, min(8, nb) + 1):
        ranges = ip._list_ranges(cap, split)
        assert len(ranges) == split
        assert ranges[0][0] == 0 and ranges[-1][1] == cap
        for (_, end), (begin, _) in zip(ranges, ranges[1:]):
            assert end == begin                                   # contiguous, in rank order
        assert all(b % BUCKET == 0 and b < e for b, e in ranges)  # 128-aligned, none empty
        lens = [-(-(e - b) // BUCKET) for b, e in ranges]
        assert max(lens) - min(lens) <= 1                         # balanced in buckets
    for nq in (1, 2, 3):
        for nprobe in (1, 16, 64):
            plan = ip._list_plan(nq, nprobe, cap, 384, torch.int8, 40, SMS)
            assert 1 <= plan.split <= min(8, nb)
            assert plan.blocks == nq * nprobe * plan.split


def _list_layout(elt: int, d: int, k: int, stages: int, rows: int) -> int:
    """probe_split_kernel's layout written out (f32: probe_f32_kernel's,
    whose stages are one 128-row box, its tags read from device memory, and
    its query a whole number of boxes): slack, the stages, the query, the
    warps' lists and the block's, the bit maps, the published scores, the
    mbarriers."""
    r128 = lambda x: -(-x // 128) * 128  # noqa: E731
    if elt == 4:
        stage, query = 128 * 128, r128(-(-d // 32) * 128)
    else:
        stage = a1024(-(-d * elt // 128) * rows * 128 + 12 * rows)
        query = r128(-(-d * elt // 32) * 32)
    return 1024 + stages * stage + query + r128(64 * k) + r128(8 * k) + 128 + 64 + 128


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("d", LIST_D_ALL)
def test_every_list_plan_fits(dtype, d):
    elt = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}[dtype]
    f32 = dtype == torch.float32
    for k in LIST_K_ALL:
        for nq in (1, 2, 3):
            for nprobe in (8, 64):
                plan = ip._list_plan(nq, nprobe, 3968, d, dtype, k, SMS)
                assert plan.smem <= 232_448
                assert plan.per_sm * (plan.smem + 1024) <= 233_472    # resident together
                assert plan.per_sm * 288 <= 2048                      # by threads too
                assert plan.rows in (64, 128) and 2 <= plan.stages <= 8
                assert not f32 or plan.rows == 128                    # one-box stages
                # the same bytes as the layout written out
                assert plan.smem == _list_layout(elt, d, k, plan.stages, plan.rows)
                # one more stage would not fit the block's share of the SM
                share = min(232_448, 233_472 // plan.per_sm - 1024)
                assert layout().tr_sm_share(plan.per_sm) == share
                assert plan.stages == 8 or _list_layout(
                    elt, d, k, plan.stages + 1, plan.rows) > share
                # 128-row stages where two of them fit the share
                assert f32 or (plan.rows == 128) == (_list_layout(elt, d, k, 2, 128) <= share)


def test_one_query_fills_the_card():
    """At one query and nprobe 64 one block a list is 64 blocks for 132
    SMs: the plan splits each list, and keeps whole int8 buckets in flight."""
    for dtype in (torch.int8, torch.bfloat16):
        plan = ip._list_plan(1, 64, 3968, 384, dtype, 40, SMS)
        assert plan.split >= 2 and plan.blocks <= SMS and plan.per_sm == 1
        assert plan.rows == 128                   # fewer, larger stages
    plan = ip._list_plan(1, 64, 3968, 384, torch.int8, 40, SMS)
    assert (plan.stages - 1) * 128 * 384 >= 98_304
    assert ip._list_plan(3, 64, 3968, 384, torch.int8, 40, SMS).split == 2


def test_list_plan_rejects_what_cannot_fit():
    with pytest.raises(ValueError):
        ip._list_plan(1, 64, 3968, 8192, torch.bfloat16, 128, SMS)


def _list_inputs(seed: int, cap: int, dtype: torch.dtype, d: int = 32, nlist: int = 6):
    """Lists with an exact tie across the boundary of every split's first
    two ranges (slots 100 and 130: buckets 0 and 1), an all-PAD list, an
    all-PAD bucket and a tail past the fill, and tags for the filters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    x[1, 130] = x[1, 100]
    q = rng.standard_normal((3, d)).astype(np.float32)
    q[0] = x[1, 100]
    ns = rng.integers(0, 3, (nlist, cap)).astype(np.int32)
    canon = rng.integers(0, 2, (nlist, cap)).astype(np.int32)
    ns[2] = PAD_TAG                                        # every slot PAD
    ns[3, 128:256] = PAD_TAG                               # a range that is all PAD
    ns[4, cap // 2:] = PAD_TAG                             # a tail past the fill
    ns[1, [100, 130]], canon[1, [100, 130]] = 1, 0
    scale = (rng.random((nlist, cap)).astype(np.float32) + 0.5)
    scale[1, 130] = scale[1, 100]
    if dtype == torch.int8:
        xt = torch.from_numpy(np.clip(np.round(x * 40), -127, 127).astype(np.int8))
        qt = torch.from_numpy(np.clip(np.round(q * 40), -127, 127).astype(np.int8))
    else:
        xt, qt = torch.from_numpy(x).to(dtype), torch.from_numpy(q).to(dtype)
        scale = np.ones_like(scale)
    lists = torch.tensor([[1, 2, 3, 4], [0, 1, 5, 2], [4, 3, 1, 0]])
    return qt, lists, xt, torch.from_numpy(scale), torch.from_numpy(ns), torch.from_numpy(canon)


def _place(parts: list[list[tuple[float, int]]], k: int) -> list[tuple[float, int]]:
    """The kernel's exact merge of sorted lists: each real entry goes to its
    index plus the number of entries of the other lists better than it."""
    better = lambda a, b: a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])  # noqa: E731
    out = [(-math.inf, -1)] * k
    for pi, part in enumerate(parts):
        for i, e in enumerate(part):
            pos = i + sum(sum(better(o, e) for o in other)
                          for oi, other in enumerate(parts) if oi != pi)
            if pos < k:
                out[pos] = e
    return out


def _split_emulation(args, want_ns: int, want_canon: int, k: int, split: int, rows: int):
    """Kernel #6 as probe_split_kernel (probe_f32_kernel on f32 lists, whose
    tiles are 128 rows) computes it, in Python: per range of the plan, each
    warp's top k of its 16-row tiles (in the order (score desc, slot asc)),
    placed into the block's top k, placed into the list's."""
    q, lists, x, scale, ns, canon = args
    cap = x.shape[1]
    if x.dtype == torch.float32:
        rows = BUCKET
    s = torch.einsum("qd,qpcd->qpc", q.float(), x[lists].float())
    if x.dtype == torch.int8:
        s = s * scale[lists]
    ok = ns[lists] != PAD_TAG
    if want_ns >= 0:
        ok &= ns[lists] == want_ns
    if want_canon >= 0:
        ok &= canon[lists] == want_canon
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    key = lambda e: (-e[0], e[1])  # noqa: E731
    out_sc = torch.empty(lists.shape + (k,))
    out_id = torch.empty(lists.shape + (k,), dtype=torch.int32)
    for qi in range(lists.shape[0]):
        for p in range(lists.shape[1]):
            blocks = []
            for begin, end in ip._list_ranges(cap, split):
                warps = [[] for _ in range(rows // 16)]
                for slot in range(begin, end):
                    v = float(s[qi, p, slot])
                    if v > -math.inf:
                        warps[((slot - begin) % rows) // 16].append((v, slot))
                warp_lists = [sorted(w, key=key)[:k] for w in warps]
                blocks.append([e for e in _place(warp_lists, k) if e[0] > -math.inf])
            merged = _place(blocks, k)
            out_sc[qi, p] = torch.tensor([e[0] for e in merged])
            out_id[qi, p] = torch.tensor([e[1] for e in merged], dtype=torch.int32)
    return out_sc, out_id


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cap,split,rows", [(1000, 8, 128), (1000, 3, 64), (384, 2, 128),
                                            (384, 1, 64)])
@pytest.mark.parametrize("wants", [(-1, -1), (1, 0)], ids=["nofilter", "filtered"])
def test_split_and_merge_equals_the_plain_probe(dtype, cap, split, rows, wants):
    args = _list_inputs(7, cap, dtype)
    for k in (1, 40, 128):
        want_sc, want_id = ip._probe_list_plain(*args, *wants, k)
        got_sc, got_id = _split_emulation(args, *wants, k, split, rows)
        assert torch.equal(got_id, want_id)
        assert torch.equal(got_sc, want_sc)
        # the tie across the first range boundary: query 0, list 1 (probe 0)
        assert want_id[0, 0, :2].tolist() == [100, 130][:min(k, 2)]
        assert (want_id[0, 1] == -1).all() and torch.isneginf(want_sc[0, 1]).all()  # all PAD
