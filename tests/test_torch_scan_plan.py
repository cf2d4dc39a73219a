"""The scan kernels' launch geometry (tpu_rag_torch/ops/topk.py _scan_plan),
a pure function of the shapes, checked on the CPU: every row is scanned
exactly once by contiguous block ranges in block order (the caller's stable
merge relies on it for the lowest-row tie rule), no 128-row bucket straddles
two blocks, and every plan fits one H100 block's shared memory.  The plans'
bytes, stage rows and kernel are csrc/layout.h's, the code the kernels size
their shared memory with, built for the host by native/layout.cc; here they
are held against the layouts written out."""

from __future__ import annotations

import pytest
import torch

from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops import topk as tk

SMS = 132  # H100 SXM
SMEM_MAX = 232_448   # dynamic shared memory of one H100 block
STAGES_MAX = 8       # ring stages of a scan block
ELT = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
KS = (1, 2, 5, 10, 20, 40, 64, 80, 127, 128, 129, 160, 256, 512, 640, 1000, 1024)


def _ranges(n: int, plan) -> list[tuple[int, int]]:
    return [(b * plan.block_rows, min(n, (b + 1) * plan.block_rows))
            for b in range(plan.blocks)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 5000, 1_000_000, 2_000_000, 12_345_679])
def test_blocks_cover_rows_once_in_order(dtype, mode, n):
    for nq in (1, 8, 64, 80):
        plan = tk._scan_plan(n, 384, nq, 20, dtype, SMS, mode)
        assert plan.block_rows % tk.BUCKET == 0          # buckets never straddle blocks
        ranges = _ranges(n, plan)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (_, end), (begin, _) in zip(ranges, ranges[1:]):
            assert end == begin                           # contiguous, in block order
        assert all(b < e for b, e in ranges)              # no empty block
        assert sum(e - b for b, e in ranges) == n
        chunks = -(-nq // plan.qc)
        assert plan.blocks * chunks <= (2 if dtype == torch.float32 else 1) * SMS or \
            plan.block_rows == tk.BUCKET


def _a128(x: int) -> int:
    return -(-x // 128) * 128


def _box_layout(elt: int, d: int, qc: int, k: int, mode: str, stages: int) -> int:
    """box_scan_kernel's layout written out: slack, one-box stages, query
    rows of whole 128-byte boxes + 16, lists + candidate scratch + masks +
    merge maps + the lists' fill counts or the bucket tables, two
    mbarriers a stage."""
    ld = -(-d * elt // 128) * 128 + 16
    tail = (_a128(qc * k * 8) + _a128(128 * (qc + 1) * 4) + _a128(qc * 16) + 1024 + _a128(qc * 4)
            if mode != "bucketed" else _a128(2 * (4 if qc >= 16 else 8) * qc * 8))
    return 1024 + stages * 16384 + _a128(qc * ld) + tail + 128


def _pipe_layout(d: int, qc: int, k: int, mode: str, stages: int, rows: int) -> int:
    """pipe_scan_kernel's layout (int8 rows) written out: query rows padded
    to 32 bytes + 16, query scales, stages of full-depth rows with their
    ns, canon and scale, lists + candidate scratch + masks + merge maps or
    the row tiles' maxima, one mbarrier a possible stage."""
    ld = -(-d // 32) * 32 + 16
    tail = (_a128(qc * k * 8) + _a128(rows * (qc + 1) * 4) + _a128(qc * rows // 32 * 4) + 1024
            if mode != "bucketed" else _a128(rows // 16 * qc * 8))
    return (_a128(qc * ld) + _a128(qc * 4) + stages * (_a128(rows * ld) + 12 * rows) + tail
            + 64)


def _pipe_rows(d: int, qc: int, k: int, mode: str) -> int:
    """pipe_scan_kernel's stage rows (csrc/layout.h's pipe_rows)."""
    return layout().tr_pipe_rows(d, qc, k, tk._SCAN_MODE[mode])


def _check_box_plan(plan, d: int, nq: int, k: int, mode: str,
                    dtype: torch.dtype = torch.float32) -> None:
    """An f32 or bf16 plan (box_scan_kernel): the chunk is 1 for one f32
    query, else the power of two 8..64 that covers nq unless two stages did
    not fit beside the larger chunk; as many one-box stages as fit (at most
    8), by the layout written out."""
    elt = ELT[dtype]
    assert plan.qc in ((1, 8, 16, 32, 64) if elt == 4 else (8, 16, 32, 64))
    assert 2 <= plan.stages <= STAGES_MAX and plan.smem <= SMEM_MAX
    assert plan.stages == STAGES_MAX or _box_layout(
        elt, d, plan.qc, k, mode, plan.stages + 1) > SMEM_MAX
    want = 1 if nq == 1 and elt == 4 else min(64, max(8, 1 << (nq - 1).bit_length()))
    assert plan.qc == want or (plan.qc < want and _box_layout(
        elt, d, 2 * plan.qc, k, mode, 2) > SMEM_MAX)
    assert plan.smem == _box_layout(elt, d, plan.qc, k, mode, plan.stages)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_every_plan_fits_shared_memory(dtype, mode):
    for k in KS:
        for nq in range(1, 65):
            plan = tk._scan_plan(1_000_000, 384, nq, k, dtype, SMS, mode)
            if dtype != torch.int8:
                _check_box_plan(plan, 384, nq, k, mode, dtype)
                continue
            assert plan.qc in (8, 16, 32, 64)
            assert 2 <= plan.stages <= STAGES_MAX
            assert plan.smem <= SMEM_MAX
            rows = _pipe_rows(384, plan.qc, k, mode)
            assert rows in (64, 128) and (rows == 128) <= (plan.qc == 8)
            assert plan.smem == _pipe_layout(384, plan.qc, k, mode, plan.stages, rows)
            # the chunk is the smallest power of two >= nq, unless lists forced it down
            want = max(8, 1 << (nq - 1).bit_length())
            assert plan.qc == want or (plan.qc < want and _pipe_layout(
                384, 2 * plan.qc, k, mode, 2, 64) > SMEM_MAX)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_bucketed_plans_fit_and_fill_the_ring(dtype):
    for nq in range(1, 129):
        plan = tk._scan_plan(2_000_000, 384, nq, 0, dtype, SMS, "bucketed")
        assert plan.smem <= SMEM_MAX
        if dtype != torch.int8:
            _check_box_plan(plan, 384, nq, 0, "bucketed", dtype)
            stage = 128 * 128                                # one box
        else:
            stage = _pipe_rows(384, plan.qc, 0, "bucketed") * 384
        assert (plan.stages - 1) * stage >= 64 * 1024


def test_f32_query_chunk_is_not_padded_past_nq():
    """The f32 kernel's FMAs scale with its chunk: one query is a chunk of
    1 (box_one_query), 2-8 queries a chunk of 8, and no chunk is more than
    twice the queries it holds."""
    for mode, k in (("exact", 20), ("packed", 64), ("bucketed", 0), ("exact", 1024)):
        for d in (384, 768):
            for nq in range(1, 129):
                plan = tk._scan_plan(1_000_000, d, nq, k, torch.float32, SMS, mode)
                assert plan.qc == 1 if nq == 1 else plan.qc >= 8
                assert plan.qc < 2 * nq or plan.qc == 8
                if nq <= 64:
                    assert plan.qc <= max(8, 1 << (nq - 1).bit_length())


def test_ring_keeps_loads_in_flight_at_main_path_shapes():
    """At the main path's shapes at least 64 KB of the ring is in flight
    (all stages but the one being multiplied); f32 and bf16 stages are one
    box, and bytes bound the f32 scan at 1-8 queries."""
    for dtype, nq, k in ((torch.bfloat16, 1, 20), (torch.bfloat16, 8, 20),
                         (torch.bfloat16, 64, 20), (torch.int8, 64, 40),
                         (torch.int8, 8, 1024), (torch.bfloat16, 8, 64),
                         (torch.int8, 64, 80), (torch.float32, 1, 20),
                         (torch.float32, 8, 20), (torch.float32, 8, 64)):
        plan = tk._scan_plan(1_000_000, 384, nq, k, dtype, SMS, "exact")
        tile = 128 * 128 if dtype != torch.int8 else _pipe_rows(384, plan.qc, k, "exact") * 384
        assert (plan.stages - 1) * tile >= 64 * 1024 or plan.stages == STAGES_MAX


def test_plan_rejects_what_cannot_fit():
    with pytest.raises(ValueError):
        tk._scan_plan(1000, 8192, 8, 1024, torch.bfloat16, SMS, "exact")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_seed_rows_only_where_the_work_pays(dtype):
    """The rule depends on the shapes alone: every scan kernel, f32's too,
    takes the seed; the seeding scan and the full one both have a plan."""
    assert tk._seed_rows(1_000_000, 8, 20) == 0              # nq * k < 512
    assert tk._seed_rows(100_000, 64, 40) == 0               # n < 8 x the sample
    assert tk._seed_rows(1_000_000, 64, 20) == 32_768        # the f32 flat route's q 64
    for nq, k in ((64, 20), (8, 64), (8, 1024), (64, 1024)):
        rows = tk._seed_rows(4_000_000, nq, k)
        assert rows >= max(32_768, 32 * k) and rows % tk.BUCKET == 0
        assert 8 * rows <= 4_000_000
        for n in (rows, 4_000_000):
            plan = tk._scan_plan(n, 384, nq, k, dtype, SMS, "exact")
            assert plan.blocks * plan.block_rows >= n


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_prefix_seed_keeps_the_top_k(mode):
    """The seeding argument on the plain arithmetic: the k-th best score of
    a prefix bounds the k-th best of all rows from below, so the top k of
    the rows scoring at least it equal the top k of all rows (ids and
    order, ties to the lowest row included)."""
    g = torch.Generator().manual_seed(0)
    n, d, nq, k, cut = 4096, 32, 5, 16, 512
    x = torch.randn((n, d), generator=g).to(torch.bfloat16)
    x[3000] = x[7]                                       # a tie across the cut
    q = torch.randn((nq, d), generator=g).to(torch.bfloat16)
    q[0] = x[7]
    ns = torch.zeros((n,), dtype=torch.int32)
    plain = tk._exact_scan_plain if mode == "exact" else tk._packed_scan_plain
    want_sc, want_id = plain(q, x, None, ns, ns, None, -1, -1, k)
    seed = plain(q, x[:cut], None, ns[:cut], ns[:cut], None, -1, -1, k)[0][:, k - 1]
    s = tk._scan_scores_plain(q, x, None, ns, ns, None, -1, -1, apply_qscale=True)
    if mode == "packed":
        s = tk.round18(s)
    kept = torch.where(s >= seed[:, None], s, torch.full_like(s, -float("inf")))
    got_sc, got_id = tk.select_topk(kept, None, k)
    assert torch.equal(got_id, want_id) and torch.equal(got_sc, want_sc)
    assert int(want_id[0, 0]) == 7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("n", [1, 129, 5000, 1_000_000, 2_000_000])
def test_d768_blocks_cover_rows_once_in_order(dtype, mode, n):
    """bge-base's width: the same cover, contiguous and in block order."""
    for nq in (1, 8, 64, 80):
        plan = tk._scan_plan(n, 768, nq, 20, dtype, SMS, mode)
        assert plan.block_rows % tk.BUCKET == 0
        ranges = _ranges(n, plan)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(e == b for (_, e), (b, _) in zip(ranges, ranges[1:]))
        assert sum(e - b for b, e in ranges) == n and all(b < e for b, e in ranges)
        assert plan.blocks * -(-nq // plan.qc) <= SMS or plan.block_rows == tk.BUCKET


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
def test_d768_every_plan_fits_shared_memory(dtype, mode):
    """At d 768 a 64-row bf16 stage is 100,096 bytes: bf16 (like f32) takes
    box_scan_kernel, whose stages are one box of 128 rows x 128 bytes
    whatever d, and int8 keeps pipe_scan_kernel's 64- or 128-row stages;
    every depth up to K_MAX fits, with the kernel's own arithmetic
    (box_scan_smem, pipe_smem; f32's 64-query chunk halves at d 768)."""
    elt = ELT[dtype]
    for k in (KS if mode != "bucketed" else (0,)):
        for nq in (1, 2, 7, 8, 9, 16, 31, 32, 33, 63, 64, 80, 128):
            plan = tk._scan_plan(1_000_000, 768, nq, k, dtype, SMS, mode)
            if dtype == torch.float32:
                _check_box_plan(plan, 768, min(nq, 64), k, mode)
                assert plan.qc <= 32                   # 64 query rows: 197,632 bytes
                continue
            assert 2 <= plan.stages <= STAGES_MAX and plan.smem <= SMEM_MAX
            want = max(8, 1 << (nq - 1).bit_length())
            if dtype == torch.bfloat16:
                assert layout().tr_box_route(tk._DTYPE_CODE[dtype])
                assert plan.smem == _box_layout(elt, 768, plan.qc, k, mode, plan.stages)
                assert plan.stages == STAGES_MAX or _box_layout(
                    elt, 768, plan.qc, k, mode, plan.stages + 1) > SMEM_MAX
                assert plan.qc == min(want, 64) or (plan.qc < want and _box_layout(
                    elt, 768, 2 * plan.qc, k, mode, 2) > SMEM_MAX)
                continue
            rows = _pipe_rows(768, plan.qc, k, mode)
            assert plan.smem == _pipe_layout(768, plan.qc, k, mode, plan.stages, rows)
            assert rows in (64, 128) and (rows == 128) <= (plan.qc == 8)
            assert plan.qc == min(want, 64) or (plan.qc < want and _pipe_layout(
                768, 2 * plan.qc, k, mode, 2, 64) > SMEM_MAX)
    # the rehearsal's shapes (k 10: bf16 refine scans 20, int8 40) take a
    # chunk that covers the queries: the rows are read once
    for nq in (1, 8, 64):
        plan = tk._scan_plan(1_000_000, 768, nq, 20, torch.bfloat16, SMS, "exact")
        assert plan.qc == max(8, nq)


@pytest.mark.parametrize("k", [k for k in KS if k <= 256])
def test_d768_bf16_q64_reads_the_rows_at_most_twice(k):
    """bge-base's scans of a 64-query window (rehearse_scale's index API,
    HTTP windows at microbatch_max): the box ring leaves a 64-query chunk
    room beside its lists up to the main path's k_scan 80, and a 32-query
    one up to k 256, so the rows are read once or twice (64-row stages took
    chunks of 8: eight reads)."""
    for mode in ("exact", "packed", "bucketed"):
        kk = k if mode != "bucketed" else 0
        plan = tk._scan_plan(1_000_000, 768, 64, kk, torch.bfloat16, SMS, mode)
        assert plan.qc >= 32 and -(-64 // plan.qc) <= 2
        assert plan.qc == 64 or k > 80


@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
def test_every_plan_fits_by_the_mirrored_layout(d, dtype, mode):
    """Every plan at d 384 and 768, for every depth of KS and chunk size:
    the bytes of its kernel's one layout (csrc/layout.h; box_route: box or
    pipe) equal that layout written out and fit 232,448, and its blocks
    cover the rows once, in order, 128-aligned."""
    elt, n = ELT[dtype], 2_000_000
    for k in (KS if mode != "bucketed" else (0,)):
        for nq in (1, 2, 8, 9, 33, 64, 80):
            plan = tk._scan_plan(n, d, nq, k, dtype, SMS, mode)
            assert 2 <= plan.stages <= STAGES_MAX and plan.smem <= SMEM_MAX
            if layout().tr_box_route(tk._DTYPE_CODE[dtype]):
                assert plan.smem == _box_layout(elt, d, plan.qc, k, mode, plan.stages)
            else:
                rows = _pipe_rows(d, plan.qc, k, mode)
                assert plan.smem == _pipe_layout(d, plan.qc, k, mode, plan.stages, rows)
            ranges = _ranges(n, plan)
            assert plan.block_rows % tk.BUCKET == 0
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(e == b for (_, e), (b, _) in zip(ranges, ranges[1:]))
            assert all(b < e for b, e in ranges)


def test_box_route_takes_bf16_and_f32_rows():
    """bf16 and f32 scans take box_scan_kernel at every width (MiniLM's
    384, bge-base's 768), int8 scans pipe_scan_kernel."""
    route = lambda dtype: layout().tr_box_route(tk._DTYPE_CODE[dtype])  # noqa: E731
    assert route(torch.bfloat16) and route(torch.float32)
    assert not route(torch.int8)
    for d in (384, 768):
        for nq in (1, 8, 64):
            plan = tk._scan_plan(1_000_000, d, nq, 20, torch.bfloat16, SMS, "exact")
            assert plan.smem == _box_layout(2, d, plan.qc, 20, "exact", plan.stages)


def test_d384_plans_never_take_32_row_stages():
    """pipe_scan_kernel's stages (int8 rows) are 64 or 128 rows: at d 384
    every plan keeps the rows it had (the 32-row stage, once taken by bf16
    at d 768 above k 252, went with bf16 to box_scan_kernel)."""
    for mode in ("exact", "packed", "bucketed"):
        for k in (KS if mode != "bucketed" else (0,)):
            for qc in (8, 16, 32, 64):
                assert _pipe_rows(384, qc, k, mode) in (64, 128)
