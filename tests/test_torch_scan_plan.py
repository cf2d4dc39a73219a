"""The scan kernels' launch geometry (tpu_rag_torch/ops/topk.py _scan_plan),
a pure function of the shapes, checked on the CPU: every row is scanned
exactly once by contiguous block ranges in block order (the caller's stable
merge relies on it for the lowest-row tie rule), no 128-row bucket straddles
two blocks, and every plan fits one H100 block's shared memory."""

from __future__ import annotations

import pytest
import torch

from tpu_rag_torch.ops import topk as tk

SMS = 132  # H100 SXM
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_every_plan_fits_shared_memory(dtype, mode):
    for k in KS:
        for nq in range(1, 65):
            plan = tk._scan_plan(1_000_000, 384, nq, k, dtype, SMS, mode)
            assert plan.qc in (8, 16, 32, 64)
            assert 2 <= plan.stages <= tk._PIPE_STAGES_MAX
            assert plan.smem <= tk._SMEM_MAX
            elt = tk._ELT[dtype]
            rows = tk._pipe_rows(elt, 384, plan.qc, k, mode)
            assert rows in (64, 128) and (rows == 128) <= (plan.qc == 8)
            assert plan.smem == tk._pipe_smem(elt, 384, plan.qc, k, mode, plan.stages, rows)
            # the chunk is the smallest power of two >= nq, unless lists forced it down
            want = max(8, 1 << (nq - 1).bit_length())
            assert plan.qc == want or (plan.qc < want and tk._pipe_smem(
                elt, 384, 2 * plan.qc, k, mode, 2, 64) > tk._SMEM_MAX)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_bucketed_plans_fit_and_fill_the_ring(dtype):
    for nq in range(1, 129):
        plan = tk._scan_plan(2_000_000, 384, nq, 0, dtype, SMS, "bucketed")
        assert plan.smem <= tk._SMEM_MAX
        rows = tk._pipe_rows(tk._ELT[dtype], 384, plan.qc, 0, "bucketed")
        assert (plan.stages - 1) * rows * 384 * tk._ELT[dtype] >= 64 * 1024


def test_f32_plans_fit_shared_memory():
    for k in KS:
        for nq in (1, 8, 16, 33, 64):
            plan = tk._scan_plan(1_000_000, 384, nq, k, torch.float32, SMS, "exact")
            assert plan.qc % 16 == 0 and plan.stages == 0
            assert plan.smem <= tk._SMEM_MAX


def test_ring_keeps_loads_in_flight_at_main_path_shapes():
    """At the main path's shapes at least 64 KB of the ring is in flight
    (all stages but the one being multiplied)."""
    for dtype, nq, k in ((torch.bfloat16, 1, 20), (torch.bfloat16, 8, 20),
                         (torch.bfloat16, 64, 20), (torch.int8, 64, 40),
                         (torch.int8, 8, 1024), (torch.bfloat16, 8, 64),
                         (torch.int8, 64, 80)):
        plan = tk._scan_plan(1_000_000, 384, nq, k, dtype, SMS, "exact")
        tile = tk._pipe_rows(tk._ELT[dtype], 384, plan.qc, k, "exact") * 384 * tk._ELT[dtype]
        assert (plan.stages - 1) * tile >= 64 * 1024 or plan.stages == tk._PIPE_STAGES_MAX


def test_plan_rejects_what_cannot_fit():
    with pytest.raises(ValueError):
        tk._scan_plan(1000, 8192, 8, 1024, torch.bfloat16, SMS, "exact")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_seed_rows_only_where_the_work_pays(dtype):
    assert tk._seed_rows(1_000_000, 8, 20, dtype) == 0            # nq * k < 512
    assert tk._seed_rows(1_000_000, 64, 20, torch.float32) == 0   # f32 keeps scan_kernel
    assert tk._seed_rows(100_000, 64, 40, dtype) == 0             # n < 8 x the sample
    for nq, k in ((64, 20), (8, 64), (8, 1024), (64, 1024)):
        rows = tk._seed_rows(4_000_000, nq, k, dtype)
        assert rows >= max(32_768, 32 * k) and rows % tk.BUCKET == 0
        assert 8 * rows <= 4_000_000


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
def test_d768_every_plan_fits_shared_memory(dtype, mode):
    """At d 768 a 128-row bf16 stage is 198,656 bytes: a plan falls back to
    64-row stages, and for a chunk of 8 queries whose lists leave no room
    for two of those (bf16 above k 252) to 32-row stages; every depth up to
    K_MAX fits, with the kernel's own arithmetic (_pipe_smem)."""
    elt = tk._ELT[dtype]
    for k in (KS if mode != "bucketed" else (0,)):
        for nq in (1, 2, 7, 8, 9, 16, 31, 32, 33, 63, 64, 80, 128):
            plan = tk._scan_plan(1_000_000, 768, nq, k, dtype, SMS, mode)
            rows = tk._pipe_rows(elt, 768, plan.qc, k, mode)
            assert 2 <= plan.stages <= tk._PIPE_STAGES_MAX and plan.smem <= tk._SMEM_MAX
            assert plan.smem == tk._pipe_smem(elt, 768, plan.qc, k, mode, plan.stages, rows)
            assert rows in (32, 64, 128) and (rows != 64) <= (plan.qc == 8)
            if dtype == torch.bfloat16:
                assert rows != 128                     # one 128-row stage: 198,656 bytes
                assert (rows == 32) == (tk._pipe_fit(elt, 768, plan.qc, k, mode, 64) < 2)
            want = max(8, 1 << (nq - 1).bit_length())
            assert plan.qc == min(want, 64) or (plan.qc < want and tk._pipe_smem(
                elt, 768, 2 * plan.qc, k, mode, 2, 64) > tk._SMEM_MAX)
    # the rehearsal's shapes (k 10: bf16 refine scans 20, int8 40) keep 64 rows
    for nq in (1, 8, 64):
        plan = tk._scan_plan(1_000_000, 768, nq, 20, torch.bfloat16, SMS, "exact")
        assert tk._pipe_rows(2, 768, plan.qc, 20, "exact") == 64


def test_d384_plans_never_take_32_row_stages():
    """The 32-row stage exists for wide rows and deep lists only: at d 384
    every plan keeps the rows it had."""
    for dtype in (torch.bfloat16, torch.int8):
        for mode in ("exact", "packed", "bucketed"):
            for k in (KS if mode != "bucketed" else (0,)):
                for qc in (8, 16, 32, 64):
                    assert tk._pipe_rows(tk._ELT[dtype], 384, qc, k, mode) in (64, 128)
