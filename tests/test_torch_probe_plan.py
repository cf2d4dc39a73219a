"""Kernel #7's launch geometry (tpu_rag_torch/ops/ivf_probe.py _bucket_plan)
and the semantics its selection must keep, checked on the CPU.

The plan is a pure function of the shapes: every live (union slot, bucket)
item is walked by exactly one block, the ranges are contiguous, and every
plan fits one H100 block's shared memory with at least two ring stages.
The plain version of #7 (_probe_batched_plain, the knock-out sequence of
the TPU kernel) is held against a sort by (score desc, slot asc) per
bucket: the order the kernel's shuffle merges and row-tile fold keep."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tpu_rag_torch.ops import ivf_probe as ip
from tpu_rag_torch.ops.topk import BUCKET, PAD_TAG

SMS = 132  # H100 SXM
D_ALL = (64, 384, 768)


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
        if dtype == torch.float32:
            # each list's buckets split into runs of `items`
            assert (plan.blocks - 1) * plan.items < nb <= plan.blocks * plan.items
            continue
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
        assert plan.blocks * chunks <= SMS or plan.blocks == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", D_ALL)
def test_every_plan_fits_with_two_stages(dtype, d):
    elt = 1 if dtype == torch.int8 else 2
    for nq in range(1, 129):
        plan = ip._bucket_plan(2048, 31, nq, d, dtype, SMS)
        assert plan.qc in (8, 16, 32, 64)
        assert 2 <= plan.stages <= ip._BUCKET_STAGES_MAX
        assert plan.rows in (64, 128) and plan.rows == ip._bucket_rows(elt, d, plan.qc)
        assert plan.smem <= 232_448
        assert plan.smem == ip._bucket_smem(elt, d, plan.qc, plan.stages, plan.rows)
        # the same bytes as the layout written out: slack to align to 1024,
        # queries (inside the ring where int8 queries live in registers),
        # stages of 128-byte column blocks with three tag arrays, the two
        # winner tables, the mbarriers
        kbytes = -(-d * elt // 32) * 32
        a1024 = lambda x: -(-x // 1024) * 1024  # noqa: E731
        wr = plan.rows // (16 * ip._bucket_tiles(plan.qc, plan.rows)[0])
        qreg = elt == 1 and kbytes <= 384
        queries = 0 if qreg else a1024(plan.qc * (kbytes + 16))
        stage = a1024(-(-d * elt // 128) * 128 * plan.rows + 12 * plan.rows)
        assert plan.smem == (1024 + queries + plan.stages * stage
                             + 2 * wr * plan.qc * 4 * 8 + 64)
        assert not qreg or plan.qc * (kbytes + 16) <= stage     # the queries fit a stage
        # the chunk is the smallest power of two >= nq (at most 64) unless
        # two stages did not fit beside it
        want = min(64, max(8, 1 << (nq - 1).bit_length()))
        assert plan.qc == want or (plan.qc < want and ip._bucket_smem(
            elt, d, 2 * plan.qc, 2, ip._bucket_rows(elt, d, 2 * plan.qc)) > 232_448)
        # one more stage would not fit (or the ring is at its most)
        assert plan.stages == ip._BUCKET_STAGES_MAX or ip._bucket_smem(
            elt, d, plan.qc, plan.stages + 1, plan.rows) > 232_448


@pytest.mark.parametrize("qc", [8, 16, 32, 64])
@pytest.mark.parametrize("rows", [64, 128])
def test_warp_tiles_cover_a_stage(qc, rows):
    mtw, wr, wq, ntw = ip._bucket_tiles(qc, rows)
    assert wr * 16 * mtw == rows                              # every row, once
    assert wq * ntw * 8 == qc                                 # every query, once
    assert wr * wq <= ip._BUCKET_WARPS and ntw in (1, 2, 4)
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
    for d in D_ALL:
        for nq in (1, 8, 16, 33, 64, 80):
            plan = ip._bucket_plan(2048, 31, nq, d, torch.float32, SMS)
            assert plan.qc % 16 == 0 and plan.stages == 0 and plan.smem <= 232_448


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
