"""The launch plans and the arithmetic of the f32 kernels on the CPU:
box_scan_kernel (#1-#3 on f32 rows, and on bf16 rows at d 768,
csrc/topk.cu), mha_f32_kernel (#5 in f32, csrc/attention.cu),
probe_f32_kernel and batched_bucket_kernel (#6 and #7 on f32 lists,
csrc/ivf_probe.cu).

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  Here their launch geometry is checked, with
the kernels' own layouts (csrc/layout.h, through native/layout.cc) against
the layouts written out: every f32 #7 plan at d 384 and 768 fits one block's
232,448 bytes and walks every live (union slot, bucket) item and every
query once; every query row of the attention's tiles is owned by one thread of
one block, and every key by one ring chunk.  The attention kernel's order
of operations (64-key chunks, an online softmax in the log2 domain, -1e30
for masked keys, -inf past T, one division at the end) is written out in
torch and held against tpu_rag's Pallas kernel in interpret mode and the
port's plain version, in f32 within 1e-5.  The f32 scan's selection (its
plan's block ranges, 128-row tiles, thresholds from the seed and the sorted
lists, the bucketed fold) and the f32 per-list probe's (a plan's ranges,
16-slot warp groups of 128-slot tiles, the exact merges) are emulated in
Python on the plain arithmetic's scores: equal to the plain versions, and,
through the port's public functions, to tpu_rag's kernels in interpret
mode, ties included.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops import ivf_probe as jax_probe
from tpu_rag.ops.attention import fused_mha as jax_fused_mha
from tpu_rag.ops.topk import fused_matmul_topk as jax_fused_topk
from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops import attention as att
from tpu_rag_torch.ops import ivf_probe as ip
from tpu_rag_torch.ops import topk as tk
from tpu_rag_torch.ops.topk import BUCKET, PAD_TAG

SMS = 132           # H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory of one H100 block
STAGES_MAX = 8      # ring stages of a probe block
NB = 8              # cap 1024: buckets a list
F32_ROWS = 128      # query rows of an mha_f32_kernel block
F32_KEYS = 64       # keys of its ring chunk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ #7 on f32 lists


def _check_f32_plan(d: int, nq: int, u_max: int = 2048) -> None:
    plan = ip._bucket_plan(u_max, NB, nq, d, torch.float32, SMS)
    assert plan.qc in (16, 32, 64) and plan.rows == BUCKET
    assert 2 <= plan.stages <= STAGES_MAX
    # the layout written out: slack, queries in rows of whole boxes + 4
    # floats, one-box stages with ns and canon, the winner tables (4 row
    # tiles of 32 rows), the mbarriers
    a1024 = lambda x: -(-x // 1024) * 1024  # noqa: E731
    ld = -(-d // 32) * 32 + 4
    assert ld % 32 == 4                      # four queries of a quarter warp: distinct banks
    smem_of = lambda qc, stages: (1024 + a1024(qc * ld * 4)  # noqa: E731
                                  + stages * a1024(128 * 128 + 2 * 128 * 4)
                                  + 2 * 4 * qc * 4 * 8 + 8 * 8)
    assert plan.smem == smem_of(plan.qc, plan.stages) <= SMEM_MAX
    assert plan.smem == layout().tr_bucket_smem(0, d, plan.qc, plan.stages)
    assert plan.stages == STAGES_MAX or smem_of(plan.qc, plan.stages + 1) > SMEM_MAX
    # the chunk covers nq (at most 64) unless two stages did not fit beside it
    qc_want = min(64, max(16, 1 << (nq - 1).bit_length()))
    assert plan.qc == qc_want or (plan.qc < qc_want and smem_of(2 * plan.qc, 2) > SMEM_MAX)
    # a wave of blocks for each query chunk (the grid's y), each chunk's
    # blocks walking its live items
    chunks = -(-nq // plan.qc)
    assert plan.blocks == SMS
    # every query once: the live query groups of each chunk
    queries = []
    for c in range(chunks):
        nql = min(plan.qc, nq - c * plan.qc)
        for qb in (0, plan.qc // 2):
            if qb < nql:                       # the group's warps run the product
                queries += [c * plan.qc + q for q in range(qb, qb + plan.qc // 2)
                            if q < nql]
    assert queries == list(range(nq))
    # every live item once, in contiguous ranges of at most plan.items; the
    # boxes of an item cover d
    assert -(-d // 32) * 32 >= d
    for n_uniq in sorted({1, u_max // 2 + 1, u_max}):
        items = []
        for b in range(plan.blocks):
            n = n_uniq * NB
            ib, ie = n * b // plan.blocks, n * (b + 1) // plan.blocks
            assert ie - ib <= plan.items
            items += range(ib, ie)
        assert items == list(range(n_uniq * NB))


@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("nq", [4, 8, 15, 16, 17, 32, 33, 48, 63, 64, 65, 80, 96, 128, 200,
                                256])
def test_f32_bucket_plan_fits_and_covers_every_item_once(d, nq):
    _check_f32_plan(d, nq)


@pytest.mark.parametrize("d", [384, 768])
def test_every_f32_bucket_plan_from_4_to_256_queries(d):
    for nq in range(4, 257):
        _check_f32_plan(d, nq, u_max=466)


def test_f32_bucket_plan_at_the_kernel_rows():
    """The kernels phase's #7 f32 rows: q 80 at d 384 takes two chunks of 64
    (the second with 16 queries, one live group), a wave of blocks each;
    q 8 takes one 16-query chunk; d 768 halves the chunk to 32."""
    plan = ip._bucket_plan(254, NB, 80, 384, torch.float32, SMS)
    assert (plan.qc, plan.blocks, plan.items) == (64, SMS, -(-254 * NB // SMS))
    assert ip._bucket_plan(254, NB, 8, 384, torch.float32, SMS).qc == 16
    assert ip._bucket_plan(254, NB, 80, 768, torch.float32, SMS).qc == 32


# ------------------------------------------------------------ #5 in f32


def _f32_tiles(t: int) -> list[tuple[int, int]]:
    """The query rows [begin, end) of each block of one head in
    mha_f32_kernel's grid: tiles of 128 rows, the last cut at T."""
    return [(r, min(r + F32_ROWS, t)) for r in range(0, t, F32_ROWS)]


@pytest.mark.parametrize("t", [1, 127, 128, 160, 512])
def test_f32_attention_tiles_cover_every_row_once(t):
    tiles = _f32_tiles(t)
    rows = [r for begin, end in tiles for r in range(begin, end)]
    assert rows == list(range(t))
    assert len(tiles) == -(-t // F32_ROWS) and (t > 128 or len(tiles) == 1)
    # thread (ty, tx) = (tid // 8, tid % 8) of 256 owns rows 4 ty .. 4 ty + 3
    # of its tile: every row of a tile once
    owned = sorted(4 * (tid // 8) + i for tid in range(0, 256, 8) for i in range(4))
    assert owned == list(range(F32_ROWS))
    # keys: 64-key chunks cut at T, each in ring stage c % 3
    keys = [k for c in range(-(-t // F32_KEYS))
            for k in range(c * F32_KEYS, min(t, (c + 1) * F32_KEYS))]
    assert keys == list(range(t))


@pytest.mark.parametrize("d", [32, 64])
def test_f32_attention_smem(d):
    ld = d + 4
    want = 4 * (128 * ld + 2 * 3 * 64 * ld + 64 * 132 + 3 * 64)
    assert layout().tr_mha_smem(0, d, 512) == want <= SMEM_MAX
    assert (ld * 4) % 128 == 16              # eight consecutive K rows: eight bank groups
    assert (132 * 4) % 128 == 16             # P^T rows likewise


def _mha_f32_order(q, k, v, mask):
    """mha_f32_kernel's order of operations in torch: per 128-row tile and
    64-key chunk, S in f32, scaled by log2(e) / sqrt(D), -1e30 for masked
    keys and -inf past T; running max and sum corrected by exp2 of the max's
    change; P.V summed chunk by chunk; one division by the sum at the end."""
    b, t, h, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    c = math.log2(math.e) / math.sqrt(d)
    out = torch.empty_like(qh)
    for r0, r1 in _f32_tiles(t):
        m = torch.full((b, h, r1 - r0, 1), -math.inf)
        ls = torch.zeros((b, h, r1 - r0, 1))
        acc = torch.zeros((b, h, r1 - r0, d))
        for k0 in range(0, t, F32_KEYS):
            k1 = min(t, k0 + F32_KEYS)
            s = qh[:, :, r0:r1] @ kh[:, :, k0:k1].transpose(-1, -2) * c
            keep = (mask[:, k0:k1] > 0)[:, None, None, :]
            s = torch.where(keep, s, torch.full_like(s, -1e30))
            mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx)
            ls = ls * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vh[:, :, k0:k1]
            m = mx
        out[:, :, r0:r1] = acc / ls
    return out.permute(0, 2, 1, 3).contiguous()


def _mha_inputs(t: int, d: int):
    rng = np.random.default_rng(t * 100 + d)
    b, h = 4, 2
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[1, 1:] = 0                            # one token
    mask[2, :] = 0                             # all pad: the average of V
    mask[3, t // 2:] = 0                       # padded keys
    return q, k, v, mask


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 127, 160])
def test_f32_attention_order_matches_the_plain_version(t, d):
    q, k, v, mask = (torch.from_numpy(a) for a in _mha_inputs(t, d))
    got = _mha_f32_order(q, k, v, mask)
    want = att.fused_mha_plain(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), v[2].mean(dim=0, keepdim=True).expand(t, -1, -1),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
def test_f32_attention_order_matches_jax(t, d):
    q, k, v, mask = _mha_inputs(t, d)
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), interpret=True))
    got = _mha_f32_order(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_f32_attention_takes_any_t_in_f32_only(monkeypatch):
    """The f32 kernel's wrapper takes T past 512; bf16 stops at 512, the
    encoders' longest bucket, as far as its kernel is checked.  (The
    wrapper's checks, up to the point where it would build the kernel.)"""
    class Built(Exception):
        pass

    def build(*_a, **_k):
        raise Built

    monkeypatch.setattr(att._build, "function", build)
    mask = torch.ones((1, 520), dtype=torch.int32)
    q = torch.zeros((1, 520, 1, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T <= 512"):
        att._fused_mha_cuda(q, q, q, mask)
    q = torch.zeros((1, 520, 1, 32), dtype=torch.float32)
    with pytest.raises(Built):
        att._fused_mha_cuda(q, q, q, mask)


# ------------------------------------------------------------ #1-#3 on f32 rows

INT_MAX = 2**31 - 1


def _f32_scan_emulation(q, x, ns, canon, want_ns, want_canon, k, mode, sms=SMS, seed=None):
    """box_scan_kernel as it selects, in Python, on the plain version's
    scores: each block of _scan_plan's contiguous ranges walks its rows in
    128-row tiles.  exact/packed: a row is a candidate of a query if it
    beats the query's threshold (its sorted list's k-th entry, never below
    the seed; ties to the lower row), and a tile's candidates merge into the
    list (score desc, row asc); the blocks' lists then merge in row order
    as the wrapper merges them (select_topk).  bucketed: a tile is a bucket,
    its max and the lowest row holding it."""
    n, d = x.shape
    nq = q.shape[0]
    plan = tk._scan_plan(n, d, nq, k if mode != "bucketed" else 0, x.dtype, sms, mode)
    s = tk._scan_scores_plain(q, x, None, ns, canon, None, want_ns, want_canon,
                              apply_qscale=True)
    if mode == "packed":
        s = tk.round18(s)
    ranges = [(b * plan.block_rows, min(n, (b + 1) * plan.block_rows))
              for b in range(plan.blocks)]
    if mode == "bucketed":
        nb = -(-n // BUCKET)
        out_sc = torch.full((nq, nb), -math.inf)
        out_id = torch.full((nq, nb), -1, dtype=torch.int32)
        for begin, end in ranges:
            for r0 in range(begin, end, BUCKET):
                t = s[:, r0:min(end, r0 + BUCKET)]
                best = t.max(dim=1).values
                out_sc[:, r0 // BUCKET] = best
                out_id[:, r0 // BUCKET] = r0 + (t == best[:, None]).int().argmax(dim=1)
        return out_sc, out_id
    blocks_sc, blocks_id = [], []
    for begin, end in ranges:
        bs = torch.full((nq, k), -math.inf)
        bi = torch.full((nq, k), INT_MAX, dtype=torch.int64)
        for qi in range(nq):
            ls, lr = bs[qi], bi[qi]
            seed_q = -math.inf if seed is None else float(seed[qi])
            for r0 in range(begin, end, BUCKET):
                ts, rows = s[qi, r0:min(end, r0 + BUCKET)], torch.arange(r0, min(end, r0 + BUCKET))
                last_s, last_r = float(ls[k - 1]), int(lr[k - 1])
                better = last_s > seed_q or (last_s == seed_q and last_r < INT_MAX)
                thr_s, thr_r = (last_s, last_r) if better else (seed_q, INT_MAX)
                cand = (ts > -math.inf) & ((ts > thr_s) | ((ts == thr_s) & (rows < thr_r)))
                if cand.any():
                    cs, cr = torch.cat([ls, ts[cand]]), torch.cat([lr, rows[cand]])
                    o = torch.argsort(cr, stable=True)
                    cs, cr = cs[o], cr[o]
                    o = torch.argsort(-cs, stable=True)[:k]
                    ls, lr = cs[o], cr[o]
            bs[qi], bi[qi] = ls, lr
        blocks_sc.append(bs)
        blocks_id.append(torch.where(torch.isfinite(bs), bi, -1))
    return tk.select_topk(torch.cat(blocks_sc, 1), torch.cat(blocks_id, 1), k)


def _scan_inputs(seed: int, n: int = 5000, d: int = 64, nq: int = 5):
    """Unit rows with exact ties in one tile (3, 7), across tiles of one
    block and across blocks (3, 700, 4000, n - 1), tags for the filters, a
    rare canon tag (fewer matches than k) and PAD rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for dup in (7, 700, 4000, n - 1):
        x[dup] = x[3]
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[0] = x[3]
    ns = rng.integers(0, 3, n).astype(np.int32)
    ns[[3, 7, 700, 4000, n - 1]] = 1
    ns[2000:2100] = PAD_TAG
    canon = rng.integers(0, 2, n).astype(np.int32)
    canon[:4] = 5
    return x, q, ns, canon


FILTERS = [(-1, -1), (1, -1), (-1, 5)]


@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("k", [20, 160])
@pytest.mark.parametrize("sms", [4, SMS])
@pytest.mark.parametrize("filt", FILTERS, ids=["nofilter", "ns", "canon_fewer_than_k"])
def test_f32_scan_emulation_matches_the_plain_version(mode, k, sms, filt):
    x, q, ns, canon = (torch.from_numpy(a) for a in _scan_inputs(0))
    got_sc, got_id = _f32_scan_emulation(q, x, ns, canon, *filt, k, mode, sms)
    if mode == "bucketed":
        want_sc, want_id = tk._bucketed_scan_plain(q, x, None, ns, canon, *filt)
        fin = torch.isfinite(want_sc)
        assert torch.equal(got_id[fin], want_id[fin])
    else:
        plain = tk._exact_scan_plain if mode == "exact" else tk._packed_scan_plain
        want_sc, want_id = plain(q, x, None, ns, canon, None, *filt, k)
        assert torch.equal(got_id, want_id)
        if filt == (-1, -1):
            assert got_id[0, :5].tolist() == [3, 7, 700, 4000, x.shape[0] - 1]   # ties
    assert torch.equal(got_sc, want_sc)


def _check_bf16_scan_emulation(d: int, mode: str, nq: int, seed: int) -> None:
    """box_scan_kernel's selection on bf16 rows of width d under their own
    plan (a chunk of max(8, nq) queries, blocks over contiguous 128-aligned
    ranges), on the plain bf16 arithmetic's scores, equals the plain
    version, ties across tiles and blocks to the lowest row."""
    assert layout().tr_box_route(tk._DTYPE_CODE[torch.bfloat16])
    x, q, ns, canon = (torch.from_numpy(a) for a in _scan_inputs(seed, d=d, nq=nq))
    x, q = x.to(torch.bfloat16), q.to(torch.bfloat16)
    k = 20
    kk = k if mode != "bucketed" else 0
    plan = tk._scan_plan(5000, d, nq, kk, torch.bfloat16, 4, mode)
    assert plan.qc == max(8, nq) and plan.blocks > 1
    assert plan.smem == layout().tr_scan_smem(tk._DTYPE_CODE[torch.bfloat16], d, plan.qc, kk,
                                              tk._SCAN_MODE[mode], plan.stages)
    got_sc, got_id = _f32_scan_emulation(q, x, ns, canon, -1, -1, k, mode, 4)
    if mode == "bucketed":
        want_sc, want_id = tk._bucketed_scan_plain(q, x, None, ns, canon, -1, -1)
        fin = torch.isfinite(want_sc)
        assert torch.equal(got_id[fin], want_id[fin])
    else:
        plain = tk._exact_scan_plain if mode == "exact" else tk._packed_scan_plain
        want_sc, want_id = plain(q, x, None, ns, canon, None, -1, -1, k)
        assert torch.equal(got_id, want_id)
        assert got_id[0, :5].tolist() == [3, 7, 700, 4000, 4999]    # ties
    assert torch.equal(got_sc, want_sc)


@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_wide_bf16_scan_emulation_matches_the_plain_version(mode, nq):
    """bf16 rows at bge-base's d 768 (tensor-core products, the f32
    kernel's selection): a 64-query chunk fits beside the lists."""
    _check_bf16_scan_emulation(768, mode, nq, 2)


@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_d384_bf16_scan_emulation_matches_the_plain_version(mode, nq):
    """bf16 rows at MiniLM's d 384 take box_scan_kernel too (six boxes a
    row)."""
    _check_bf16_scan_emulation(384, mode, nq, 3)


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_f32_scan_seeded_by_a_prefix_keeps_the_top_k(mode):
    """The wrapper's seed (the k-th score of a prefix scan) in the kernel's
    selection: the same top k, ties across the prefix included."""
    x, q, ns, canon = (torch.from_numpy(a) for a in _scan_inputs(1))
    k, cut = 40, 1024
    seed = _f32_scan_emulation(q, x[:cut], ns[:cut], canon[:cut], -1, -1, k, mode, 4)[0][:, k - 1]
    got = _f32_scan_emulation(q, x, ns, canon, -1, -1, k, mode, 4, seed=seed)
    plain = tk._exact_scan_plain if mode == "exact" else tk._packed_scan_plain
    want = plain(q, x, None, ns, canon, None, -1, -1, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1][0, 0]) == 3


@pytest.mark.parametrize("mode", ["exact", "packed", "bucketed"])
@pytest.mark.parametrize("k", [20, 160])
def test_f32_scan_emulation_matches_jax(monkeypatch, mode, k):
    """The emulated kernel behind the port's fused_matmul_topk against
    tpu_rag's Pallas scan in interpret mode: the same ids (ties to the
    lowest row), scores within 1e-5 (packed: one 18-bit step, and ids but
    next to a JAX neighbour within one step)."""
    x, q, ns, canon = _scan_inputs(2)

    def emulate(mode_):
        def run(q_, x_, _scale, ns_, canon_, *rest):
            if mode_ == "bucketed":
                return _f32_scan_emulation(q_, x_, ns_, canon_, *rest, 0, mode_, 4)
            want_ns, want_canon, k_ = rest[1:]
            return _f32_scan_emulation(q_, x_, ns_, canon_, want_ns, want_canon, k_, mode_, 4)
        return run

    for m in ("exact", "packed", "bucketed"):
        monkeypatch.setattr(tk, f"{m}_scan", emulate(m))
    t_sc, t_id = tk.fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x), k,
                                      ns_tags=torch.from_numpy(ns),
                                      canon_tags=torch.from_numpy(canon), mode=mode)
    j_sc, j_id = jax_fused_topk(jnp.asarray(q), jnp.asarray(x), k, ns_tags=jnp.asarray(ns),
                                canon_tags=jnp.asarray(canon), interpret=True, mode=mode)
    t_sc, t_id, j_sc, j_id = t_sc.numpy(), t_id.numpy(), np.asarray(j_sc), np.asarray(j_id)
    np.testing.assert_array_equal(np.isneginf(t_sc), np.isneginf(j_sc))
    fin = np.isfinite(j_sc)
    if mode == "packed":
        step = np.where(fin, np.abs(j_sc), 0.0) * 2.0 ** -9
        assert (np.abs(t_sc[fin] - j_sc[fin]) <= step[fin]).all()
        for qi, j in zip(*np.nonzero(t_id != j_id)):
            near = [j2 for j2 in (j - 1, j + 1) if 0 <= j2 < k]
            assert any(abs(j_sc[qi, j] - j_sc[qi, j2]) <= step[qi, j] for j2 in near)
    else:
        np.testing.assert_array_equal(t_id, j_id)
        np.testing.assert_allclose(t_sc[fin], j_sc[fin], rtol=0, atol=1e-5)
    if mode != "bucketed":
        assert t_id[0, :5].tolist() == [3, 7, 700, 4000, x.shape[0] - 1]


# ------------------------------------------------------------ #6 on f32 lists


def _f32_probe_emulation(q, lists, x, scale, ns, canon, want_ns, want_canon, k, split=3):
    """probe_f32_kernel as it selects, in Python, on the plain version's
    scores: a list's slots in `split` 128-aligned ranges (one block each);
    in each 128-slot tile warp w takes slots 16 w .. 16 w + 15 into its own
    sorted top k; each block places its warps' entries by rank (merge of
    sorted lists), and the cluster places its blocks' lists the same way."""
    del scale
    cap = x.shape[1]
    s = torch.einsum("qd,qpcd->qpc", q.float(), x[lists].float())
    ok = ns[lists] != PAD_TAG
    if want_ns >= 0:
        ok &= ns[lists] == want_ns
    if want_canon >= 0:
        ok &= canon[lists] == want_canon
    s = torch.where(ok, s, torch.full_like(s, -math.inf))

    def place(parts):
        """Each entry at its index plus the better entries of the other
        sorted lists (ties to the lower slot): the merged top k."""
        out = [(-math.inf, -1)] * k
        for pi, part in enumerate(parts):
            for i, (v, r) in enumerate(part):
                pos = i + sum(1 for oi, other in enumerate(parts) if oi != pi
                              for (ov, orr) in other if ov > v or (ov == v and orr < r))
                if pos < k:
                    out[pos] = (v, r)
        return [e for e in out if e[0] > -math.inf]

    out_sc = torch.full(lists.shape + (k,), -math.inf)
    out_id = torch.full(lists.shape + (k,), -1, dtype=torch.int32)
    for qi in range(lists.shape[0]):
        for p in range(lists.shape[1]):
            blocks = []
            for begin, end in ip._list_ranges(cap, split):
                warps = [[] for _ in range(8)]
                for slot in range(begin, end):
                    v = float(s[qi, p, slot])
                    if v > -math.inf:
                        warps[((slot - begin) % BUCKET) // 16].append((v, slot))
                blocks.append(place([sorted(w, key=lambda e: (-e[0], e[1]))[:k]
                                     for w in warps]))
            merged = place(blocks)
            out_sc[qi, p, :len(merged)] = torch.tensor([e[0] for e in merged])
            out_id[qi, p, :len(merged)] = torch.tensor([e[1] for e in merged], dtype=torch.int32)
    return out_sc, out_id


def _probe_inputs(seed: int, nlist: int = 6, cap: int = 1000, d: int = 64):
    """f32 lists with an exact tie across the split's first range boundary
    (slots 200 and 300 of list 1: ranges [0, 256), [256, 640), [640, 1000)
    at split 3) and inside one warp group (slots 200, 201), an all-PAD list,
    a PAD tail, and tags for the filters."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    x[1, 300] = x[1, 201] = x[1, 200]
    centroids = rng.standard_normal((nlist, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    q[0] = x[1, 200]
    centroids[1] = 20 * q[0]                             # query 0 probes list 1 first
    ns = rng.integers(0, 3, (nlist, cap)).astype(np.int32)
    canon = rng.integers(0, 2, (nlist, cap)).astype(np.int32)
    ns[2] = PAD_TAG
    ns[4, 700:] = PAD_TAG
    ns[1, [200, 201, 300]], canon[1, [200, 201, 300]] = 1, 0
    rows = rng.permutation(nlist * cap).astype(np.int32).reshape(nlist, cap)
    scale = np.ones((nlist, cap), np.float32)
    return q, (centroids, x, scale, ns, canon, rows)


@pytest.mark.parametrize("wants", [(-1, -1), (1, 0)], ids=["nofilter", "filtered"])
@pytest.mark.parametrize("k", [1, 40, 128])
def test_f32_split_probe_emulation_matches_the_plain_version(wants, k):
    q, (centroids, x, scale, ns, canon, _rows) = _probe_inputs(3)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    lists = ip._top_lists(qt, torch.from_numpy(centroids), 4)
    args = (qt, lists, xt, torch.from_numpy(scale), torch.from_numpy(ns),
            torch.from_numpy(canon), *wants, k)
    got_sc, got_id = _f32_probe_emulation(*args)
    want_sc, want_id = ip._probe_list_plain(*args)
    assert torch.equal(got_id, want_id) and torch.equal(got_sc, want_sc)
    assert int(lists[0, 0]) == 1 and got_id[0, 0, :3].tolist() == [200, 201, 300][:k]


@pytest.mark.parametrize("wants", [(-1, -1), (1, 0)], ids=["nofilter", "filtered"])
def test_f32_split_probe_emulation_matches_jax(monkeypatch, wants):
    """The emulated kernel behind the port's ivf_probe_pallas against
    tpu_rag's per-list Pallas probe in interpret mode: the same rows, ties
    included, scores within 1e-5."""
    q, arrays = _probe_inputs(4)
    nprobe, k = 3, 20
    monkeypatch.setattr(ip, "probe_list_topk", _f32_probe_emulation)
    t_sc, t_rows = ip.ivf_probe_pallas(torch.from_numpy(q),
                                       *(torch.from_numpy(a) for a in arrays), wants,
                                       nprobe=nprobe, k=k)
    j_sc, j_rows = jax_probe.ivf_probe_pallas(
        jnp.asarray(q), *(jnp.asarray(a) for a in arrays), jnp.asarray(wants, jnp.int32),
        nprobe=nprobe, k=k, interpret=True)
    j_sc, j_rows = np.asarray(j_sc), np.asarray(j_rows)
    np.testing.assert_array_equal(t_rows.numpy(), j_rows)
    np.testing.assert_array_equal(np.isneginf(t_sc.numpy()), np.isneginf(j_sc))
    fin = np.isfinite(j_sc)
    np.testing.assert_allclose(t_sc.numpy()[fin], j_sc[fin], rtol=0, atol=1e-5)
    if wants == (-1, -1):
        rows = arrays[5]
        assert t_rows[0, :3].tolist() == [rows[1, 200], rows[1, 201], rows[1, 300]]


def test_f32_list_plan_fills_the_card_at_the_kernel_rows():
    """The kernels phase's #6 f32 rows (cap 1024, nprobe 16): the largest
    split that keeps one wave of one block an SM (one query: 8 blocks a
    list, 128 of 132 SMs; three queries: 2, 96 blocks), and the stages of
    half an SM's shared memory (six at d 384)."""
    for nq, split in ((1, 8), (3, 2)):
        for d in (384, 768):
            plan = ip._list_plan(nq, 16, 1024, d, torch.float32, 40, SMS)
            assert plan.split == split and plan.rows == BUCKET
            assert plan.blocks == nq * 16 * split <= SMS and plan.per_sm == 2
            assert plan.smem == layout().tr_list_smem(0, d, 40, plan.stages, BUCKET)
            assert 2 * (plan.smem + 1024) <= 233_472 < 2 * (plan.smem + 16384 + 1024)
    assert ip._list_plan(1, 16, 1024, 384, torch.float32, 40, SMS).stages == 6
    # more lists than SMs: one block a list, as many resident as there are
    plan = ip._list_plan(3, 64, 3968, 384, torch.float32, 40, SMS)
    assert (plan.split, plan.blocks, plan.per_sm) == (1, 192, 2)
