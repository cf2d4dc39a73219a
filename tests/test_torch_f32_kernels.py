"""The launch plans and the arithmetic of the two f32 kernels on the CPU:
mha_f32_kernel (#5 in f32, csrc/attention.cu) and batched_bucket_kernel
(#7 on f32 lists, csrc/ivf_probe.cu).

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  Here the Python mirrors of their launch
geometry are checked: every f32 #7 plan at d 384 and 768 fits one block's
232,448 bytes and walks every live (union slot, bucket) item and every
query once; every query row of the attention's tiles is owned by one thread of
one block, and every key by one ring chunk.  The attention kernel's order
of operations (64-key chunks, an online softmax in the log2 domain, -1e30
for masked keys, -inf past T, one division at the end) is written out in
torch and held against tpu_rag's Pallas kernel in interpret mode and the
port's plain version, in f32 within 1e-5.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops.attention import fused_mha as jax_fused_mha
from tpu_rag_torch.ops import attention as att
from tpu_rag_torch.ops import ivf_probe as ip
from tpu_rag_torch.ops.topk import BUCKET

SMS = 132           # H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory of one H100 block
NB = 8              # cap 1024: buckets a list


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
    assert 2 <= plan.stages <= ip._BUCKET_STAGES_MAX
    # the layout written out: slack, queries in rows of whole boxes + 4
    # floats, one-box stages with ns and canon, the winner tables (4 row
    # tiles of 32 rows), the mbarriers
    a1024 = lambda x: -(-x // 1024) * 1024  # noqa: E731
    ld = -(-d // 32) * 32 + 4
    assert ld % 32 == 4                      # four queries of a quarter warp: distinct banks
    want = (1024 + a1024(plan.qc * ld * 4) + plan.stages * a1024(128 * 128 + 2 * 128 * 4)
            + 2 * 4 * plan.qc * 4 * 8 + 8 * 8)
    assert plan.smem == want == ip._f32_bucket_smem(d, plan.qc, plan.stages) <= SMEM_MAX
    assert plan.stages == ip._BUCKET_STAGES_MAX or ip._f32_bucket_smem(
        d, plan.qc, plan.stages + 1) > SMEM_MAX
    # the chunk covers nq (at most 64) unless two stages did not fit beside it
    qc_want = min(64, max(16, 1 << (nq - 1).bit_length()))
    assert plan.qc == qc_want or (plan.qc < qc_want and ip._f32_bucket_smem(
        d, 2 * plan.qc, 2) > SMEM_MAX)
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
    return [(r, min(r + att._F32_ROWS, t)) for r in range(0, t, att._F32_ROWS)]


@pytest.mark.parametrize("t", [1, 127, 128, 160, 512])
def test_f32_attention_tiles_cover_every_row_once(t):
    tiles = _f32_tiles(t)
    rows = [r for begin, end in tiles for r in range(begin, end)]
    assert rows == list(range(t))
    assert len(tiles) == -(-t // att._F32_ROWS) and (t > 128 or len(tiles) == 1)
    # thread (ty, tx) = (tid // 8, tid % 8) of 256 owns rows 4 ty .. 4 ty + 3
    # of its tile: every row of a tile once
    owned = sorted(4 * (tid // 8) + i for tid in range(0, 256, 8) for i in range(4))
    assert owned == list(range(att._F32_ROWS))
    # keys: 64-key chunks cut at T, each in ring stage c % 3
    keys = [k for c in range(-(-t // att._F32_KEYS))
            for k in range(c * att._F32_KEYS, min(t, (c + 1) * att._F32_KEYS))]
    assert keys == list(range(t))


@pytest.mark.parametrize("d", [32, 64])
def test_f32_attention_smem(d):
    ld = d + 4
    want = 4 * (128 * ld + 2 * 3 * 64 * ld + 64 * 132 + 3 * 64)
    assert att._f32_smem(d) == want <= SMEM_MAX
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
        for k0 in range(0, t, att._F32_KEYS):
            k1 = min(t, k0 + att._F32_KEYS)
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
    """The f32 kernel streams K and V, so its wrapper takes T past 512;
    bf16 keeps the head's K and V in shared memory and stops at 512.  (The
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
