"""Parity of tpu_rag_torch.ops.attention.fused_mha with tpu_rag's Pallas
kernel (interpret mode) on the CPU, in f32: every row — real, padded query
and all-pad — within 1e-5 (same formula, summation order differs); and the
bf16 kernel's shared-memory layout (csrc/layout.h, through native/layout.cc)
against the layout written out."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops.attention import fused_mha as jax_fused_mha
from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops import attention as att
from tpu_rag_torch.ops.attention import fused_mha


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("t, d", [(128, 32), (256, 32), (160, 64), (512, 64)],
                         ids=["128", "256", "160-d64", "512-d64"])
def test_fused_mha_matches_jax(t, d):
    """MiniLM's head dim at T 128 and 256; bge-base's D 64 at the reranker
    eval's ragged T 160 and at the longest bucket, T 512."""
    rng = np.random.default_rng(t)
    b, h = 3, 2
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[0, t - 40:] = 0          # padded keys
    mask[1, 5:] = 0               # mostly padding
    mask[2, :] = 0                # all-pad row: a uniform average of V
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), interpret=True))
    got = fused_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(mask)).numpy()
    assert got.shape == (b, t, h, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2, 0], v[2].mean(axis=0), rtol=0, atol=1e-5)


def test_fused_mha_bf16_output_dtype():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 32)).astype(np.float32))
    out = fused_mha(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                    torch.ones((1, 128), dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("d", [32, 64])
def test_bf16_block_fits_two_blocks_an_sm_at_every_t(d):
    """mha_tc_kernel<D>'s layout (csrc/layout.h's tc_stages and
    tc_smem_bytes): the 128-row Q tile and a ring of 64-key K and V chunks
    in rows of D + 8 bf16, plus a flag a key of T's chunks.  The ring holds
    T's chunks up to a depth that leaves room for two blocks an SM (233,472
    bytes, each block reserving 1,024 more): at D 32 every T <= 512 whole,
    at D 64 five chunks (T 512's whole K and V took 167,936 bytes, one
    block an SM)."""
    lay = layout()
    for t in range(1, att._T_MAX + 1):
        stages = lay.tr_mha_stages(d, t)
        chunks = -(-t // 64)
        assert stages == (chunks if d == 32 else min(chunks, 5))
        smem = lay.tr_mha_smem(1, d, t)
        assert smem == 2 * (128 + 2 * stages * 64) * (d + 8) + chunks * 64 * 4
        assert 233_472 // (smem + 1024) >= 2
    assert lay.tr_mha_smem(1, 64, 512) == 112_640


def _tc_order(q, k, v, mask):
    """mha_tc_kernel's online softmax in torch (f32 throughout): per 64-key
    chunk, S scaled by log2(e) / sqrt(D), -1e30 for masked keys, the running
    max and sum corrected by exp2 of the max's change, P.V added chunk by
    chunk, one division at the end."""
    b, t, h, d = q.shape
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, t, 1), -math.inf)
    ls = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, 64):
        k1 = min(t, k0 + 64)
        real = mask[:, k0:k1] > 0
        s = qh @ kh[:, :, k0:k1].transpose(-1, -2) * c
        s = torch.where(real[:, None, None, :], s, torch.full_like(s, -1e30))
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx)
        m, ls, acc = mx, ls * corr + p.sum(dim=-1, keepdim=True), acc * corr + p @ vh[:, :, k0:k1]
    return (acc / ls).permute(0, 2, 1, 3)


@pytest.mark.parametrize("t", [200, 256])
def test_chunked_softmax_over_masked_key_chunks(t):
    """mha_tc_kernel's chunk-by-chunk softmax on rows whose masked keys
    fill whole 64-key chunks: against a real max m a masked chunk's
    probabilities are exp2(-1e30 - m) = 0, and one met before the row's
    first real key is wiped by that key's correction exp2(-1e30 - m) = 0.
    Within 1e-5 of the plain version: a ragged tail, leading pads, a masked
    middle chunk, one real key last, and an all-pad row (the average of
    V)."""
    rng = np.random.default_rng(t)
    b, h, d = 6, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[0, 100:] = 0                          # a ragged tail
    mask[1, :70] = 0                           # leading pads: chunk 0 masked
    mask[2, 64:128] = 0                        # a masked middle chunk
    mask[3, :t - 1] = 0                        # one real key, the last
    mask[4] = 0                                # all pad: the average of V
    got = _tc_order(q, k, v, mask)
    want = fused_mha(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4, 0].numpy(), v[4].mean(dim=0).numpy(), rtol=0, atol=1e-5)
