"""Parity of tpu_rag_torch.ops.attention.fused_mha with tpu_rag's Pallas
kernel (interpret mode) on the CPU, in f32: every row — real, padded query
and all-pad — within 1e-5 (same formula, summation order differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops.attention import fused_mha as jax_fused_mha
from tpu_rag_torch.ops.attention import fused_mha


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("t", [128, 256])
def test_fused_mha_matches_jax(t):
    rng = np.random.default_rng(t)
    b, h, d = 3, 2, 32
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
