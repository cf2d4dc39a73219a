"""Parity of tpu_rag_torch.ops.topk / quant with tpu_rag.ops (CPU).

The same numpy inputs go through the JAX kernels (Pallas interpret mode) and
the port's plain versions.  Ids must be equal — including ties, which both
break to the lowest row (duplicated rows pin that).  Scores agree within
1e-5 abs: bf16 products are exact in f32, only the summation order differs;
int8 sums are exact integers in both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops.quant import quantize_int8_rows as jax_quantize
from tpu_rag.ops.topk import fused_matmul_topk as jax_fused_topk
from tpu_rag_torch.ops.quant import quantize_int8_np, quantize_int8_rows
from tpu_rag_torch.ops.topk import PAD_TAG, fused_matmul_topk, topk_reference

N, D, Q = 700, 32, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    # duplicated rows: exact score ties that must go to the lowest row, in
    # one 128-row bucket (3, 7) and across buckets (3, 300, N - 1)
    for dup in (7, 300, N - 1):
        x[dup] = x[3]
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q[0] = x[3]
    ns = rng.integers(0, 3, N).astype(np.int32)
    ns[[3, 7, 300, N - 1]] = 1
    canon = rng.integers(0, 2, N).astype(np.int32)
    canon[:4] = 5   # a rare tag: 4 matches < k
    return x, q, ns, canon


def _as_db(x: np.ndarray, dtype: str):
    """(jax database, torch database, scales np or None) from f32 rows."""
    if dtype == "int8":
        vals, scales = quantize_int8_np(x)
        return jnp.asarray(vals), torch.from_numpy(vals), scales
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return jnp.asarray(x).astype(jnp.bfloat16), t, None
    return jnp.asarray(x), torch.from_numpy(x), None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "bucketed"])
@pytest.mark.parametrize("filt", [(-1, -1), (1, -1), (-1, 5)],
                         ids=["nofilter", "ns", "canon_fewer_than_k"])
def test_fused_topk_matches_jax(dtype, mode, filt):
    x, q, ns, canon = _corpus(0)
    jdb, tdb, scales = _as_db(x, dtype)
    k = 10
    want_ns, want_canon = filt
    j_sc, j_id = jax_fused_topk(
        jnp.asarray(q), jdb, k,
        db_scales=None if scales is None else jnp.asarray(scales),
        ns_tags=jnp.asarray(ns), canon_tags=jnp.asarray(canon),
        want_ns=want_ns, want_canon=want_canon, interpret=True, mode=mode)
    t_sc, t_id = fused_matmul_topk(
        torch.from_numpy(q), tdb, k,
        db_scales=None if scales is None else torch.from_numpy(scales),
        ns_tags=torch.from_numpy(ns), canon_tags=torch.from_numpy(canon),
        want_ns=want_ns, want_canon=want_canon, mode=mode)
    np.testing.assert_array_equal(t_id.numpy(), np.asarray(j_id))
    j_sc = np.asarray(j_sc)
    np.testing.assert_array_equal(np.isneginf(t_sc.numpy()), np.isneginf(j_sc))
    fin = np.isfinite(j_sc)
    np.testing.assert_allclose(t_sc.numpy()[fin], j_sc[fin], rtol=0, atol=1e-5)
    if mode == "exact" and want_ns < 0 and want_canon < 0:
        assert t_id[0, 0].item() == 3   # the tie goes to the lowest row
    if want_canon == 5:
        assert (t_id.numpy()[:, 4:] == -1).all()   # 4 matches, k = 10


def test_absent_tag_array_ignores_its_filter():
    x, q, ns, _ = _corpus(1)
    t_sc, t_id = fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x), 5,
                                   ns_tags=torch.from_numpy(ns), want_ns=1,
                                   want_canon=3)
    j_sc, j_id = jax_fused_topk(jnp.asarray(q), jnp.asarray(x), 5,
                                ns_tags=jnp.asarray(ns), want_ns=1, want_canon=3,
                                interpret=True)
    np.testing.assert_array_equal(t_id.numpy(), np.asarray(j_id))
    assert (ns[t_id.numpy()] == 1).all()


def test_k_larger_than_n_pads():
    x, q, _, _ = _corpus(2)
    t_sc, t_id = fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x[:5]), 8)
    assert t_id.shape == (Q, 8)
    assert (t_id[:, 5:] == -1).all() and torch.isneginf(t_sc[:, 5:]).all()
    assert sorted(t_id[0, :5].tolist()) == [0, 1, 2, 3, 4]


def test_topk_reference_matches_jax():
    from tpu_rag.ops.topk import topk_xla_reference

    x, q, ns, canon = _corpus(3)
    vals, scales = quantize_int8_np(x)
    ns[10:20] = PAD_TAG
    for db_j, db_t, sc in ((jnp.asarray(x), torch.from_numpy(x), None),
                           (jnp.asarray(vals), torch.from_numpy(vals), scales)):
        j_sc, j_id = topk_xla_reference(
            jnp.asarray(q), db_j, 12,
            db_scales=None if sc is None else jnp.asarray(sc),
            ns_tags=jnp.asarray(ns), canon_tags=jnp.asarray(canon), want_ns=2)
        t_sc, t_id = topk_reference(
            torch.from_numpy(q), db_t, 12,
            db_scales=None if sc is None else torch.from_numpy(sc),
            ns_tags=torch.from_numpy(ns), canon_tags=torch.from_numpy(canon), want_ns=2)
        np.testing.assert_array_equal(t_id.numpy(), np.asarray(j_id))
        np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=0, atol=1e-5)


def test_quantize_int8_rows_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((257, D)).astype(np.float32)
    x[5] = 0.0                     # all-zero row: scale 1.0
    x[6, :] = 127.0 * 0.5          # exact .5 multiples: round half to even
    x[6, 0] = 127.0
    j_vals, j_scales = jax_quantize(jnp.asarray(x))
    t_vals, t_scales = quantize_int8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    np.testing.assert_allclose(t_scales.numpy(), np.asarray(j_scales), rtol=0, atol=1e-7)
    h_vals, h_scales = quantize_int8_np(x)
    np.testing.assert_array_equal(h_vals, t_vals.numpy())
    assert t_scales[5].item() == 1.0
