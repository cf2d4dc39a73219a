"""Parity of tpu_rag_torch.ops.topk / quant with tpu_rag.ops (CPU).

The same numpy inputs go through the JAX kernels (Pallas interpret mode) and
the port's plain versions.  Ids must be equal — including ties, which both
break to the lowest row (duplicated rows pin that).  Scores agree within
1e-5 abs: bf16 products are exact in f32, only the summation order differs;
int8 sums are exact integers in both.  Packed mode rounds scores to 18 bits,
where a sum in another order can land one rounding step away: int8 ids and
scores are equal, float scores agree within one step (2^-9 relative) and
float ids are equal except between neighbours whose JAX scores lie within
one step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.ops.quant import quantize_int8_rows as jax_quantize
from tpu_rag.ops.topk import dma_floor_scan as jax_dma_floor_scan
from tpu_rag.ops.topk import fused_matmul_topk as jax_fused_topk
from tpu_rag_torch.ops.quant import quantize_int8_np, quantize_int8_rows
from tpu_rag_torch.ops.topk import (K_MAX, PAD_TAG, dma_floor_scan, fused_matmul_topk,
                                    topk_reference)

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


def _assert_packed_close(t_sc, t_id, j_sc, j_id):
    """Packed float scores: within one 18-bit step; ids equal except next
    to a JAX neighbour within one step."""
    fin = np.isfinite(j_sc)
    step = np.where(fin, np.abs(j_sc), 0.0) * 2.0 ** -9
    assert (np.abs(t_sc[fin] - j_sc[fin]) <= step[fin]).all()
    for qi, j in zip(*np.nonzero(t_id != j_id)):
        near = [j2 for j2 in (j - 1, j + 1) if 0 <= j2 < j_sc.shape[1]]
        assert any(abs(j_sc[qi, j] - j_sc[qi, j2]) <= step[qi, j] for j2 in near), (qi, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "bucketed", "packed"])
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
    j_sc, j_id = np.asarray(j_sc), np.asarray(j_id)
    np.testing.assert_array_equal(np.isneginf(t_sc.numpy()), np.isneginf(j_sc))
    fin = np.isfinite(j_sc)
    if mode == "packed" and dtype != "int8":
        _assert_packed_close(t_sc.numpy(), t_id.numpy(), j_sc, j_id)
    else:
        np.testing.assert_array_equal(t_id.numpy(), j_id)
        np.testing.assert_allclose(t_sc.numpy()[fin], j_sc[fin], rtol=0,
                                   atol=0 if mode == "packed" else 1e-5)
    if mode != "bucketed" and want_ns < 0 and want_canon < 0:
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dma_floor_scan_matches_jax(dtype):
    """The read-rate probe sums every element (JAX's test_ops_topk
    tolerances); the port takes any n, JAX a multiple of its tile."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1024, 384)).astype(np.float32)
    if dtype == "int8":
        j_x, t_x = jnp.asarray((x * 63).astype(np.int8)), torch.from_numpy((x * 63).astype(np.int8))
    elif dtype == "bfloat16":
        j_x, t_x = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        j_x, t_x = jnp.asarray(x), torch.from_numpy(x)
    want = float(jax_dma_floor_scan(j_x, bn=256, interpret=True))
    got = float(dma_floor_scan(t_x, bn=256))
    ref = float(t_x.to(torch.float32).sum(dtype=torch.float64))
    tol = 1.0 if dtype == "int8" else abs(ref) * 1e-2 + 1.0
    assert abs(got - want) < tol and abs(got - ref) < tol
    assert float(dma_floor_scan(t_x[:1000])) == pytest.approx(
        float(t_x[:1000].to(torch.float64).sum()), abs=tol)


def _deep_corpus(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1500, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[1400] = x[3]
    q = rng.standard_normal((3, D)).astype(np.float32)
    q[0] = x[3]
    return x, q


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_k_scan_160_matches_jax(dtype, mode):
    """k_scan = 160, past the 128 the port's selection was once capped at:
    an int8 search with k = 40 scans 4k = 160 rows (packed: max(4k, 64))."""
    x, q = _deep_corpus(6)
    jdb, tdb, scales = _as_db(x, dtype)
    kw = {} if scales is None else {"db_scales": scales}
    j_sc, j_id = jax_fused_topk(jnp.asarray(q), jdb, 160, interpret=True, mode=mode,
                                **{n: jnp.asarray(v) for n, v in kw.items()})
    t_sc, t_id = fused_matmul_topk(torch.from_numpy(q), tdb, 160, mode=mode,
                                   **{n: torch.from_numpy(v) for n, v in kw.items()})
    j_sc, j_id = np.asarray(j_sc), np.asarray(j_id)
    if mode == "packed" and dtype != "int8":
        _assert_packed_close(t_sc.numpy(), t_id.numpy(), j_sc, j_id)
    else:
        np.testing.assert_array_equal(t_id.numpy(), j_id)
        np.testing.assert_allclose(t_sc.numpy(), j_sc, rtol=0, atol=1e-5)
    assert t_id[0, 0].item() == 3


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_k_scan_1024_matches_jax(mode):
    """k_scan = 1024, the deepest selection (RERANK_CANDIDATES 256 on an
    int8 index).  The JAX kernels unroll one pass per k, which interpret
    mode cannot trace at 1024 in a test's time, so the JAX side is
    topk_xla_reference on f32 rows (the semantics of the exact kernel, as
    tests/test_ops_topk.py holds it) and, for packed, lax.top_k (lowest
    position first) over those scores at the packed key's 18 bits."""
    import jax

    from tpu_rag.ops.topk import topk_xla_reference

    x, q = _deep_corpus(8)
    j_sc, j_id = topk_xla_reference(jnp.asarray(q), jnp.asarray(x), 1024)
    if mode == "packed":
        scores = jnp.asarray(q) @ jnp.asarray(x).T
        bits = jax.lax.bitcast_convert_type(scores, jnp.int32) & jnp.int32(-(1 << 14))
        j_sc, j_id = jax.lax.top_k(jax.lax.bitcast_convert_type(bits, jnp.float32), 1024)
    t_sc, t_id = fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x), 1024, mode=mode)
    j_sc, j_id = np.asarray(j_sc), np.asarray(j_id)
    if mode == "packed":
        _assert_packed_close(t_sc.numpy(), t_id.numpy(), j_sc, j_id)
    else:
        np.testing.assert_array_equal(t_id.numpy(), j_id)
        np.testing.assert_allclose(t_sc.numpy(), j_sc, rtol=0, atol=1e-5)
    assert t_id.shape == (3, 1024) and t_id[0, 0].item() == 3


def test_selection_deeper_than_k_max_raises():
    x, q, _, _ = _corpus(7)
    for mode in ("exact", "packed"):
        with pytest.raises(ValueError, match=f"k <= {K_MAX}"):
            fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x), K_MAX + 1, mode=mode)
    sc, ids = fused_matmul_topk(torch.from_numpy(q), torch.from_numpy(x), K_MAX + 1,
                                mode="bucketed")
    assert ids.shape == (Q, K_MAX + 1)
