"""Parity of tpu_rag_torch.parallel.ShardedIVFIndex with tpu_rag's on the
CPU: the counterparts of tests/test_sharded_ivf.py.

Both packages index the same seeded clustered rows over 8 shards (tpu_rag
on its virtual CPU mesh, the port on ["cpu"] * 8).  k-means draws differ
between the packages, so the port adopts tpu_rag's trained centroids
before its first build; the lists, caps and overflow blocks are then the
same, and the per-list probe (#6's plain version here, the Pallas kernel in
interpret mode there) must return tpu_rag's ids, f32 scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from tpu_rag.index.flat import FlatIndex as JaxFlat
from tpu_rag.parallel.mesh import mesh_from_spec as jax_mesh
from tpu_rag.parallel.sharded import ShardedIVFIndex as JaxShardedIVF
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.parallel import ShardedIVFIndex, mesh_from_spec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(n=4000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d))
    x = (centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    metas = [{"namespace": "even" if i % 2 == 0 else "odd"} for i in range(n)]
    return ids, x, metas


def _mk(dtype="float32", nprobe=32, use_pallas=False, n=4000, nlist=32):
    """(tpu_rag's index, the port's, rows), the port on tpu_rag's centroids."""
    ids, x, metas = _corpus(n=n)
    docs = [f"doc {i}" for i in range(len(ids))]
    jax_idx = JaxShardedIVF(x.shape[1], mesh=jax_mesh(""), dtype=dtype, nlist=nlist,
                            nprobe=nprobe, use_pallas=use_pallas)
    idx = ShardedIVFIndex(x.shape[1], mesh=mesh_from_spec("", ["cpu"] * 8), dtype=dtype,
                          nlist=nlist, nprobe=nprobe)
    for ix in (jax_idx, idx):
        ix.add(ids, x, docs, metas)
    jax_idx.device_snapshot()
    idx._cached_centroids = np.asarray(jax_idx._cached_centroids)
    idx._centroids_trained_n = jax_idx._centroids_trained_n
    return jax_idx, idx, x


def _same(got, want, atol=1e-5):
    assert got.ids == want.ids
    for a, b in zip(got.similarities, want.similarities):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_full_probe_matches_exact_and_jax():
    """nprobe == nlist probes every list: exhaustive, equal to FlatIndex."""
    jax_idx, idx, x = _mk(nprobe=32)
    flat = FlatIndex(x.shape[1], dtype="float32", device="cpu")
    ids, _, metas = _corpus()
    flat.add(ids, x, [f"doc {i}" for i in range(len(ids))], metas)
    rng = np.random.default_rng(1)
    qs = x[rng.integers(0, len(x), 8)] + 0.01 * rng.standard_normal((8, x.shape[1])).astype(np.float32)
    got = idx.search(qs, 5)
    assert got.ids == flat.search(qs, 5).ids
    _same(got, jax_idx.search(qs, 5))
    assert idx.last_probe_route == "per_list"
    snap, jsnap = idx.device_snapshot(), jax_idx.device_snapshot()
    assert snap["cap"] == jsnap["vec_lists"].shape[2] and len(snap["vec_lists"]) == 8
    assert snap["have_ov"] == jsnap["have_ov"]


def test_partial_probe_recall_and_jax_ids():
    jax_idx, idx, x = _mk(nprobe=8)
    flat = JaxFlat(x.shape[1], dtype="float32", use_pallas=False)
    ids, _, metas = _corpus()
    flat.add(ids, x, None, metas)
    rng = np.random.default_rng(2)
    qs = x[rng.integers(0, len(x), 16)]
    got = idx.search(qs, 10)
    _same(got, jax_idx.search(qs, 10))
    want = flat.search(qs, 10)
    recall = np.mean([len(set(got.ids[i]) & set(want.ids[i])) / 10 for i in range(16)])
    assert recall >= 0.9, recall


def test_metadata_filter_inside_shards():
    jax_idx, idx, x = _mk(nprobe=32)
    res = idx.search(x[:4], 8, namespace="even")
    for hits_m in res.metadatas:
        assert hits_m, "filter returned nothing"
        assert all(m["namespace"] == "even" for m in hits_m)
    assert res.ids == jax_idx.search(x[:4], 8, namespace="even").ids
    # unseen tag -> no hits
    assert idx.search(x[:1], 3, namespace="nope").ids == [[]]


def test_int8_shards_with_refine():
    jax_idx, idx, x = _mk(dtype="int8", nprobe=32)
    flat = JaxFlat(x.shape[1], dtype="float32", use_pallas=False)
    ids, _, metas = _corpus()
    flat.add(ids, x, None, metas)
    rng = np.random.default_rng(3)
    qs = x[rng.integers(0, len(x), 12)]
    got = idx.search(qs, 10)
    _same(got, jax_idx.search(qs, 10))       # the refine's scores are f32
    want = flat.search(qs, 10)
    recall = np.mean([len(set(got.ids[i]) & set(want.ids[i])) / 10 for i in range(12)])
    assert recall >= 0.95, recall


def test_per_list_probe_on_mesh_matches_jax_kernel():
    """tpu_rag's Pallas probe in interpret mode on every shard against the
    port's per-shard #6 (its plain version on the CPU)."""
    jax_idx, idx, x = _mk(nprobe=4, use_pallas=True, n=1024)
    got = idx.search(x[:2], 3)
    assert got.ids[0][0] == "v0"
    _same(got, jax_idx.search(x[:2], 3))
    assert idx.last_probe_route == "per_list"


def test_self_query_returns_self():
    jax_idx, idx, x = _mk(nprobe=8)
    res = idx.search(x[123], 1)
    assert res.ids[0][0] == "v123"
    assert res.similarities[0][0] > 0.999
    assert res.ids == jax_idx.search(x[123], 1).ids


def test_a_batch_takes_the_per_list_probe():
    """tpu_rag's sharded IVF never routes to the batch-shared probe (#7):
    neither does the port's, at any batch size."""
    jax_idx, idx, x = _mk(nprobe=8)
    qs = x[:64]
    got = idx.search(qs, 10)
    assert idx.last_probe_route == "per_list"
    _same(got, jax_idx.search(qs, 10))


def test_deep_k_takes_the_plain_probe():
    """min(k, cap) above K_EFF_MAX (128): the plain probe, as tpu_rag routes."""
    jax_idx, idx, x = _mk(nprobe=2, nlist=2)
    k = 150
    assert idx.device_snapshot()["cap"] > 128
    got = idx.search(x[:2], k)
    assert idx.last_probe_route == "reference"
    _same(got, jax_idx.search(x[:2], k))
