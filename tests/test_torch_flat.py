"""Parity of tpu_rag_torch.index (FlatIndex + store) with tpu_rag.index on
the CPU: the bundled store searched by both packages, stores crossing
between them, incremental add/delete/compact, packed mode (kernel #2's
plain version against the JAX kernel in interpret mode), a selection depth
past 128, and growth across a padding boundary (the JAX index's jit caches
omit n_pad — flat.py:978, :1077 — so a grown index can search with a stale
padding; the port has no such cache).
"""

import json

import numpy as np
import pytest
import torch

from tpu_rag.index.flat import FlatIndex as JaxFlat
from tpu_rag.index.store import load_index as jax_load
from tpu_rag.index.store import save_index as jax_save
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.store import load_index, save_index

STORE = "examples/store/gamefantasy"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_bundled_store_self_queries_match_jax(dtype):
    jax_idx = jax_load(STORE, dtype=dtype)
    idx = load_index(STORE, dtype=dtype, device="cpu")
    assert idx.count() == jax_idx.count() == 1014
    queries = np.asarray(idx._vectors[::32][:32])
    want = jax_idx.search(queries, 10)
    got = idx.search(queries, 10)
    assert got.ids == want.ids
    np.testing.assert_allclose(np.asarray(got.similarities), np.asarray(want.similarities),
                               rtol=0, atol=1e-4)
    for qi in range(len(queries)):   # each row finds itself (or an exact duplicate)
        assert got.similarities[qi][0] > 0.999


def test_store_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"d{i}" for i in range(50)]
    metas = [{"namespace": f"n{i % 3}", "i": i} for i in range(50)]
    docs = [f"doc {i}" for i in range(50)]

    port = FlatIndex(16, device="cpu")
    port.add(ids, x, docs, metas)
    port.delete(["d3"])
    save_index(port, tmp_path / "from_port")
    jax_idx = jax_load(tmp_path / "from_port")
    assert jax_idx.count() == 49

    ref = JaxFlat(16)
    ref.add(ids, x, docs, metas)
    jax_save(ref, tmp_path / "from_jax")
    back = load_index(tmp_path / "from_jax", device="cpu")
    assert back.count() == 50
    assert back.get("d7")["metadata"] == metas[7] and back.get("d7")["document"] == "doc 7"
    np.testing.assert_allclose(back.get("d7")["vector"], ref.get("d7")["vector"])

    q = x[:4]
    assert back.search(q, 5, namespace="n1").ids == ref.search(q, 5, namespace="n1").ids
    assert jax_idx.search(q, 5).ids == port.search(q, 5).ids
    manifest = json.loads((tmp_path / "from_port" / "manifest.json").read_text())
    assert manifest["format_version"] == 2 and manifest["kind"] == "flat"


def test_v1_store_and_ivf_store_load(tmp_path):
    idx = load_index(STORE, device="cpu")   # the bundled store is format v1
    assert idx.count() == 1014
    from tpu_rag.index.ivf import IVFIndex as JaxIVF
    from tpu_rag_torch.index.ivf import IVFIndex

    x = np.random.default_rng(3).standard_normal((40, 8)).astype(np.float32)
    ref = JaxIVF(8, dtype="float32", nlist=4, nprobe=2)
    ref.add([f"v{i}" for i in range(40)], x)
    jax_save(ref, tmp_path)
    ivf = load_index(tmp_path, device="cpu")
    assert type(ivf) is IVFIndex and ivf.count() == 40
    assert (ivf.nlist, ivf.nprobe) == (4, 2)
    assert ivf.search(x[7], 1).ids == [["v7"]]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_add_delete_compact_parity(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    metas = [{"namespace": "a" if i % 2 else "b"} for i in range(600)]
    ids = [f"r{i}" for i in range(600)]
    q = rng.standard_normal((5, 32)).astype(np.float32)
    ref = JaxFlat(32, dtype=dtype, block_n=256)
    port = FlatIndex(32, dtype=dtype, block_n=256, device="cpu")

    def same(**kw):
        a, b = ref.search(q, 8, **kw), port.search(q, 8, **kw)
        assert a.ids == b.ids
        np.testing.assert_allclose(np.asarray(a.similarities),
                                   np.asarray(b.similarities), rtol=0, atol=1e-4)

    for i in (ref, port):
        i.add(ids[:400], x[:400], metadatas=metas[:400])
    same()
    for i in (ref, port):       # append block + kills, incremental
        i.add(ids[400:], x[400:], metadatas=metas[400:])
        i.delete(ids[::7])
        i.add(["r1"], x[599:600], metadatas=[{"namespace": "a"}])   # upsert
    same()
    same(namespace="a")
    assert port.snapshot_stats["incremental_appends"] >= 1
    assert port.snapshot_stats["incremental_kills"] >= 1
    for i in (ref, port):
        i.compact()
    same()
    assert port.count() == ref.count()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_packed_mode_search_matches_jax(dtype):
    """search_mode="packed": the packed_k_scan oversample, then the residual
    refine; ids equal tpu_rag's before and after adds into the append block."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((700, 32)).astype(np.float32)
    ids = [f"r{i}" for i in range(700)]
    metas = [{"namespace": "a" if i % 3 else "b"} for i in range(700)]
    q = np.concatenate([x[[4, 500]], rng.standard_normal((3, 32)).astype(np.float32)])
    ref = JaxFlat(32, dtype=dtype, block_n=256, search_mode="packed")
    port = FlatIndex(32, dtype=dtype, block_n=256, search_mode="packed", device="cpu")
    assert port.effective_search_mode(700) == "packed"

    def same(**kw):
        a, b = ref.search(q, 8, **kw), port.search(q, 8, **kw)
        assert a.ids == b.ids
        np.testing.assert_allclose(np.asarray(a.similarities),
                                   np.asarray(b.similarities), rtol=0, atol=1e-4)
        return b

    for i in (ref, port):
        i.add(ids[:600], x[:600], metadatas=metas[:600])
    assert same().ids[0][0] == "r4"
    for i in (ref, port):                    # into the append block
        i.add(ids[600:], x[600:], metadatas=metas[600:])
    assert same().ids[1][0] == "r500"
    assert port.snapshot_stats["incremental_appends"] >= 1
    same(namespace="b")


def test_int8_search_k40_matches_jax():
    """int8 with k = 40 scans k_scan = 160 rows, past the 128 the port's
    selection was once capped at (it raised where tpu_rag answers)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((900, 32)).astype(np.float32)
    ids = [f"r{i}" for i in range(900)]
    q = rng.standard_normal((3, 32)).astype(np.float32)
    ref = JaxFlat(32, dtype="int8", block_n=256)
    port = FlatIndex(32, dtype="int8", block_n=256, device="cpu")
    for i in (ref, port):
        i.add(ids, x)
    a, b = ref.search(q, 40), port.search(q, 40)
    assert len(b.ids[0]) == 40 and a.ids == b.ids
    np.testing.assert_allclose(np.asarray(a.similarities), np.asarray(b.similarities),
                               rtol=0, atol=1e-4)


def test_growth_across_padding_boundary_matches_fresh_index():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    ids = [f"r{i}" for i in range(300)]
    q = x[[5, 150, 299]] + 0.01 * rng.standard_normal((3, 32)).astype(np.float32)

    grown = FlatIndex(32, dtype="bfloat16", block_n=128, device="cpu")
    grown.add(ids[:100], x[:100])
    grown.search(q, 5)
    assert grown.device_snapshot()["n_pad"] == 128
    grown.add(ids[100:], x[100:])   # append block: ids at n_pad + slot
    mid = grown.search(q, 5)
    grown.compact()                 # rebuild: n_pad 128 -> 384
    after = grown.search(q, 5)
    assert grown.device_snapshot()["n_pad"] == 384

    fresh = FlatIndex(32, dtype="bfloat16", block_n=128, device="cpu")
    fresh.add(ids, x)
    want = fresh.search(q, 5)
    assert mid.ids == want.ids and after.ids == want.ids
    assert [r[0] for r in after.ids] == ["r5", "r150", "r299"]
