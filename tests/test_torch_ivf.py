"""Parity of the port's IVF path with tpu_rag's on the CPU.

The same numpy inputs go through the JAX functions (the probe kernels in
Pallas interpret mode, the index with use_pallas=True) and the port's (the
kernels' plain versions).  Ids must be equal; scores agree within 1e-5 abs
for float lists (only the summation order differs: bf16 products are exact
in f32) and within 1e-6 relative for int8 lists (integer sums are exact in
both, the scales are the same f32 products).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_rag.index.ivf import IVFIndex as JaxIVF
from tpu_rag.index.store import load_index as jax_load
from tpu_rag.index.store import save_index as jax_save
from tpu_rag.ops import ivf_probe as jax_probe
from tpu_rag.ops.ivf_build import group_lists as jax_group_lists
from tpu_rag.ops.kmeans import _update_centroids as jax_update_centroids
from tpu_rag.ops.kmeans import assign_clusters as jax_assign
from tpu_rag_torch.index.ivf import IVFIndex
from tpu_rag_torch.index.store import load_index, save_index
from tpu_rag_torch.ops import ivf_probe
from tpu_rag_torch.ops.ivf_build import group_lists
from tpu_rag_torch.ops.kmeans import _update_centroids, assign_clusters, kmeans
from tpu_rag_torch.ops.quant import quantize_int8_np
from tpu_rag_torch.ops.topk import PAD_TAG


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lists(seed: int, nlist: int, cap: int, d: int, dtype: str):
    """Random probe inputs: (numpy arrays for both packages, torch lists)."""
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((nlist, d)).astype(np.float32)
    x = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    x[0, 9] = x[0, 3]          # exact ties: inside one list and across lists
    x[5, 1] = x[0, 3]
    ns = rng.integers(0, 3, (nlist, cap)).astype(np.int32)
    ns[:, -8:] = PAD_TAG
    ns[0, [3, 9]] = ns[5, 1] = 1
    canon = np.zeros((nlist, cap), np.int32)
    rows = rng.permutation(nlist * cap).astype(np.int32).reshape(nlist, cap)
    scales = np.ones((nlist, cap), np.float32)
    if dtype == "int8":
        vals, sc = quantize_int8_np(x.reshape(-1, d))
        x_j, x_t = jnp.asarray(vals.reshape(nlist, cap, d)), torch.from_numpy(vals).view(nlist, cap, d)
        scales = sc.reshape(nlist, cap)
    elif dtype == "bfloat16":
        x_t = torch.from_numpy(x).to(torch.bfloat16)
        x_j = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    q = rng.standard_normal((6, d)).astype(np.float32)
    q[0] = x[0, 3]
    centroids[0], centroids[5] = q[0], 0.9 * q[0]   # query 0 probes lists 0, 5 first
    np_args = (centroids, scales, ns, canon, rows)
    jax_args = lambda q: (jnp.asarray(q), jnp.asarray(centroids), x_j, jnp.asarray(scales),  # noqa: E731
                          jnp.asarray(ns), jnp.asarray(canon), jnp.asarray(rows))
    torch_args = lambda q: (torch.from_numpy(q), torch.from_numpy(centroids), x_t,  # noqa: E731
                            *(torch.from_numpy(a) for a in np_args[1:]))
    return q, jax_args, torch_args


def _same(t_sc, t_rows, j_sc, j_rows, dtype):
    j_sc, j_rows = np.asarray(j_sc), np.asarray(j_rows)
    np.testing.assert_array_equal(t_rows.numpy(), j_rows)
    t_sc = t_sc.numpy()
    np.testing.assert_array_equal(np.isneginf(t_sc), np.isneginf(j_sc))
    fin = np.isfinite(j_sc)
    if dtype == "int8":
        np.testing.assert_allclose(t_sc[fin], j_sc[fin], rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(t_sc[fin], j_sc[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("wants", [(-1, -1), (1, -1)], ids=["nofilter", "ns"])
def test_per_list_probe_matches_jax(dtype, wants):
    nlist, cap, d, nprobe, k = 16, 64, 32, 4, 5
    q, jax_args, torch_args = _lists(0, nlist, cap, d, dtype)
    q = q[:4]
    j_sc, j_rows = jax_probe.ivf_probe_pallas(
        *jax_args(q), jnp.asarray(wants, jnp.int32), nprobe=nprobe, k=k, interpret=True)
    t_sc, t_rows = ivf_probe.ivf_probe_pallas(*torch_args(q), wants, nprobe=nprobe, k=k)
    _same(t_sc, t_rows, j_sc, j_rows, dtype)
    assert t_rows.shape == (4, k)
    if wants == (-1, -1):
        # query 0 is the triplicated row: ties go probe-major, then to the
        # lowest slot
        rows = torch_args(q)[6]
        assert t_rows[0, :3].tolist() == [rows[0, 3], rows[0, 9], rows[5, 1]]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("bucket_m", [1, 2, 3, 4])
@pytest.mark.parametrize("wants", [(-1, -1), (1, -1)], ids=["nofilter", "ns"])
def test_batched_probe_matches_jax(dtype, bucket_m, wants):
    nlist, cap, d, nprobe, k = 16, 256, 32, 4, 12
    q, jax_args, torch_args = _lists(1, nlist, cap, d, dtype)
    j_sc, j_rows = jax_probe.ivf_probe_batched(
        *jax_args(q), jnp.asarray(wants, jnp.int32), nprobe=nprobe, k=k,
        bucket_m=bucket_m, interpret=True)
    t_sc, t_rows = ivf_probe.ivf_probe_batched(*torch_args(q), wants, nprobe=nprobe,
                                               k=k, bucket_m=bucket_m)
    _same(t_sc, t_rows, j_sc, j_rows, dtype)
    assert t_rows.shape == (6, k)


@pytest.mark.parametrize("bucket_m", [1, 2, 3, 4])
def test_batched_probe_bf16_on_bf16_queries_matches_jax(bucket_m):
    """bf16 lists: the port's batched probe casts the queries to bf16 (as
    both packages' per-list probes do); the JAX batched probe keeps f32
    queries against bf16 lists (tpu_rag/ops/ivf_probe.py:356-358, ADVICE r5
    — a divergence, not a copy).  On queries that are bf16 numbers already
    both compute the same exact products, so ids and scores agree."""
    nlist, cap, d, nprobe, k = 16, 256, 32, 4, 12
    q, jax_args, torch_args = _lists(2, nlist, cap, d, "bfloat16")
    q = torch.from_numpy(q).to(torch.bfloat16).to(torch.float32).numpy()
    wants = (1, -1)
    j_sc, j_rows = jax_probe.ivf_probe_batched(
        *jax_args(q), jnp.asarray(wants, jnp.int32), nprobe=nprobe, k=k,
        bucket_m=bucket_m, interpret=True)
    t_sc, t_rows = ivf_probe.ivf_probe_batched(*torch_args(q), wants, nprobe=nprobe, k=k,
                                               bucket_m=bucket_m)
    _same(t_sc, t_rows, j_sc, j_rows, "bfloat16")


def test_batched_probe_pads_and_dedups():
    """More candidates wanted than exist: -inf/-1 padding; each query ranks
    only its own nprobe lists; the union stays on the device."""
    nlist, cap, d, nprobe = 8, 128, 16, 2
    q, _, torch_args = _lists(3, nlist, cap, d, "float32")
    args = torch_args(q)
    lists = ivf_probe._top_lists(args[0], args[1], nprobe)
    uniq, n_uniq, qslots = ivf_probe._dedup(lists, nlist)
    assert uniq.shape == (min(6 * nprobe, nlist),)
    assert torch.equal(uniq[qslots.reshape(-1)].long(), lists.reshape(-1))
    assert int(n_uniq) == len(torch.unique(lists))
    t_sc, t_rows = ivf_probe.ivf_probe_batched(*args, (-1, 5), nprobe=nprobe, k=7)
    assert (t_rows == -1).all() and torch.isneginf(t_sc).all()   # no canon 5
    t_sc, t_rows = ivf_probe.ivf_probe_batched(*args, (-1, -1), nprobe=nprobe, k=600)
    assert t_rows.shape == (6, 600)
    own = args[6][lists]                                       # (Q, nprobe, cap)
    for i in range(6):
        got = t_rows[i][t_rows[i] >= 0]
        assert torch.isin(got, own[i].reshape(-1)).all()
        assert len(got) == nprobe * 2 * (cap // 128)           # m = 2 per bucket


def test_assign_and_update_centroids_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[rng.choice(700, 9, replace=False)]
    c[4] = c[2]                                   # tied centroids: lowest wins
    j_assign = np.asarray(jax_assign(jnp.asarray(x), jnp.asarray(c), chunk=256))
    t_assign = assign_clusters(torch.from_numpy(x), c, chunk=256)
    np.testing.assert_array_equal(t_assign.numpy(), j_assign)
    assert not (j_assign == 4).any()
    j_c, j_n = jax_update_centroids(jnp.asarray(x), jnp.asarray(j_assign), nlist=9)
    t_c, t_n = _update_centroids(torch.from_numpy(x), t_assign, nlist=9)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), rtol=0, atol=1e-6)


def test_kmeans_unit_norm_centroids_without_empty_clusters():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((900, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    centroids, assign = kmeans(torch.from_numpy(x), 12, iters=6, seed=3)
    assert centroids.shape == (12, 16) and assign.dtype == np.int32
    np.testing.assert_allclose(np.linalg.norm(centroids, axis=1), 1.0, atol=1e-5)
    assert (np.bincount(assign, minlength=12) > 0).all()
    np.testing.assert_array_equal(assign, assign_clusters(torch.from_numpy(x), centroids).numpy())
    again, _ = kmeans(torch.from_numpy(x), 12, iters=6, seed=3)
    np.testing.assert_array_equal(again, centroids)          # seeded draws


def test_group_lists_matches_jax():
    rng = np.random.default_rng(6)
    n, d, nlist, cap = 300, 8, 5, 40              # some clusters spill past cap
    x = rng.standard_normal((n, d)).astype(np.float32)
    ns = rng.integers(0, 4, n).astype(np.int32)
    canon = rng.integers(0, 2, n).astype(np.int32)
    live = rng.permutation(10 * n)[:n].astype(np.int32)
    assign = rng.choice(nlist, n, p=[0.4, 0.3, 0.1, 0.1, 0.1]).astype(np.int32)
    want = jax_group_lists(*(jnp.asarray(a) for a in (x, ns, canon, live, assign)),
                           nlist=nlist, cap=cap)
    got = group_lists(*(torch.from_numpy(a) for a in (x, ns, canon, live, assign)),
                      nlist=nlist, cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.asarray(want[5]).all()          # rows did spill


# ------------------------------------------------------------ index level


def _skewed_corpus(seed: int, n: int = 2000, d: int = 32):
    """Unit rows around 8 directions with one heavy cluster, so k-means
    gives one list past cap = 1.5 x mean and the spill lands in overflow."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32)
    which = rng.choice(8, n, p=[0.25] + [0.75 / 7] * 7)
    x = centers[which] + 0.6 * rng.standard_normal((n, d)).astype(np.float32)
    metas = [{"namespace": ("a", "b", "c")[i % 3]} for i in range(n)]
    return x.astype(np.float32), [f"r{i}" for i in range(n)], metas, rng


@pytest.fixture(scope="module")
def jax_ivf_store(tmp_path_factory):
    """A JAX-built IVF store (k-means by jax.random) with its centroids."""
    x, ids, metas, _ = _skewed_corpus(7)
    ref = JaxIVF(32, dtype="float32", nlist=8, nprobe=4, use_pallas=True)
    ref.add(ids, x, metadatas=metas)
    ref.device_snapshot()
    path = tmp_path_factory.mktemp("ivf") / "store"
    jax_save(ref, path)
    return path


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ivf_index_matches_jax_through_mutations(jax_ivf_store, dtype):
    ref = jax_load(jax_ivf_store, dtype=dtype, use_pallas=True)
    port = load_index(jax_ivf_store, dtype=dtype, device="cpu")
    assert isinstance(port, IVFIndex) and isinstance(ref, JaxIVF)
    x, ids, metas, rng = _skewed_corpus(7)
    q_all = (x[rng.choice(len(x), 6, replace=False)]
             + 0.3 * rng.standard_normal((6, 32)).astype(np.float32))

    def same(nq, route, **kw):
        a, b = ref.search(q_all[:nq], 5, **kw), port.search(q_all[:nq], 5, **kw)
        assert port.last_probe_route == route
        assert b.ids == a.ids
        np.testing.assert_allclose(np.asarray(b.similarities), np.asarray(a.similarities),
                                   rtol=0, atol=1e-5)

    def both(**kw):
        for nq, route in ((2, "per_list"), (6, "batched")):
            same(nq, route, **kw)
            same(nq, route, namespace="b", **kw)

    both()
    snap = port.device_snapshot()
    assert snap["vec_lists"].shape[1] == 384 and len(snap["ov_rows"]) > 0   # spill
    assert np.array_equal(port._cached_centroids, ref._cached_centroids)

    # adds into the append block, then deletes in the lists, the overflow
    # and the append block; the old snapshot is left as it was
    new = x[:40] + 0.05 * rng.standard_normal((40, 32)).astype(np.float32)
    new_ids = [f"n{i}" for i in range(40)]
    for idx in (ref, port):
        idx.add(new_ids, new, metadatas=[{"namespace": "b"}] * 40)
    both()
    assert port.device_snapshot()["a_fill"] == 40
    ov_victims = [ids[r] for r in snap["ov_rows"][:5]]
    main_victims = [ids[r] for r in np.flatnonzero(port._main_slot_of >= 0)[::50][:8]]
    ns_before = snap["ns_lists"].clone()
    for idx in (ref, port):
        idx.delete(ov_victims + main_victims + new_ids[:3])
    both()
    assert torch.equal(snap["ns_lists"], ns_before)
    assert port.snapshot_stats["incremental_kills"] == 16

    # compaction: the appended rows merge into spare list slots on the device
    for idx in (ref, port):
        idx.compact()
    both()
    assert port.snapshot_stats.get("ivf_device_merges", 0) > 0
    assert port.snapshot_stats["ivf_device_merges"] == ref.snapshot_stats["ivf_device_merges"]

    # vacuum renumbers host rows: the slot map is dropped and rebuilt
    for idx in (ref, port):
        assert idx.vacuum() == 16
    assert len(port._main_slot_of) == 0 and port._list_fill is None
    both()
    assert port.count() == ref.count() == 2000 + 40 - 16


def test_ivf_store_round_trips_between_packages(tmp_path, jax_ivf_store):
    port = load_index(jax_ivf_store, device="cpu")
    ref = jax_load(jax_ivf_store, use_pallas=True)
    np.testing.assert_array_equal(port._cached_centroids, ref._cached_centroids)
    assert port._centroids_trained_n == ref._centroids_trained_n == 2000
    assert (port.nlist, port.nprobe) == (8, 4)

    # port -> JAX: a port-trained index, centroids included
    x, ids, metas, rng = _skewed_corpus(8, n=600)
    mine = IVFIndex(32, dtype="float32", nlist=6, nprobe=3, device="cpu")
    mine.add(ids, x, metadatas=metas)
    mine.delete(ids[:4])
    mine.device_snapshot()
    save_index(mine, tmp_path / "from_port")
    manifest = json.loads((tmp_path / "from_port" / "manifest.json").read_text())
    assert manifest["kind"] == "ivf" and manifest["ivf"]["nlist"] == 6
    assert manifest["ivf"]["trained_n"] == 596 and manifest["ivf"]["centroids_shape"] == [6, 32]
    back_j = jax_load(tmp_path / "from_port", use_pallas=True)
    assert isinstance(back_j, JaxIVF) and back_j.count() == 596
    np.testing.assert_array_equal(back_j._cached_centroids, mine._cached_centroids)
    q = x[[10, 200, 599]]
    assert back_j.search(q, 5).ids == mine.search(q, 5).ids

    # JAX -> port -> JAX again: the port writes what it read
    save_index(port, tmp_path / "again")
    again = jax_load(tmp_path / "again", use_pallas=True)
    np.testing.assert_array_equal(again._cached_centroids, ref._cached_centroids)
    assert again.get("r5")["metadata"] == ref.get("r5")["metadata"]


class _HashEncoder:
    """Deterministic bag-of-words embeddings (no model)."""

    dim = 64

    def embed(self, texts):
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for tok in t.lower().split():
                h = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=4).digest(), "little")
                out[i, h % self.dim] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


def test_engine_ivf_over_test_client(tmp_path):
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.testclient import TestClient
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine

    def engine():
        cfg = Config(persist_dir=str(tmp_path / "vs"), kb_db_path=str(tmp_path / "db/kb.sqlite3"),
                     db_path=str(tmp_path / "db/app.sqlite3"), docs_dir=str(tmp_path / "docs"),
                     index_kind="ivf", index_dtype="float32", ivf_nlist=4, ivf_nprobe=4,
                     device="cpu")
        return cfg, RagEngine(cfg, encoder=_HashEncoder())

    cfg, eng = engine()
    assert type(eng.index) is IVFIndex
    eng.index.search_fused = None          # the fused flat path must not run
    try:
        client = TestClient(create_app(cfg, engine=eng))
        for i in range(30):
            r = client.post("/docs/save", json={"title": f"T{i}",
                                                "content": f"unique topic{i} keywords alpha"})
            assert r.status_code == 200, r.text
        r = client.post("/search", json={"query": "unique topic7 keywords alpha", "k": 3})
        assert r.status_code == 200, r.text
        hits = r.json()["hits"]
        assert len(hits) == 3 and "T7" in [h["metadata"]["title"] for h in hits]
        assert eng.index.last_probe_route == "per_list"
        eng.persist_index()                # now with the trained centroids
    finally:
        eng.shutdown()
    _, eng2 = engine()                     # reload from the persisted store
    try:
        assert type(eng2.index) is IVFIndex and eng2.index.count() == 30
        assert eng2.index._cached_centroids is not None
    finally:
        eng2.shutdown()


def test_ivf_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine

    with pytest.raises(RuntimeError, match="cuda"):
        IVFIndex(16)                        # default device: cuda
    cfg = Config(persist_dir=str(tmp_path / "vs"), db_path=str(tmp_path / "db" / "a.sqlite3"),
                 kb_db_path=str(tmp_path / "db" / "kb.sqlite3"),
                 docs_dir=str(tmp_path / "docs"), index_kind="ivf")
    with pytest.raises(RuntimeError, match="cuda"):
        RagEngine(cfg, encoder=_HashEncoder())
