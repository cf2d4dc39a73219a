"""Parity of tpu_rag_torch.parallel (mesh, ShardedFlatIndex) with
tpu_rag.parallel on the CPU: the counterparts of tests/test_sharded.py.

Both packages index the same seeded numpy rows; tpu_rag's index runs on its
8-device virtual CPU mesh (tests/conftest.py), the port's on a mesh of
["cpu"] * 8 (or data:2,model:4 where the reference uses one), whose shards
run the plain versions of the scans.  Ids must be equal where the reference
is exact (f32, bf16 and int8 with the host refine), f32 scores within 1e-5
absolute; the bucketed mode must keep the same candidates as the JAX kernel
(interpret mode), one max per 128 consecutive global rows.
"""

import numpy as np
import pytest
import torch

import jax

from tpu_rag.index import FlatIndex as JaxFlat
from tpu_rag.parallel import ShardedFlatIndex as JaxSharded
from tpu_rag.parallel import mesh_from_spec as jax_mesh
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.parallel import Mesh, ShardedFlatIndex, mesh_from_spec

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(n, d, seed, two_ns=True):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    metas = [{"namespace": ["a", "b"][i % 2]} for i in range(n)] if two_ns else None
    return rng, vecs, ids, metas


def _pair(d, spec="data:8", **kw):
    """(tpu_rag's sharded index, the port's) on the same mesh geometry."""
    use_pallas = kw.pop("use_pallas", False)
    return (JaxSharded(d, mesh=jax_mesh(spec), use_pallas=use_pallas, **kw),
            ShardedFlatIndex(d, mesh=mesh_from_spec(spec, CPU8), **kw))


def test_mesh_from_spec():
    m = mesh_from_spec("", CPU8)
    assert m.shape == {"data": 8} and m.shape["data"] == jax_mesh("").shape["data"]
    m2 = mesh_from_spec("data:4,model:2", CPU8)
    assert m2.shape == dict(jax_mesh("data:4,model:2").shape) == {"data": 4, "model": 2}
    assert list(m2.shape) == ["data", "model"]
    assert mesh_from_spec("data:-1,model:2", CPU8).shape == {"data": 4, "model": 2}
    assert mesh_from_spec("model:2,data:", CPU8).shape == {"model": 2, "data": 4}
    with pytest.raises(ValueError, match="needs 6 devices, have 8"):
        mesh_from_spec("data:3,model:2", CPU8)
    # one shard per position along data, on the first device of its row
    assert m2.axis_devices("data") == [torch.device("cpu")] * 4
    assert isinstance(m2, Mesh) and m2.devices.size == 8


def test_default_mesh_is_every_cuda_device():
    if torch.cuda.is_available():
        assert mesh_from_spec("").shape == {"data": torch.cuda.device_count()}
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_from_spec("")
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedFlatIndex(16)              # default mesh: every CUDA device
    with pytest.raises(TypeError, match="mesh"):
        ShardedFlatIndex(16, mesh=mesh_from_spec("", CPU8), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_matches_single_device(dtype):
    rng, vecs, ids, metas = _rows(4000, 64, 0)
    jax_idx, idx = _pair(64, dtype=dtype)
    single = FlatIndex(64, dtype=dtype, device="cpu")
    for ix in (jax_idx, idx, single):
        ix.add(ids, vecs, metadatas=metas)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    got, want, one = idx.search(q, 10), jax_idx.search(q, 10), single.search(q, 10)
    assert got.ids == want.ids
    np.testing.assert_allclose(np.asarray(got.similarities), np.asarray(want.similarities),
                               rtol=0, atol=1e-5)
    if dtype == "float32":                   # equal to the port's unsharded index
        assert got.ids == one.ids
        np.testing.assert_allclose(np.asarray(got.similarities),
                                   np.asarray(one.similarities), rtol=0, atol=1e-5)


def test_sharded_filter():
    _rng, vecs, ids, metas = _rows(2000, 32, 1)
    jax_idx, idx = _pair(32, dtype="float32")
    jax_idx.add(ids, vecs, metadatas=metas)
    idx.add(ids, vecs, metadatas=metas)
    res = idx.search(vecs[0], 10, namespace="b")
    assert all(m["namespace"] == "b" for m in res.metadatas[0])
    assert len(res.ids[0]) == 10
    assert res.ids == jax_idx.search(vecs[0], 10, namespace="b").ids
    assert idx.search(vecs[0], 3, namespace="nope").ids == [[]]


def test_sharded_kernel_path_matches_jax_kernel():
    """tpu_rag's Pallas scan in interpret mode on every shard against the
    port's per-shard scan (the plain version of #1 on the CPU)."""
    rng, vecs, ids, _ = _rows(1000, 128, 2, two_ns=False)
    jax_idx, idx = _pair(128, dtype="float32", use_pallas=True)
    flat = JaxFlat(128, dtype="float32", use_pallas=False)
    for ix in (jax_idx, idx, flat):
        ix.add(ids, vecs)
    q = rng.standard_normal((2, 128)).astype(np.float32)
    got = idx.search(q, 5)
    assert got.ids == jax_idx.search(q, 5).ids == flat.search(q, 5).ids
    snap = idx.device_snapshot()
    assert len(snap["vectors"]) == 8 and snap["shard_rows"] == 256


def test_sharded_int8_matches_jax():
    rng, vecs, ids, _ = _rows(1500, 64, 3, two_ns=False)
    exact = JaxFlat(64, dtype="float32", use_pallas=False)
    exact.add(ids, vecs)
    jax_idx, idx = _pair(64, dtype="int8")
    jax_idx.add(ids, vecs)
    idx.add(ids, vecs)
    q = rng.standard_normal((2, 64)).astype(np.float32)
    got = idx.search(q, 10)
    assert got.ids == jax_idx.search(q, 10).ids
    truth = exact.search(q, 10)
    recalls = [len(set(a) & set(b)) / 10 for a, b in zip(truth.ids, got.ids)]
    assert np.mean(recalls) >= 0.9  # int8 quantization tolerance
    # the shards hold the JAX package's quantized rows (host mirror)
    snap, jsnap = idx.device_snapshot(), jax_idx.device_snapshot()
    np.testing.assert_array_equal(torch.cat(snap["vectors"]).numpy(),
                                  np.asarray(jsnap["vectors"]))


def test_sharded_int8_refine_matches_jax():
    rng, vecs, ids, _ = _rows(3000, 64, 21, two_ns=False)
    exact = JaxFlat(64, dtype="float32", use_pallas=False)
    exact.add(ids, vecs)
    jax_idx, idx = _pair(64, dtype="int8")
    assert idx.refine_factor == jax_idx.refine_factor > 0
    jax_idx.add(ids, vecs)
    idx.add(ids, vecs)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    got = idx.search(q, 10)
    want = jax_idx.search(q, 10)
    assert got.ids == want.ids
    # the refine re-scores in f32 from the master: scores are exact
    np.testing.assert_allclose(np.asarray(got.similarities), np.asarray(want.similarities),
                               rtol=0, atol=1e-5)
    truth = exact.search(q, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(truth.ids, got.ids)]) >= 0.95


def test_sharded_bucketed_mode_keeps_the_kernels_candidates():
    """One candidate per 128 consecutive global rows on every shard: the
    port's bucketed shards give the JAX kernel's ids (interpret mode), and
    recall >= 0.9 against exact, as tests/test_sharded.py asks."""
    rng, vecs, ids, _ = _rows(32768, 64, 9, two_ns=False)
    exact = FlatIndex(64, dtype="float32", device="cpu")
    exact.add(ids, vecs)
    jax_idx, idx = _pair(64, dtype="float32", use_pallas=True, search_mode="bucketed")
    jax_idx.add(ids, vecs)
    idx.add(ids, vecs)
    q = rng.standard_normal((2, 64)).astype(np.float32)
    got = idx.search(q, 10)
    assert got.ids == jax_idx.search(q, 10).ids
    truth = exact.search(q, 10)
    recalls = [len(set(a) & set(b)) / 10 for a, b in zip(truth.ids, got.ids)]
    assert np.mean(recalls) >= 0.9
    # the rule itself: every hit is the max of its 128-row bucket
    for qi, hits in enumerate(got.ids):
        s = vecs @ (q[qi] / np.linalg.norm(q[qi]))
        s /= np.linalg.norm(vecs, axis=1)
        for h in hits:
            r = int(h[1:])
            b = r // 128
            assert np.argmax(s[b * 128:(b + 1) * 128]) == r - b * 128


def test_sharded_auto_mode_resolves_per_data_axis_shard():
    """"auto" divides by the DATA axis size, not the whole device count: on
    a data:2 x model:4 mesh each shard holds n/2 rows."""
    _rng, vecs, ids, _ = _rows(3072, 64, 21, two_ns=False)
    jax_idx, idx = _pair(64, spec="data:2,model:4", dtype="float32")
    for ix in (jax_idx, idx):
        # between n/2 (1536, per-shard rows) and n/8 (384): bucketed
        ix.auto_bucketed_min_rows = 1000
        ix.add(ids, vecs)
    assert len(idx.shard_devices()) == 2
    res = idx.search(vecs[5], 3)
    assert res.ids[0][0] == "v5"
    assert res.ids == jax_idx.search(vecs[5], 3).ids
    assert idx.effective_search_mode(idx.count() // idx.mesh.shape["data"]) == "bucketed"
    assert {key[1] for key in jax_idx._search_fns} == {"bucketed"}
    assert len(idx.device_snapshot()["vectors"]) == 2


def test_sharded_packed_mode_matches_jax():
    rng, vecs, ids, _ = _rows(2048, 64, 4, two_ns=False)
    jax_idx, idx = _pair(64, dtype="bfloat16", use_pallas=True, search_mode="packed")
    jax_idx.add(ids, vecs)
    idx.add(ids, vecs)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    got, want = idx.search(q, 10), jax_idx.search(q, 10)
    assert got.ids == want.ids
    np.testing.assert_allclose(np.asarray(got.similarities), np.asarray(want.similarities),
                               rtol=0, atol=1e-5)


def test_sharded_search_takes_the_two_step_path():
    _rng, vecs, ids, _ = _rows(600, 32, 5, two_ns=False)
    idx = ShardedFlatIndex(32, mesh=mesh_from_spec("data:4", ["cpu"] * 4), dtype="float32")
    idx.add(ids, vecs)
    assert idx.search_fused(lambda ids_: None, np.zeros((1, 8), np.int64), 1, 5) is None
    assert idx.search(vecs[17], 1).ids[0][0] == "v17"


# ---- data-parallel embed and the engine over a sharded index


@pytest.fixture(scope="module")
def tiny_params():
    from tpu_rag.models.bert import BertSpec as JaxSpec
    from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder

    spec = JaxSpec(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128, max_len=64)
    jax_single = JaxBiEncoder(spec=spec, seq_len=32, batch=8)
    params = jax.tree_util.tree_map(np.asarray, jax_single.params)
    return spec, jax_single, params


def test_dp_embed_matches_single_device_and_jax(tiny_params):
    """The counterpart of tests/test_vocab_and_dp_embed.py's
    test_dp_embed_matches_single_device: on shared params, the port's
    data-parallel embed (8 entries of the data axis) equals its single-device
    embed and tpu_rag's embed on its 8-device mesh, within 1e-5."""
    from jax.sharding import Mesh as JaxMesh

    from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
    from tpu_rag_torch.models.bert import BertSpec, params_from_flax
    from tpu_rag_torch.models.biencoder import BiEncoder

    jspec, _jax_single, params = tiny_params
    jax_dp = JaxBiEncoder(spec=jspec, seq_len=32, batch=8,
                          mesh=JaxMesh(np.array(jax.devices()[:8]), axis_names=("data",)))
    jax_dp.params = jax.device_put(jax.tree_util.tree_map(np.asarray, params),
                                   jax_dp._param_shardings)
    spec = BertSpec(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128, max_len=64)
    sd = params_from_flax(params)
    single = BiEncoder(spec=spec, seq_len=32, batch=8, device="cpu", state_dict=sd)
    dp = BiEncoder(spec=spec, seq_len=32, batch=6, device="cpu", state_dict=sd,
                   mesh=mesh_from_spec("", CPU8))
    assert dp.batch == 8 and dp._bucket(3) == 8     # rounded up to the data axis
    assert len(dp._replicas) == 1                   # repeated devices share a replica

    texts = [f"sentence number {i} about topic {i % 3}" for i in range(20)]
    e_dp = dp.embed(texts)
    assert e_dp.shape == (20, 64)
    np.testing.assert_allclose(e_dp, single.embed(texts), rtol=0, atol=1e-5)
    np.testing.assert_allclose(e_dp, jax_dp.embed(texts), rtol=0, atol=1e-5)
    tp = BiEncoder(spec=spec, seq_len=32, batch=8, device="cpu", state_dict=sd,
                   mesh=mesh_from_spec("data:4,model:2", CPU8))
    np.testing.assert_allclose(tp.embed(texts), e_dp, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match='"model" mesh axis of size 8'):
        BiEncoder(spec=spec, device="cpu", state_dict=sd, mesh=mesh_from_spec("model:8", CPU8))


SLICE_DOCS = [
    {"title": "Moon Temple", "metadata": {"namespace": "lore"},
     "content": "The moon temple stands on the silver cliff above the tide."},
    {"title": "Iron Sword", "metadata": {"namespace": "items"},
     "content": "A heavy iron sword forged by the mountain smiths of Karn."},
    {"title": "Archive", "metadata": {"namespace": "lore"},
     "content": " ".join(f"chronicle{i % 37} of the archive scribe {i}" for i in range(40))},
    {"title": "River Map", "metadata": {"namespace": "items"},
     "content": "A map of the seven rivers that cross the eastern plains."},
]


def test_engine_over_a_sharded_index_matches_tpu_rag(tmp_path, monkeypatch):
    """The slice as a whole: MESH_SHAPE=data:8 in both packages (the port's
    mesh on ["cpu"] * 8), /docs/save, /search, a re-save that kills the old
    row in its shard, and a filtered search through each package's test
    client, on the same tiny encoder params.  The engines build sharded
    indexes and data-parallel encoders, and return the same documents."""
    from tpu_rag.api.app import create_app as jax_create_app
    from tpu_rag.api.testclient import TestClient as JaxClient
    from tpu_rag.config import Config as JaxConfig
    from tpu_rag.engine import RagEngine as JaxEngine
    from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.testclient import TestClient
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.models.bert import params_from_flax
    from tpu_rag_torch.models.biencoder import BiEncoder

    jax_enc = JaxBiEncoder("tiny")
    params = jax.tree_util.tree_map(np.asarray, jax_enc.params)
    mesh = mesh_from_spec("data:8", CPU8)
    enc = BiEncoder("tiny", device="cpu", state_dict=params_from_flax(params), mesh=mesh)
    monkeypatch.setattr(RagEngine, "_mesh", lambda self: mesh)

    def paths(tmp, cls):
        return cls(persist_dir=str(tmp / "vs"), kb_db_path=str(tmp / "db" / "kb.sqlite3"),
                   db_path=str(tmp / "db" / "app.sqlite3"), docs_dir=str(tmp / "docs"),
                   mesh_shape="data:8")

    def drive(client, engine):
        for d in SLICE_DOCS:
            assert client.post("/docs/save", json=d).status_code == 200
        titles = []
        for d in SLICE_DOCS:
            r = client.post("/search", json={"query": d["content"], "k": 3}).json()
            titles.append([h["metadata"]["title"] for h in r["hits"]])
        # a new version of a doc: the old row dies on its shard
        engine.index.compact()
        client.post("/search", json={"query": "warm", "k": 1})
        client.post("/docs/save", json={**SLICE_DOCS[0],
                                        "content": "The moon temple fell into the sea."})
        r = client.post("/search", json={"query": SLICE_DOCS[0]["content"], "k": 4}).json()
        titles.append([(h["metadata"]["title"], h["text"][:20]) for h in r["hits"]])
        r = client.post("/search", json={"query": "map of rivers", "k": 3,
                                         "namespace": "items"}).json()
        titles.append([h["metadata"]["title"] for h in r["hits"]])
        return titles

    cfg = paths(tmp_path / "port", Config)
    cfg.device = "cpu"
    engine = RagEngine(cfg, encoder=enc)
    try:
        assert type(engine.index) is ShardedFlatIndex
        titles = drive(TestClient(create_app(cfg, engine=engine)), engine)
        assert engine.index.count() == len(SLICE_DOCS)
        assert engine.index.snapshot_stats["incremental_kills"] == 1
    finally:
        engine.shutdown()
    assert [t[0] for t in titles[:4]] == [d["title"] for d in SLICE_DOCS]

    jcfg = paths(tmp_path / "jax", JaxConfig)
    jengine = JaxEngine(jcfg, encoder=jax_enc)
    try:
        assert type(jengine.index).__name__ == "ShardedFlatIndex"
        jtitles = drive(JaxClient(jax_create_app(jcfg, engine=jengine)), jengine)
    finally:
        jengine.shutdown()
    assert titles == jtitles
