"""The ported slice end to end on the CPU: /health, /docs/save (with a long
document, so the T = 128 bucket runs the fused attention's plain version),
/search with and without a namespace filter, DELETE /docs/{id}, /search
with rerank (the lazily built cross-encoder, at the tiny spec), and the
same docs and queries through tpu_rag's app with the same (carried-across)
tiny encoder params, which must return the same documents; then the same
drive with INDEX_SEARCH_MODE=packed (kernel #2's plain version here, the
JAX kernel in interpret mode there)."""

import numpy as np
import pytest
import torch

import jax

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

DOCS = [
    {"title": "Moon Temple", "metadata": {"namespace": "lore"},
     "content": "The moon temple stands on the silver cliff above the tide."},
    {"title": "Iron Sword", "metadata": {"namespace": "items"},
     "content": "A heavy iron sword forged by the mountain smiths of Karn."},
    {"title": "Archive", "metadata": {"namespace": "lore"},
     "content": " ".join(f"chronicle{i % 37} of the archive scribe {i}" for i in range(40))},
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def encoders():
    jax_enc = JaxBiEncoder("tiny")
    params = jax.tree_util.tree_map(np.asarray, jax_enc.params)
    return jax_enc, BiEncoder("tiny", device="cpu", state_dict=params_from_flax(params))


def _paths(tmp, cls):
    return cls(persist_dir=str(tmp / "vs"), kb_db_path=str(tmp / "db" / "kb.sqlite3"),
               db_path=str(tmp / "db" / "app.sqlite3"), docs_dir=str(tmp / "docs"))


def _drive(client):
    """Save DOCS, then search each by its own text; returns titles per query
    and the saved ids."""
    saved = []
    for d in DOCS:
        r = client.post("/docs/save", json=d)
        assert r.status_code == 200, r.text
        saved.append(r.json()["id"])
    titles = []
    for d in DOCS:
        r = client.post("/search", json={"query": d["content"], "k": 3})
        assert r.status_code == 200, r.text
        titles.append([h["metadata"]["title"] for h in r.json()["hits"]])
    return titles, saved


def test_slice_end_to_end_matches_tpu_rag(tmp_path, encoders):
    jax_enc, enc = encoders
    assert enc.tokenizer.tokenize_ids(DOCS[2]["content"]).__len__() >= 130
    cfg = _paths(tmp_path / "port", Config)
    cfg.device = "cpu"
    cfg.rerank_model = "tiny"
    engine = RagEngine(cfg, encoder=enc)
    client = TestClient(create_app(cfg, engine=engine))
    try:
        health = client.get("/health").json()
        assert health["status"] == "ok" and health["device"]["backend"] == "cpu"

        titles, saved = _drive(client)
        assert engine.index.count() == 3
        assert [t[0] for t in titles] == [d["title"] for d in DOCS]

        r = client.post("/search", json={"query": DOCS[0]["content"], "k": 3,
                                         "namespace": "items"}).json()
        assert [h["metadata"]["namespace"] for h in r["hits"]] == ["items"]
        r = client.post("/search", json={"queries": [d["content"] for d in DOCS],
                                         "k": 1}).json()
        assert [res["hits"][0]["id"] for res in r["results"]] == saved

        assert client.delete(f"/docs/{saved[0]}").status_code == 200
        r = client.post("/search", json={"query": DOCS[0]["content"], "k": 3}).json()
        assert saved[0] not in [h["id"] for h in r["hits"]]
        assert engine.index.count() == 2
        r = client.post("/search", json={"query": "moon", "k": 3, "rerank": True}).json()
        assert r["reranked"] is True and all("rerank_score" in h for h in r["hits"])
    finally:
        engine.shutdown()

    jcfg = _paths(tmp_path / "jax", JaxConfig)
    jengine = JaxEngine(jcfg, encoder=jax_enc)
    try:
        jtitles, _ = _drive(JaxClient(jax_create_app(jcfg, engine=jengine)))
    finally:
        jengine.shutdown()
    assert titles == jtitles


def test_slice_packed_mode_matches_tpu_rag(tmp_path, encoders):
    jax_enc, enc = encoders
    cfg = _paths(tmp_path / "port", Config)
    cfg.device, cfg.index_search_mode = "cpu", "packed"
    engine = RagEngine(cfg, encoder=enc)
    try:
        assert engine.index.search_mode == "packed"
        titles, _ = _drive(TestClient(create_app(cfg, engine=engine)))
        assert engine.index.effective_search_mode(engine.index.count()) == "packed"
    finally:
        engine.shutdown()
    assert [t[0] for t in titles] == [d["title"] for d in DOCS]

    jcfg = _paths(tmp_path / "jax", JaxConfig)
    jcfg.index_search_mode = "packed"
    jengine = JaxEngine(jcfg, encoder=jax_enc)
    try:
        jtitles, _ = _drive(JaxClient(jax_create_app(jcfg, engine=jengine)))
    finally:
        jengine.shutdown()
    assert titles == jtitles
