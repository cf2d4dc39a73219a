"""The port's /search rerank and compose/chat routes against tpu_rag's app.

Both apps get the same documents, the same hash-embedding encoder, the same
fake cross-encoder and the same scripted (or extractive) LLM backend; the
cases are tests/test_api.py's rerank and compose cases.  Where the replies
are deterministic they must be equal once the random document ids and the
timestamps are normalised away and floats rounded to 4 decimals.  One
divergence is pinned by name: a cross-encoder that fails gives
`reranked: false` plus `rerank_error` in the port, where tpu_rag answers
`reranked: true` with the hits unreranked.
"""

import hashlib
import json

import numpy as np
import pytest

from tpu_rag.api.app import create_app as jax_create_app
from tpu_rag.api.testclient import TestClient as JaxClient
from tpu_rag.config import Config as JaxConfig
from tpu_rag.engine import RagEngine as JaxEngine
from tpu_rag.llm import LLMDispatcher as JaxDispatcher
from tpu_rag_torch.api.app import create_app
from tpu_rag_torch.api.testclient import TestClient
from tpu_rag_torch.config import Config
from tpu_rag_torch.engine import RagEngine
from tpu_rag_torch.llm import LLMDispatcher
from tpu_rag_torch.models.crossencoder import CrossEncoder

DIM = 32
_VOLATILE = {"updated_ts", "last_ts", "ts", "timings_ms", "file", "path"}


class FakeEncoder:
    """Deterministic hash embeddings (tests/test_api.py's fake)."""

    dim = DIM

    def embed(self, texts):
        out = np.zeros((len(texts), DIM), np.float32)
        for i, t in enumerate(texts):
            for tok in t.lower().split():
                h = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=4).digest(), "little")
                out[i, h % DIM] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


class FakeCrossEncoder:
    def predict(self, pairs):
        return np.array([float(len(set(q.lower().split()) & set(t.lower().split())))
                         for q, t in pairs], np.float32)


class FailingCrossEncoder:
    def predict(self, pairs):
        raise RuntimeError("kernel launch failed")


class ScriptedBackend:
    name = "scripted"

    def __init__(self, tokens=None, text="scripted answer"):
        self.tokens = tokens
        self.text = text

    def complete(self, messages, **kw):
        return self.text

    def stream(self, messages, **kw):
        yield from self.tokens or [self.text]


class ScriptedDispatcher:
    def __init__(self, backend):
        self.backend = backend

    def generate(self, messages, *, stream=False, engine=None, **kw):
        if stream:
            return self.backend.stream(messages), self.backend.name
        return self.backend.complete(messages), self.backend.name


class Side:
    """One app (the port's or tpu_rag's), its client and the ids it saved."""

    def __init__(self, engine, client):
        self.engine, self.client, self.ids = engine, client, []

    def save(self, title, content, **meta):
        r = self.client.post("/docs/save", json={"title": title, "content": content,
                                                 "metadata": meta})
        assert r.status_code == 200, r.text
        self.ids.append(r.json()["id"])

    def norm(self, obj):
        """obj with this side's doc ids replaced by their save order, the
        volatile keys dropped, auto thread ids masked and floats rounded."""
        s = json.dumps(obj, ensure_ascii=False)
        for i, doc_id in enumerate(self.ids):
            s = s.replace(doc_id, f"<doc{i}>")
        return _strip(json.loads(s))


def _strip(o):
    if isinstance(o, dict):
        return {k: _strip(v) for k, v in o.items() if k not in _VOLATILE}
    if isinstance(o, list):
        return [_strip(v) for v in o]
    if isinstance(o, float):
        return round(o, 4)
    if isinstance(o, str) and o.startswith("auto-"):      # a time-stamped thread id
        return "auto-<ms>"
    return o


def _sides(tmp_path, cross_encoder=None, dispatcher=None, **cfg_kw):
    """[port, tpu_rag] apps over their own stores with the same fakes."""
    out = []
    for tag, cfg_cls, engine_cls, app_fn, client_cls, extra in (
            ("port", Config, RagEngine, create_app, TestClient, {"device": "cpu"}),
            ("jax", JaxConfig, JaxEngine, jax_create_app, JaxClient, {"use_pallas": False})):
        root = tmp_path / tag
        kw = {"index_dtype": "float32", "summarize_mode": "off", **extra, **cfg_kw}
        cfg = cfg_cls(persist_dir=str(root / "vs"), kb_db_path=str(root / "db/kb.sqlite3"),
                      db_path=str(root / "db/app.sqlite3"), docs_dir=str(root / "docs"),
                      **kw)
        disp = dispatcher(tag) if dispatcher else ScriptedDispatcher(ScriptedBackend())
        engine = engine_cls(cfg, encoder=FakeEncoder(),
                            cross_encoder=cross_encoder or FakeCrossEncoder(),
                            dispatcher=disp)
        out.append(Side(engine, client_cls(app_fn(engine=engine))))
    yield out
    for side in out:
        side.engine.shutdown()


@pytest.fixture()
def sides(tmp_path):
    yield from _sides(tmp_path)


def _both(sides, method, path, **kw):
    """The normalised reply of each side to the same request."""
    outs = []
    for side in sides:
        r = getattr(side.client, method)(path, **kw)
        assert r.status_code == 200, r.text
        outs.append(side.norm(r.json()))
    return outs


def _events(side, body):
    """The SSE events of /compose_stream, runs of text (or reasoning) events
    joined into one, so that an id split across two chunks is normalised."""
    r = side.client.post("/compose_stream", json=body)
    frames = "".join(r.iter_stream())
    events = []
    for block in frames.split("\n\n"):
        if block.startswith("data: "):
            evt = json.loads(block[6:])
            if events and evt.get("type") and events[-1].get("type") == evt["type"]:
                events[-1]["data"] += evt["data"]
            else:
                events.append(evt)
        elif block.startswith("event: done"):
            events.append({"done": True})
    return side.norm(events)


def test_search_rerank_matches_tpu_rag(sides):
    for side in sides:
        side.save("A", "the dragon guards treasure")
        side.save("B", "a knight rides north. the dragon sleeps.")
        side.save("C", "dragon treasure maps of the north")
    port, ref = _both(sides, "post", "/search",
                      json={"query": "dragon treasure", "k": 5, "rerank": True,
                            "highlight": True})
    assert port["reranked"] is True and "rerank_error" not in port
    assert all("rerank_score" in h for h in port["hits"])
    scores = [h["rerank_score"] for h in port["hits"]]
    assert scores == sorted(scores, reverse=True)
    assert port == ref


def test_rerank_candidates_depth_matches_tpu_rag(tmp_path):
    """RERANK_CANDIDATES: the cross-encoder sees that many vector candidates
    and the reply is cut back to k; with 0 it sees what /search returns."""
    for cands, lo, hi in ((30, 30, 99), (0, 0, 4)):
        gen = _sides(tmp_path / str(cands), rerank_candidates=cands)
        sides = next(gen)
        seen = []
        for side in sides:
            for i in range(40):
                side.save(f"d{i}", f"topic shard number alpha{i}")
            orig = side.engine.rerank
            side.engine.rerank = (lambda q, hits, orig=orig:
                                  seen.append(len(hits)) or orig(q, hits))
        port, ref = _both(sides, "post", "/search",
                          json={"query": "topic shard", "k": 3, "rerank": True})
        assert port == ref and port["reranked"] and len(port["hits"]) == 3
        assert seen[0] == seen[1] and lo <= seen[0] <= hi
        next(gen, None)


def test_failed_rerank_reports_an_error_where_tpu_rag_reports_success(tmp_path):
    """Divergence: tpu_rag swallows a failing cross-encoder and answers
    reranked: true with the hits unreranked; the port answers reranked:
    false with rerank_error, the hits in retriever order."""
    gen = _sides(tmp_path, cross_encoder=FailingCrossEncoder())
    sides = next(gen)
    for side in sides:
        side.save("A", "the dragon guards treasure")
        side.save("B", "a knight rides north. the dragon sleeps.")
    plain, _ = _both(sides, "post", "/search", json={"query": "dragon", "k": 5})
    port, ref = _both(sides, "post", "/search", json={"query": "dragon", "k": 5,
                                                      "rerank": True})
    assert ref["reranked"] is True and "rerank_error" not in ref
    assert port["reranked"] is False and port["rerank_error"] == "kernel launch failed"
    assert [h["id"] for h in port["hits"]] == [h["id"] for h in plain["hits"]]
    assert not any("rerank_score" in h for h in port["hits"])
    next(gen, None)


def test_lazy_cross_encoder_is_built_once_and_its_errors_surface(tmp_path):
    cfg = Config(persist_dir=str(tmp_path / "vs"), kb_db_path=str(tmp_path / "kb.sqlite3"),
                 db_path=str(tmp_path / "app.sqlite3"), docs_dir=str(tmp_path / "docs"),
                 index_dtype="float32", device="cpu", rerank_model="tiny")
    engine = RagEngine(cfg, encoder=FakeEncoder())
    try:
        ce = engine.get_cross_encoder()
        assert isinstance(ce, CrossEncoder) and engine.get_cross_encoder() is ce
        assert ce.device.type == "cpu" and ce.seq_len == 128
        assert engine.warmup(rerank=True) >= 0.0
        # an orbax directory cannot be read: every rerank reports it
        orbax = tmp_path / "ckpt"
        orbax.mkdir()
        (orbax / "_CHECKPOINT_METADATA").write_text("{}")
        engine._cross_encoder = None
        cfg.rerank_weights = str(orbax)
        client = TestClient(create_app(engine=engine))
        client.post("/docs/save", json={"title": "A", "content": "the dragon"})
        for _ in range(2):
            out = client.post("/search", json={"query": "dragon", "k": 3,
                                               "rerank": True}).json()
            assert out["reranked"] is False and "orbax" in out["rerank_error"]
            assert out["hits"]
    finally:
        engine.shutdown()


def test_warmup_with_rerank_matches_tpu_rag(sides):
    for side in sides:
        assert side.engine.warmup(rerank=True) >= 0.0


def test_compose_blocking_matches_tpu_rag(sides):
    for side in sides:
        side.save("Moon Temple", "the moon temple stands on the silver cliff")
    port, ref = _both(sides, "post", "/compose",
                      json={"query": "moon temple", "k": 3, "language": "en",
                            "thread_id": "t1"})
    assert port == ref
    assert port["draft"] == "scripted answer" and port["thread_id"] == "t1"
    assert port["citations"][0]["id"] == "<doc0>"
    assert set(port["citations"][0]) == {"id", "file_path", "section"}
    msgs, msgs_ref = _both(sides, "get", "/threads/t1/messages")
    assert msgs == msgs_ref
    assert [m["role"] for m in msgs["messages"]] == ["user", "assistant"]
    threads, threads_ref = _both(sides, "get", "/threads")
    assert threads == threads_ref == {"threads": [{"thread_id": "t1", "count": 2}]}


def test_compose_no_hits_note_matches_tpu_rag(sides):
    port, ref = _both(sides, "post", "/compose", json={"query": "zzzz unknown", "k": 3})
    assert port == ref and port["draft"] == "" and port["note"]


def test_compose_stream_sse_with_think_matches_tpu_rag(tmp_path):
    tokens = ["<th", "ink>I reason", " secretly</think>", "Visible ", "answer"]
    gen = _sides(tmp_path,
                 dispatcher=lambda _tag: ScriptedDispatcher(ScriptedBackend(tokens=tokens)))
    sides = next(gen)
    for side in sides:
        side.save("Star Map", "stars map the northern sky")
    body = {"query": "stars map", "k": 3, "language": "en", "thread_id": "s1"}
    port, ref = (_events(side, body) for side in sides)
    assert port == ref
    assert "".join(e["data"] for e in port if e.get("type") == "reasoning") == \
        "I reason secretly"
    assert "".join(e["data"] for e in port if e.get("type") == "text") == "Visible answer"
    tail = [e for e in port if "citations" in e]
    assert tail and tail[0]["thread_id"] == "s1" and port[-1] == {"done": True}
    msgs, _ = _both(sides, "get", "/threads/s1/messages")
    assert msgs["messages"][-1]["content"] == "Visible answer"
    next(gen, None)


def test_compose_selected_ids_match_tpu_rag(sides):
    for side in sides:
        side.save("One", "alpha beta")
        side.save("Two", "alpha gamma")
    body = {"query": "alpha", "k": 5, "selected_ids": ["nonexistent-id"]}
    port, ref = (_events(side, body) for side in sides)
    assert port == ref
    assert [e for e in port if "citations" in e][0]["citations"] == []
    port, ref = _both(sides, "post", "/compose", json=body)
    assert port == ref and port["citations"] == [] and port["draft"] == ""
    # selecting a saved id keeps just that source
    port, ref = ([s.norm(s.client.post("/compose", json={
        "query": "alpha", "k": 5, "selected_ids": [s.ids[1]]}).json())] for s in sides)
    assert port == ref and [c["id"] for c in port[0]["citations"]] == ["<doc1>"]


def test_compose_extra_context_matches_tpu_rag(sides):
    captured = []
    for side in sides:
        side.save("X", "xylophone zebra facts")
        orig = side.engine.prepare_messages

        def spy(query, context, *a, orig=orig, side=side, **kw):
            captured.append(side.norm(context))
            return orig(query, context, *a, **kw)

        side.engine.prepare_messages = spy
    port, ref = _both(sides, "post", "/compose",
                      json={"query": "xylophone zebra", "k": 2,
                            "extra_context": "[snip-1] the zebra plays at dusk"})
    assert port == ref
    assert captured[0] == captured[1]
    assert "<<<CLIENT_SNIPPETS>>>" in captured[0] and "plays at dusk" in captured[0]


def test_compose_stream_init_error_matches_tpu_rag(sides, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("search exploded")

    frames = []
    for side in sides:
        monkeypatch.setattr(side.engine, "search_internal", boom)
        r = side.client.post("/compose_stream", json={"query": "anything", "k": 3})
        frames.append("".join(r.iter_stream()))
    assert frames[0] == frames[1]
    assert "[compose_stream init error] search exploded" in frames[0]


def test_compose_on_the_extractive_backend_matches_tpu_rag(tmp_path):
    """The offline backend through the real dispatcher, with per-chunk and
    history summaries (SUMMARIZE_MODE=llm) over two turns of one thread."""
    gen = _sides(tmp_path, summarize_mode="llm", model_priority=("extractive",),
                 dispatcher=lambda tag: None)
    sides = next(gen)
    assert isinstance(sides[0].engine.dispatcher, LLMDispatcher)
    assert isinstance(sides[1].engine.dispatcher, JaxDispatcher)
    for side in sides:
        side.save("Star Atlas", "the atlas charts every northern star")
        side.save("Tide Table", "the tide table lists the harbor hours")
    for q in ("northern star atlas", "northern star atlas again"):
        port, ref = _both(sides, "post", "/compose",
                          json={"query": q, "k": 2, "thread_id": "s", "language": "en"})
        assert port == ref and port["engine"] == "extractive"
        assert "[<doc0>]" in port["draft"]
    body = {"query": "tide hours", "k": 2, "thread_id": "s", "language": "en",
            "engine": "extractive"}
    port, ref = (_events(side, body) for side in sides)
    assert port == ref and port[-1] == {"done": True}
    assert "[<doc1>]" in "".join(e["data"] for e in port if e.get("type") == "text")
    summaries = [s.norm(s.engine.db.get_summary("s")) for s in sides]
    assert summaries[0] and summaries[0] == summaries[1]
    next(gen, None)
