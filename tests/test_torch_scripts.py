"""The port's offline entry points (python -m tpu_rag_torch.scripts.<tool>)
against tpu_rag's scripts on the CPU: build_index + query_local,
ingest_docs, bulk_import, rag_ask against the port's HTTP server,
eval_recall --synthetic and prove_checkpoint.

Parity goes through one HF checkpoint (the "tiny" geometry: vocab 1024,
hidden 64, 2 layers) that both packages load through EMBEDDING_WEIGHTS, at
INDEX_DTYPE=float32 (tpu_rag with USE_PALLAS=false): the same hit ids, and
scores within 2e-4.
"""

import contextlib
import json
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import scripts.build_index as jax_build_index
import scripts.bulk_import as jax_bulk_import
import scripts.eval_recall as jax_eval_recall
import scripts.ingest_docs as jax_ingest_docs
import scripts.prove_checkpoint as jax_prove_checkpoint
import scripts.query_local as jax_query_local
import scripts.rag_ask as jax_rag_ask
from tpu_rag_torch.models.biencoder import MODEL_SPECS, init_params
from tpu_rag_torch.models.hf_export import save_bert
from tpu_rag_torch.scripts import (build_index, bulk_import, eval_recall, ingest_docs,
                                   prove_checkpoint, query_local, rag_ask)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """tests/test_scripts.py's environment, plus DEVICE=cpu and the tiny HF
    checkpoint as EMBEDDING_WEIGHTS."""
    ckpt = tmp_path / "tiny-ckpt"
    save_bert(init_params(MODEL_SPECS["tiny"], 7), MODEL_SPECS["tiny"], ckpt)
    monkeypatch.setenv("KB_DB_PATH", str(tmp_path / "db/kb.sqlite3"))
    monkeypatch.setenv("DB_PATH", str(tmp_path / "db/app.sqlite3"))
    monkeypatch.setenv("DOCS_DIR", str(tmp_path / "docs"))
    monkeypatch.setenv("EMBEDDING_MODEL", "tiny")
    monkeypatch.setenv("EMBEDDING_WEIGHTS", str(ckpt))
    monkeypatch.setenv("INDEX_DTYPE", "float32")
    monkeypatch.setenv("USE_PALLAS", "false")
    monkeypatch.setenv("EMBED_SEQ_LEN", "64")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("MODEL_PRIORITY", "extractive")
    monkeypatch.setenv("SUMMARIZE_MODE", "off")
    monkeypatch.setenv("TPU_RAG_ENV_FILE", str(tmp_path / "nonexistent.env"))
    docs = tmp_path / "docs" / "lore"
    docs.mkdir(parents=True)
    (docs / "temple.json").write_text(json.dumps({
        "id": "temple", "title": "Moon Temple", "summary": "a temple on a cliff",
        "body": {"location": "stands on the silver cliff above the bay",
                 "rituals": ["dusk chant", "tide offering"]},
    }), encoding="utf-8")
    (docs / "dragon.json").write_text(json.dumps([{
        "id": "dragon", "title": "Dragon", "summary": "fire dragon",
        "body": "dragons breathe fire in the mountains",
    }]), encoding="utf-8")
    return tmp_path


def _use_store(monkeypatch, env, package: str) -> None:
    """Each package builds and reads its own store."""
    monkeypatch.setenv("PERSIST_DIR", str(env / f"vs_{package}"))
    monkeypatch.setenv("KB_DB_PATH", str(env / f"db_{package}/kb.sqlite3"))
    monkeypatch.setenv("DB_PATH", str(env / f"db_{package}/app.sqlite3"))


def _run_jax(monkeypatch, module, argv: list[str]):
    monkeypatch.setattr(sys, "argv", argv)
    return module.main()


def _hits(out: str) -> list[tuple[str, float]]:
    return [(h["id"], h["score"]) for h in json.loads(out)["hits"]]


def _same_hits(got, want) -> None:
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=2e-4)


def test_build_index_and_query_local_match_tpu_rag(env, monkeypatch, capsys):
    _use_store(monkeypatch, env, "port")
    build_index.main([])
    out = capsys.readouterr().out
    assert "Indexed logical documents: 2" in out
    assert "5/5 chunks" in out            # temple: summary + 2 sections; dragon: 2
    query_local.main(["silver cliff bay", "--k", "3", "--json"])
    got = capsys.readouterr().out
    data = json.loads(got)
    assert len(data["hits"]) == 3
    assert any(h["id"].startswith("temple::") for h in data["hits"])
    assert data["hits"][0]["metadata"]["namespace"] == "lore"
    query_local.main(["silver cliff bay", "--k", "2"])
    pretty = capsys.readouterr().out
    assert pretty.startswith("#1  score=") and "ns=lore" in pretty

    _use_store(monkeypatch, env, "jax")
    _run_jax(monkeypatch, jax_build_index, ["build_index.py"])
    assert "Indexed logical documents: 2" in capsys.readouterr().out
    _run_jax(monkeypatch, jax_query_local, ["query_local.py", "silver cliff bay", "--k", "3",
                                            "--json"])
    _same_hits(_hits(got), _hits(capsys.readouterr().out))


def test_ingest_docs_matches_tpu_rag(env, monkeypatch, capsys):
    _use_store(monkeypatch, env, "port")
    ingest_docs.main([])
    out = capsys.readouterr().out
    assert "Done: 2 docs." in out and "[ADD] temple" in out
    query_local.main(["silver cliff", "--k", "2", "--json"])
    got = capsys.readouterr().out
    assert {h["id"] for h in json.loads(got)["hits"]} == {"temple", "dragon"}

    _use_store(monkeypatch, env, "jax")
    _run_jax(monkeypatch, jax_ingest_docs, ["ingest_docs.py"])
    assert sorted(capsys.readouterr().out.splitlines()) == sorted(out.splitlines())
    _run_jax(monkeypatch, jax_query_local, ["query_local.py", "silver cliff", "--k", "2",
                                            "--json"])
    _same_hits(_hits(got), _hits(capsys.readouterr().out))


def test_bulk_import_matches_tpu_rag(env, monkeypatch, capsys):
    temple = str(env / "docs" / "lore" / "temple.json")
    _use_store(monkeypatch, env, "port")
    bulk_import.main([temple, str(env / "docs")])
    out = capsys.readouterr().out
    assert "[UPSERT] temple (3 chunks)" in out and "[UPSERT] dragon (2 chunks)" in out
    assert "Done. Upserted 3 documents." in out       # temple twice: an upsert
    query_local.main(["dragons breathe fire", "--k", "5", "--json"])
    got = capsys.readouterr().out
    assert len(json.loads(got)["hits"]) == 5          # 5 distinct chunks

    _use_store(monkeypatch, env, "jax")
    _run_jax(monkeypatch, jax_bulk_import, ["bulk_import.py", temple, str(env / "docs")])
    assert sorted(capsys.readouterr().out.splitlines()) == sorted(out.splitlines())
    _run_jax(monkeypatch, jax_query_local, ["query_local.py", "dragons breathe fire", "--k",
                                            "5", "--json"])
    _same_hits(_hits(got), _hits(capsys.readouterr().out))


@contextlib.contextmanager
def _port_server():
    """The port's app (config from the environment) behind its HTTP server
    on a free port; yields the base URL."""
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer
    from tpu_rag_torch.config import config_from_env

    cfg = config_from_env()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cfg.host, cfg.port = "127.0.0.1", s.getsockname()[1]
    app = create_app(cfg)
    server = HTTPServer(app, cfg.host, cfg.port, executor_workers=2)
    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    url = f"http://{cfg.host}:{cfg.port}"
    try:
        deadline = time.time() + 30
        while True:
            try:
                urllib.request.urlopen(url + "/health", timeout=5).read()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        yield url
    finally:
        server.stop()
        thread.join(timeout=30)
        app.state["engine"].shutdown()
    assert not thread.is_alive()


def test_rag_ask_against_the_port_server_matches_tpu_rags_client(env, monkeypatch, capsys):
    """The port's client (urllib) and tpu_rag's (requests) ask the port's
    server on the extractive backend: the same answer, sources and engine."""
    _use_store(monkeypatch, env, "port")
    build_index.main([])
    capsys.readouterr()
    with _port_server() as url:
        argv = ["where does the moon temple stand?", "--api", url, "--k", "3",
                "--engine", "extractive"]
        rag_ask.main(argv)
        got = capsys.readouterr().out
        _run_jax(monkeypatch, jax_rag_ask, ["rag_ask.py", *argv])
        want = capsys.readouterr().out
        rag_ask.main(["zzqx", "--api", url, "--namespace", "missing"])
        assert capsys.readouterr().out.strip() == "(no hits)"
    assert got == want
    answer, sources = got.split("\n--- sources ---\n")
    assert answer.strip() and sources.strip().endswith("(engine: extractive)")
    assert "[lore/temple.json#location]" in sources


def _json_lines(out: str) -> dict[str, dict]:
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return {r["config"]: r for r in rows}


def test_eval_recall_synthetic_matches_tpu_rag(monkeypatch, capsys):
    """3,000 synthetic rows, 8 queries: bf16, int8 and bucketed recall as
    tpu_rag's (its Pallas scans in interpret mode); IVF (k-means init
    cannot be redrawn) at least 0.8."""
    argv = ["--synthetic", "3000", "--queries", "8", "--configs", "bf16,int8,bucketed,ivf"]
    eval_recall.main([*argv, "--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)
    _run_jax(monkeypatch, jax_eval_recall, ["eval_recall.py", *argv])
    want = _json_lines(capsys.readouterr().out)
    assert set(got) == set(want) == {"bf16", "int8", "bucketed", "ivf"}
    for cfg in ("bf16", "int8", "bucketed"):
        assert got[cfg].pop("truth") == "exact_f32_plain"
        assert got[cfg] == want[cfg], cfg
    assert got["ivf"]["recall_at_k"] >= 0.8 and want["ivf"]["recall_at_k"] >= 0.8
    assert got["ivf"]["bytes_per_vector"] == want["ivf"]["bytes_per_vector"]


def test_prove_checkpoint_matches_tpu_rag(tmp_path, monkeypatch, capsys):
    """tests/test_scripts.py's turnkey proof with tiny random transformers
    checkpoints (a BertModel and a 1-label BertForSequenceClassification):
    the torch-parity gate runs and passes, the bundled recall and rerank
    scores are tpu_rag's (recall equal, scores within 2e-3)."""
    transformers = pytest.importorskip("transformers")
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    emb_dir, ce_dir = tmp_path / "minilm-tiny", tmp_path / "ce-tiny"
    transformers.BertModel(transformers.BertConfig(**cfg)).eval().save_pretrained(
        str(emb_dir), safe_serialization=False)
    transformers.BertForSequenceClassification(
        transformers.BertConfig(**cfg, num_labels=1)).eval().save_pretrained(
        str(ce_dir), safe_serialization=False)
    argv = ["--embedding-weights", str(emb_dir), "--rerank-weights", str(ce_dir),
            "--max-docs", "24", "--k", "5"]
    rc = prove_checkpoint.main([*argv, "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want_rc = _run_jax(monkeypatch, jax_prove_checkpoint, ["prove_checkpoint.py", *argv])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["torch_parity"]["ok"] and report["torch_parity"]["max_abs_diff"] < 2e-3
    br, wbr = report["bundled_recall_at_k"], want["bundled_recall_at_k"]
    assert br["docs"] == wbr["docs"] > 0 and br["recall_vs_f32"] >= 0.98
    assert br == wbr
    for key in ("pos_score", "neg_score"):
        assert abs(report["rerank"][key] - want["rerank"][key]) <= 2e-3, key
    assert report["rerank"]["ok"] == want["rerank"]["ok"]
    assert rc == want_rc == (0 if report["passed"] else 1)


def test_prove_checkpoint_without_transformers_skips_the_parity_gate(tmp_path, monkeypatch,
                                                                     capsys):
    """The card's machine has no transformers: the gate reports "skipped",
    as tpu_rag's does, and the run still gates on the bundled recall."""
    ckpt = tmp_path / "ckpt"
    save_bert(init_params(MODEL_SPECS["tiny"], 3), MODEL_SPECS["tiny"], ckpt)
    monkeypatch.setitem(sys.modules, "transformers", None)
    rc = prove_checkpoint.main(["--embedding-weights", str(ckpt), "--max-docs", "32",
                                "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "skipped" in report["torch_parity"]
    assert report["bundled_recall_at_k"]["ok"] and report["passed"] and rc == 0


def test_entry_points_default_to_cuda(env, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    monkeypatch.delenv("DEVICE")
    _use_store(monkeypatch, env, "cuda")
    for main, argv in ((build_index.main, []), (ingest_docs.main, []),
                       (bulk_import.main, []), (query_local.main, ["q"]),
                       (eval_recall.main, ["--synthetic", "300"]),
                       (prove_checkpoint.main, ["--embedding-weights", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert not (env / "vs_cuda").exists()
