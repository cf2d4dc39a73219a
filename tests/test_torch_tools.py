"""The port's host tools and scale tools on the CPU, against tpu_rag's
scripts: make_demo_corpus, md_to_json and import_chat_history write the
same bytes; bench_http loads the port's server from its own process in its
three modes with the reference's report keys; bench_scale,
rehearse_scale and rehearse_host_ivf run end to end at a tiny size and
print the reference's keys; and the encoder at bge-base's head width (768
wide, 12 heads of 64) matches tpu_rag's on one shared param tree.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import scripts.import_chat_history as jax_chat
import scripts.make_demo_corpus as jax_demo
import scripts.md_to_json as jax_md
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag_torch.models.bert import BertSpec, params_from_flax
from tpu_rag_torch.models.biencoder import BiEncoder
from tpu_rag_torch.scripts import (bench_scale, import_chat_history, make_demo_corpus,
                                   md_to_json, rehearse_host_ivf, rehearse_scale)

REPO = Path(__file__).resolve().parent.parent
MD = "# Title Here\npreamble text\n\n## Section A\ncontent a\n\n## Section B\ncontent b"
CONV = {
    "title": "test conv", "id": "c1",
    "mapping": {
        "root": {"parent": None, "children": ["m1"], "message": None},
        "m1": {"parent": "root", "children": ["m2"],
               "message": {"author": {"role": "user"}, "content": {"parts": ["hello there"]}}},
        "m2": {"parent": "m1", "children": [],
               "message": {"author": {"role": "assistant"},
                           "content": {"parts": ["hi, how can I help?"]}}},
    },
}
JSONL = '{"role": "user", "content": "q1"}\n{"role": "assistant", "content": "a1"}\n'


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_make_demo_corpus_writes_the_reference_bytes(tmp_path, monkeypatch, capsys):
    make_demo_corpus.main(["--out", str(tmp_path / "port"), "--docs", "40"])
    monkeypatch.setattr(sys, "argv", ["x", "--out", str(tmp_path / "ref"), "--docs", "40"])
    jax_demo.main()
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert len(port) == 40 and port == ref
    # the checked-in demo documents are the generator's first 250
    shipped = REPO / "examples" / "docs" / "lore" / "demo-0000.json"
    assert port["lore/demo-0000.json"] == shipped.read_bytes()


def test_md_to_json_writes_the_reference_bytes(tmp_path, monkeypatch, capsys):
    src = tmp_path / "notes" / "t1.md"
    src.parent.mkdir()
    src.write_text(MD, encoding="utf-8")
    assert md_to_json.md_to_doc(MD, doc_id="t1", namespace="notes") == \
        jax_md.md_to_doc(MD, doc_id="t1", namespace="notes")
    for out, run in (("port", lambda argv: md_to_json.main(argv)),
                     ("ref", lambda argv: (monkeypatch.setattr(sys, "argv", ["x", *argv]),
                                           jax_md.main()))):
        (tmp_path / out).mkdir()
        run([str(src), "--out-dir", str(tmp_path / out), "--namespace-from-folder"])
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert json.loads((tmp_path / "port" / "t1.json").read_text())["namespace"] == "notes"


def test_import_chat_history_writes_the_reference_bytes(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_RAG_ENV_FILE", str(tmp_path / "none.env"))
    monkeypatch.setenv("DOCS_DIR", str(tmp_path / "docs"))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)   # the files' names
    assert import_chat_history.conversation_to_pairs(CONV) == \
        jax_chat.conversation_to_pairs(CONV) == [("hello there", "hi, how can I help?")]
    export = tmp_path / "conversations.json"
    export.write_text(json.dumps([CONV, {**CONV, "id": "c2", "title": "second"}]))
    hist = tmp_path / "hist.jsonl"
    hist.write_text(JSONL)
    for src in (export, hist):
        import_chat_history.main([str(src), "--yes", "--out-dir", str(tmp_path / "port")])
        monkeypatch.setattr(sys, "argv", ["x", str(src), "--yes", "--out-dir",
                                          str(tmp_path / "ref")])
        jax_chat.main()
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert len(port) == 3 and port == ref
    assert import_chat_history.conversation_to_pairs(
        import_chat_history.load_conversations(str(hist))[0]) == [("q1", "a1")]


@contextlib.contextmanager
def _port_server(tmp_path):
    """The port's app on the CPU (the tiny encoder, a few documents saved)
    behind its HTTP server on a free port; yields the base URL."""
    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import HTTPServer
    from tpu_rag_torch.config import Config

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = Config(persist_dir=str(tmp_path / "vs"), kb_db_path=str(tmp_path / "kb.sqlite3"),
                 db_path=str(tmp_path / "app.sqlite3"), docs_dir=str(tmp_path / "docs"),
                 device="cpu", embedding_model="tiny", model_priority=("extractive",),
                 summarize_mode="off", host="127.0.0.1", port=port)
    app = create_app(cfg)
    engine = app.state["engine"]
    engine.index.add([f"d{i}" for i in range(64)],
                     engine.embed([f"document {i} about topic {i % 7}" for i in range(64)]),
                     [f"document {i}" for i in range(64)], [{} for _ in range(64)])
    server = HTTPServer(app, cfg.host, cfg.port, executor_workers=16)
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
        engine.shutdown()
    assert not thread.is_alive()


def _load(argv: list[str]) -> dict:
    out = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bench_http_loads_the_port_server_in_its_own_process(tmp_path):
    with _port_server(tmp_path) as url:
        common = ["--base", url, "--concurrency", "4", "--duration", "1", "--warmup", "0.2"]
        runs = {mode: _load(["-m", "tpu_rag_torch.scripts.bench_http", "--mode", mode,
                             "--batch", "4", *common])
                for mode in ("single", "batched", "stub")}
        ref = _load([str(REPO / "scripts" / "bench_http.py"), "--mode", "single", *common])
    for mode, res in runs.items():
        assert res["mode"] == mode and res["requests_failed"] == 0, res
        assert res["requests_ok"] > 0 and res["qps"] > 0 and res["p50_ms"] is not None
        assert set(res) == set(ref)
    assert runs["batched"]["queries_ok"] == 4 * runs["batched"]["requests_ok"]


def _printed(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the keys tpu_rag's scripts print (scripts/bench_scale.py, rehearse_scale.py,
# rehearse_host_ivf.py), which need a TPU or its Pallas interpreter to run
SCALE_KEYS = {"config", "n", "d", "k", "qbatch", "dtype", "gen_seconds", "paths_ms",
              "paths_gbps", "paths_qps"}
IVF_KEYS = {"config", "n", "d", "nlist", "build_seconds", "nprobe_sweep"}
ENCODER_KEYS = {"config", "n", "model", "texts_per_second", "seconds", "dim"}
REHEARSE_KEYS = {"n", "model_shape", "real_rows", "backend", "dim", "encoder", "embed_real",
                 "ingest", "gt_seconds_host", "index_api", "http", "http_load",
                 "rss_gb_final"}
HOST_IVF_KEYS = {"n", "dim", "nlist", "backend", "hbm_note", "train_s", "build",
                 "gt_seconds_host", "serve", "rss_gb_final"}


@pytest.mark.parametrize("config", ["flat-1m-bf16", "flat-10m-int8", "ivf-1m-bf16",
                                    "encoder-minilm"])
def test_bench_scale_runs_on_the_cpu_with_the_reference_keys(config, capsys):
    bench_scale.main(["--config", config, "--n", "64" if "encoder" in config else "3000",
                      "--d", "64", "--iters", "2", "--device", "cpu"])
    got = _printed(capsys)
    want = IVF_KEYS if "ivf" in config else ENCODER_KEYS if "encoder" in config else SCALE_KEYS
    assert set(got) == want and got["config"] == config
    if "flat" in config:
        assert set(got["paths_ms"]) == set(bench_scale.PATHS.values())
        assert got["dtype"] == ("int8" if "int8" in config else "bfloat16")
    if "ivf" in config:
        assert got["nprobe_sweep"]["64"]["recall_at_10"] >= 0.8


def test_rehearse_scale_end_to_end_on_the_cpu(tmp_path, capsys):
    words = ("moon temple silver cliff dragon clan ember vale harbor bells glass desert "
             "iron pass salt marsh river stone fire ice").split()
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus.jsonl"
    with open(corpus, "w") as f:
        for i in range(300):
            f.write(json.dumps({"id": str(i), "query": " ".join(rng.choice(words, 5)),
                                "body": " ".join(rng.choice(words, 40))}) + "\n")
    rep = rehearse_scale.main(["--corpus", str(corpus), "--n", "3000", "--real", "300",
                               "--queries", "8", "--dim-model", "tiny", "--device", "cpu"])
    assert _printed(capsys) == rep
    assert set(rep) == REHEARSE_KEYS
    assert {"hidden", "layers", "seq_len"} <= set(rep["encoder"])
    assert rep["ingest"]["rows"] == 3000 and rep["http"]["queries"] == 8   # labeled queries
    assert rep["index_api"]["recall_at_10_vs_f32"] >= 0.9
    assert rep["http"]["recall_at_10_vs_f32"] >= 0.9
    assert rep["http_load"]["requests_failed"] == 0 and rep["http_load"]["qps"] > 0


def test_rehearse_host_ivf_truth_and_keys_on_the_cpu(capsys):
    args = rehearse_host_ivf.parser().parse_args([
        "--n", "6000", "--d", "32", "--nlist", "16", "--chunk", "2000", "--queries", "8",
        "--train-sample", "2048", "--device", "cpu"])
    rep, ivf, q, truth = rehearse_host_ivf.run(args)
    assert set(rep) == HOST_IVF_KEYS and len(rep["serve"]) == 6
    # the truth is the exact top 10 of the stored int8 rows
    live = ivf._row >= 0
    vals = np.concatenate([ivf._vec[live].astype(np.float32), *[v.astype(np.float32)
                                                               for v in ivf._ov_vec]])
    scales = np.concatenate([ivf._scale[live], *ivf._ov_scale])
    rows = np.concatenate([ivf._row[live], *ivf._ov_row])
    assert len(rows) == 6000
    scores = (q @ vals.T) * scales[None, :]
    for qi in range(len(q)):
        want = np.sort(scores[qi])[::-1][:10]
        got = scores[qi][[int(np.flatnonzero(rows == r)[0]) for r in truth[qi]]]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert min(r["recall_at_10"] for r in rep["serve"] if r["nprobe"] == 16 * 8) == 1.0
    rehearse_host_ivf.main(["--n", "3000", "--d", "32", "--nlist", "8", "--chunk", "1000",
                            "--train-sample", "1024", "--device", "cpu", "--skip-serve"])
    assert set(_printed(capsys)) == HOST_IVF_KEYS


def test_encoder_at_head_dim_64_matches_tpu_rag():
    """bge-base's attention geometry (768 wide, 12 heads of 64) in one layer,
    f32 on the CPU, on one param tree: T 128 takes the fused attention in
    both packages (tpu_rag's Pallas kernel in interpret mode, the port's
    plain version of #5).  Embeddings within 2e-5: f32 sums of 768- and
    3,072-long products in another order, on unit vectors."""
    spec_kw = dict(vocab_size=1024, hidden=768, layers=1, heads=12, ffn=3072, max_len=512)
    jax_enc = JaxBiEncoder("bge-parity", spec=JaxSpec(**spec_kw), seq_len=128, batch=8)
    params = jax.tree_util.tree_map(np.asarray, jax_enc.params)
    enc = BiEncoder("bge-parity", spec=BertSpec(**spec_kw), seq_len=128, batch=8,
                    device="cpu", state_dict=params_from_flax(params))
    assert enc.spec.hidden // enc.spec.heads == 64
    texts = ["the moon temple on the silver cliff",
             " ".join(f"word{i}" for i in range(100)),             # T 128: fused attention
             " ".join(f"rune{i} of the old tongue" for i in range(30)), "月之神殿"]
    want, got = jax_enc.embed(texts), enc.embed(texts)
    assert got.shape == (4, 768)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
