"""tpu_rag_torch imports nothing of JAX or of tpu_rag, and needs neither
requests, transformers nor safetensors (the machine with the card has none
of them) to import every module, serve /compose on the extractive backend
and /search with rerank, and run `python -m tpu_rag_torch.scripts.<tool>
--help` for every entry point (the native/ and baseline/ modules included,
which tokenize and search in C++ built at first use), search the sharded
indexes of parallel/ and embed over its tensor-parallel mesh; asking for
CUDA without a card raises instead of falling back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_rag", "requests",
            "transformers", "safetensors")

_IMPORT_ALL = """
import sys, tempfile
for name in %r:
    sys.modules[name] = None          # any import of them raises
import importlib, pkgutil
import tpu_rag_torch
names = sorted(m.name for m in pkgutil.walk_packages(tpu_rag_torch.__path__, "tpu_rag_torch."))
for name in names:
    importlib.import_module(name)

from tpu_rag_torch.api.app import create_app
from tpu_rag_torch.api.testclient import TestClient
from tpu_rag_torch.config import Config
d = tempfile.mkdtemp()
cfg = Config(persist_dir=d + "/vs", kb_db_path=d + "/kb.sqlite3", db_path=d + "/app.sqlite3",
             docs_dir=d + "/docs", device="cpu", embedding_model="tiny",
             rerank_model="tiny", model_priority=("ollama", "openai", "extractive"),
             summarize_mode="off")
client = TestClient(create_app(cfg))
client.post("/docs/save", json={"title": "Moon", "content": "the moon temple"})
out = client.post("/compose", json={"query": "moon temple", "k": 2}).json()
assert out["engine"] == "extractive" and out["draft"], out
out = client.post("/search", json={"query": "moon temple", "k": 2, "rerank": True}).json()
assert out["reranked"] is True and "rerank_score" in out["hits"][0], out
client.app.state["engine"].shutdown()

import numpy as np
from tpu_rag_torch.baseline import CpuHnswIndex
from tpu_rag_torch.models.tokenizer import WordPieceTokenizer
assert WordPieceTokenizer("examples/vocab.txt").backend == "native"
hnsw = CpuHnswIndex(8, 8)
hnsw.add(np.eye(8, dtype=np.float32))
assert hnsw.search(np.eye(8, dtype=np.float32)[3:4], 1)[0].tolist() == [[3]]

from tpu_rag_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, mesh_from_spec
from tpu_rag_torch.parallel.distributed import maybe_init_distributed
rows = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)
for cls in (ShardedFlatIndex, ShardedIVFIndex):
    sharded = cls(16, mesh=mesh_from_spec("data:2", ["cpu"] * 2))
    sharded.add([f"r{i}" for i in range(600)], rows)
    assert sharded.search(rows[7], 1).ids == [["r7"]]
assert maybe_init_distributed(device="cpu") is False

from tpu_rag_torch.models.biencoder import BiEncoder
from tpu_rag_torch.parallel.tensor import shard_state_dict
tp = BiEncoder("tiny", device="cpu", mesh=mesh_from_spec("data:2,model:2", ["cpu"] * 4))
assert len(shard_state_dict(tp.module.state_dict(), tp.spec, 2)) == 2
assert tp.embed(["the moon temple"]).shape == (1, 64)

import runpy
for tool in ("train_semantic", "train_reranker", "build_index", "ingest_docs", "bulk_import",
             "query_local", "rag_ask", "eval_recall", "prove_checkpoint", "bench_http",
             "bench_scale", "rehearse_scale", "rehearse_host_ivf", "rehearse_100m",
             "make_demo_corpus", "md_to_json", "import_chat_history"):
    sys.argv = [tool, "--help"]
    try:
        runpy.run_module("tpu_rag_torch.scripts." + tool, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (tool, e.code)

bad = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in %r]
assert not bad, bad
print(len(names))
""" % (_BLOCKED, _BLOCKED)


def test_every_module_imports_with_jax_and_tpu_rag_blocked():
    # a subprocess: this test process has already imported jax (conftest)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--corpus" in out.stdout          # train_semantic --help ran
    assert "--biencoder" in out.stdout and "--embedding-weights" in out.stdout
    assert "--synthetic" in out.stdout and "--api" in out.stdout
    assert "--concurrency" in out.stdout and "--dim-model" in out.stdout   # the scale tools
    assert "--shards" in out.stdout                          # rehearse_100m
    assert int(out.stdout.strip().splitlines()[-1]) >= 98   # every module of the package


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    from tpu_rag_torch.config import Config
    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.index.flat import FlatIndex

    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FlatIndex(16)                       # default device: cuda
    cfg = Config(persist_dir=str(tmp_path / "vs"), db_path=str(tmp_path / "db" / "a.sqlite3"),
                 kb_db_path=str(tmp_path / "db" / "kb.sqlite3"), docs_dir=str(tmp_path / "docs"))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        RagEngine(cfg)
    assert not (tmp_path / "vs").exists()   # raised before touching anything
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")
