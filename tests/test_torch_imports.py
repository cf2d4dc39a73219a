"""tpu_rag_torch imports nothing of JAX or of tpu_rag, and needs neither
requests, transformers nor safetensors (the machine with the card has none
of them) to import every module and serve /compose on the extractive
backend and /search with rerank; asking for CUDA without a card raises
instead of falling back to the CPU."""

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

bad = [k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in %r]
assert not bad, bad
print(len(names))
""" % (_BLOCKED, _BLOCKED)


def test_every_module_imports_with_jax_and_tpu_rag_blocked():
    # a subprocess: this test process has already imported jax (conftest)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 63   # every module of the package


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
