"""The port's cross-encoder and rerank against tpu_rag's and HF's on the CPU.

A tiny random HF BertForSequenceClassification (vocab 128, hidden 32, 2
layers, 4 heads) saved both ways gives port logits within 2e-4 of
transformers and of tpu_rag's CrossEncoderModule, at T 16 (plain attention
in both packages) and at T 128 (the port's fused attention in its plain
version, the JAX module with flash=True, its Pallas kernel in interpret
mode).  CrossEncoder.predict agrees with tpu_rag's within 2e-4 with the
params carried across, and rerank_hits gives the same hits in all three
modes.  Two divergences are pinned by name: a failing predict raises, and
the quality gate reads the serving alpha's row of rerank.json.
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transformers

from tpu_rag.config import Config as JaxConfig
from tpu_rag.engine import RagEngine as JaxEngine
from tpu_rag.models import hf_import as jax_hf
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.crossencoder import CrossEncoder as JaxCrossEncoder
from tpu_rag.models.crossencoder import CrossEncoderModule as JaxCEModule
from tpu_rag.retrieval.rerank import rerank_hits as jax_rerank_hits
from tpu_rag_torch.config import Config
from tpu_rag_torch.engine import RagEngine
from tpu_rag_torch.models import hf_import
from tpu_rag_torch.models.bert import BertSpec
from tpu_rag_torch.models.crossencoder import (CrossEncoder, CrossEncoderModule,
                                               cross_encoder_params_from_flax)
from tpu_rag_torch.retrieval.rerank import rerank_hits

TINY = dict(vocab_size=128, hidden=32, layers=2, heads=4, ffn=64, max_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hf_ce(tmp_path_factory):
    """A tiny random BertForSequenceClassification (1 label) saved both ways:
    (model, {format: dir})."""
    cfg = transformers.BertConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden"],
        num_hidden_layers=TINY["layers"], num_attention_heads=TINY["heads"],
        intermediate_size=TINY["ffn"], max_position_embeddings=TINY["max_len"],
        hidden_act="gelu", num_labels=1)
    torch.manual_seed(5)
    model = transformers.BertForSequenceClassification(cfg).eval()
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"ce_{fmt}")
        model.save_pretrained(d, safe_serialization=safe)
        dirs[fmt] = d
    return model, dirs


class FakeCrossEncoder:
    """Token overlap as the score (tests/test_api.py's fake)."""

    def predict(self, pairs):
        return np.array([float(len(set(q.lower().split()) & set(t.lower().split())))
                         for q, t in pairs], np.float32)


class FailingCrossEncoder:
    def predict(self, pairs):
        raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("t,fmt", [(16, "bin"), (16, "safetensors"), (128, "safetensors")])
def test_logits_match_hf_and_tpu_rag(hf_ce, t, fmt):
    model, dirs = hf_ce
    sd = hf_import.load_cross_encoder_params(dirs[fmt], BertSpec(**TINY))
    assert sd is not None
    rng = np.random.default_rng(t)
    ids = rng.integers(4, TINY["vocab_size"], (3, t)).astype(np.int64)
    mask = np.ones((3, t), np.int64)
    mask[1, t // 2:] = 0
    mask[2, 3:] = 0
    types = np.zeros((3, t), np.int64)
    types[:, 2:] = 1
    types[mask == 0] = 0
    with torch.no_grad():
        want_hf = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                        token_type_ids=torch.from_numpy(types)).logits.numpy()[:, 0]
        mod = CrossEncoderModule(BertSpec(**TINY))
        mod.load_state_dict(sd)
        got = mod(torch.from_numpy(ids), torch.from_numpy(mask).int(),
                  torch.from_numpy(types)).numpy()
    params = jax_hf.load_cross_encoder_params(dirs[fmt], JaxSpec(**TINY))
    want_jax = np.asarray(JaxCEModule(JaxSpec(**TINY), flash=True).apply(
        {"params": params}, *(jnp.asarray(a, jnp.int32) for a in (ids, mask, types))))
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want_hf, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=2e-4)


def test_cross_encoder_weights_path_loads_the_checkpoint(hf_ce):
    model, dirs = hf_ce
    ces = [CrossEncoder("x", spec=BertSpec(**TINY), device="cpu", weights_path=str(d))
           for d in dirs.values()]
    for ce in ces:
        assert ce.seq_len == TINY["max_len"]                 # min(256, max_len)
        assert torch.equal(ce.module.classifier.weight, model.classifier.weight)
        assert torch.equal(ce.module.pooler.bias, model.bert.pooler.dense.bias)
    pairs = [("moon temple", "the moon temple on the cliff"), ("iron", "a sword")]
    np.testing.assert_array_equal(ces[0].predict(pairs), ces[1].predict(pairs))


@pytest.mark.parametrize("seq_len,n", [(32, 3), (128, 11)])
def test_predict_matches_tpu_rag(seq_len, n):
    """Chunks of <= 8 pairs run at batch 8, longer ones at `batch`; T 128
    takes the port's fused attention, T 32 its plain one."""
    jax_ce = JaxCrossEncoder("tiny-ce", spec=JaxSpec(**TINY), seq_len=seq_len, batch=16)
    params = jax.tree_util.tree_map(np.asarray, jax_ce.params)
    ce = CrossEncoder("tiny-ce", spec=BertSpec(**TINY), seq_len=seq_len, batch=16,
                      device="cpu", state_dict=cross_encoder_params_from_flax(params))
    words = ["moon", "temple", "silver", "cliff", "dragon", "sword", "tide", "smith"]
    pairs = [(f"{words[i % 8]} {words[(i + 3) % 8]}",
              " ".join(words[(i + j) % 8] for j in range(5 + 9 * i)))
             for i in range(n)]
    got = ce.predict(pairs)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_ce.predict(pairs), rtol=0, atol=2e-4)
    assert ce.predict([]).shape == (0,)


def test_seeded_weights_follow_the_model_name():
    a = CrossEncoder("ce-a", spec=BertSpec(**TINY), device="cpu")
    b = CrossEncoder("ce-a", spec=BertSpec(**TINY), device="cpu")
    c = CrossEncoder("ce-c", spec=BertSpec(**TINY), device="cpu")
    pairs = [("q", "a doc"), ("other", "text here")]
    np.testing.assert_array_equal(a.predict(pairs), b.predict(pairs))
    assert not np.array_equal(a.predict(pairs), c.predict(pairs))


def _hits():
    texts = ["the dragon guards the treasure", "a knight rides north",
             "dragon treasure maps", "the sleeping dragon", "north wind"]
    hits = [{"id": f"v{i}", "text": t, "score": 0.1 * i, "rank": i + 1}
            for i, t in enumerate(texts)]
    hits += [{"id": "db:1", "text": "treasure of the dragon king", "score": -3.2,
              "score_kind": "bm25"},
             {"id": "db:2", "text": "north", "score": -0.4}]
    return hits


@pytest.mark.parametrize("mode,alpha", [("replace", 0.5), ("ensemble", 0.5),
                                        ("ensemble", 0.3), ("annotate", 0.5)])
def test_rerank_hits_matches_tpu_rag(mode, alpha):
    got = rerank_hits(FakeCrossEncoder(), "dragon treasure", _hits(), mode=mode, alpha=alpha)
    want = jax_rerank_hits(FakeCrossEncoder(), "dragon treasure", _hits(), mode=mode,
                           alpha=alpha)
    assert got == want
    assert all("rerank_score" in h for h in got)
    if mode == "annotate":
        assert [h["id"] for h in got] == [h["id"] for h in _hits()]
    assert rerank_hits(None, "q", _hits()) == _hits()
    assert rerank_hits(FakeCrossEncoder(), "q", []) == []


def test_failed_predict_raises_where_tpu_rag_swallows_it():
    """Divergence: tpu_rag logs a failed predict and returns the hits
    unchanged; the port lets the exception reach /search (rerank_error)."""
    hits = _hits()
    assert jax_rerank_hits(FailingCrossEncoder(), "q", copy.deepcopy(hits)) == hits
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        rerank_hits(FailingCrossEncoder(), "q", copy.deepcopy(hits))


class FakeEncoder:
    dim = 8

    def embed(self, texts):
        return np.ones((len(texts), 8), np.float32) / 8 ** 0.5


def _gate_engines(tmp_path, manifest, alpha):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(exist_ok=True)
    (ckpt / "rerank.json").write_text(json.dumps(manifest))
    out = []
    for cls, eng, extra in ((Config, RagEngine, {"device": "cpu"}),
                            (JaxConfig, JaxEngine, {"use_pallas": False})):
        tag = cls.__module__.split(".")[0]
        cfg = cls(persist_dir=str(tmp_path / tag / "vs"),
                  kb_db_path=str(tmp_path / tag / "kb.sqlite3"),
                  db_path=str(tmp_path / tag / "app.sqlite3"),
                  docs_dir=str(tmp_path / tag / "docs"), index_dtype="float32",
                  rerank_mode="ensemble", rerank_ensemble_alpha=alpha,
                  rerank_weights=str(ckpt / "model.safetensors"), **extra)
        out.append(eng(cfg, encoder=FakeEncoder(), cross_encoder=FakeCrossEncoder()))
    return out


def _manifest(fixed: float, serving: float, alpha: float = 0.3) -> dict:
    return {"results": [
        {"label": "biencoder_top20_no_rerank", "recall@10": 0.60},
        {"label": f"ensemble_bi+trained_ce(alpha={alpha})", "recall@10": serving},
        {"label": "ensemble_bi+trained_ce", "recall@10": fixed},
    ]}


@pytest.mark.parametrize("fixed,serving,port_mode,jax_mode", [
    (0.70, 0.50, "annotate", "ensemble"),    # serving blend loses, fixed one wins
    (0.50, 0.70, "ensemble", "annotate"),    # the reverse
])
def test_rerank_gate_reads_the_serving_alpha_row(tmp_path, fixed, serving, port_mode,
                                                 jax_mode):
    """Divergence: tpu_rag gates on the equal-weight row
    `ensemble_bi+trained_ce`; the port on the row of the alpha it serves."""
    port, ref = _gate_engines(tmp_path, _manifest(fixed, serving), alpha=0.3)
    try:
        assert port._gated_rerank_mode() == port_mode
        assert ref._gated_rerank_mode() == jax_mode
        hits = port.rerank("dragon treasure", _hits())
        if port_mode == "annotate":                    # retriever order kept
            assert [h["id"] for h in hits] == [h["id"] for h in _hits()]
        assert all("rerank_score" in h for h in hits)
    finally:
        port.shutdown()
        ref.shutdown()


def test_rerank_gate_passes_when_no_row_has_the_serving_alpha(tmp_path, caplog):
    port, ref = _gate_engines(tmp_path, _manifest(0.5, 0.5, alpha=0.3), alpha=0.4)
    try:
        with caplog.at_level(logging.WARNING):
            assert port._gated_rerank_mode() == "ensemble"
        assert any("ensemble_bi+trained_ce(alpha=0.4)" in r.getMessage()
                   for r in caplog.records)
    finally:
        port.shutdown()
        ref.shutdown()
