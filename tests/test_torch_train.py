"""The port's bi-encoder training against tpu_rag's: InfoNCE, AdamW against
optax.adamw, the warmup + cosine schedule, three training steps from shared
parameters, the checkpoint format (loaded by both packages and by
transformers), the vocab and corpus tools and train_semantic end to end, on
the CPU.  Also the guard that kernel #5 raises under autograd, and that the
trainer never reaches it.

Tiny widths (vocab 512, hidden 64, 2 layers, 4 heads, FFN 128, max_len 64,
batch 8, seq 16), numpy seeds, one torch thread; tpu_rag runs on a 1 x 1
CPU mesh."""

import inspect
import json
import sysconfig

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import scripts.make_corpus as jax_make_corpus
import scripts.train_semantic as jax_semantic
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag.models.vocab_train import save_vocab as jax_save_vocab
from tpu_rag.models.vocab_train import train_wordpiece_vocab as jax_train_vocab
from tpu_rag.train.contrastive import ContrastiveTrainer as JaxTrainer
from tpu_rag.train.contrastive import info_nce_loss as jax_info_nce
from test_vocab_and_dp_embed import CORPUS
from tpu_rag_torch import _build
from tpu_rag_torch.models import bert as bert_mod
from tpu_rag_torch.models.bert import BertSpec, params_from_flax
from tpu_rag_torch.models.biencoder import BiEncoder
from tpu_rag_torch.models.vocab_train import save_vocab, train_wordpiece_vocab
from tpu_rag_torch.ops import attention
from tpu_rag_torch.scripts import make_corpus, train_biencoder, train_semantic
from tpu_rag_torch.train import contrastive
from tpu_rag_torch.train.contrastive import (ContrastiveTrainer, info_nce_loss,
                                             warmup_cosine_decay)

SPEC = dict(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128, max_len=64)
LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _batch(rng, b: int = 8, seq: int = 16, vocab: int = 512) -> dict:
    """Rows of the second half are cut short: their tail is pad (id 0, mask
    0), so the two-sided attention mask and the mean pool's mask take part."""
    out = {}
    for side in "qd":
        ids = rng.integers(4, vocab, (b, seq)).astype(np.int32)
        mask = np.ones((b, seq), np.int32)
        for r in range(b // 2, b):
            n = int(rng.integers(2, seq // 2 + 1))
            ids[r, n:] = 0
            mask[r, n:] = 0
        out[f"{side}_ids"], out[f"{side}_mask"] = ids, mask
    return out


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("tau", [0.05, 1.0])
def test_info_nce_matches_tpu_rag(tau):
    rng = np.random.default_rng(1)
    q, d = _unit(rng, 8, 32), _unit(rng, 8, 32)
    d[:3] = q[:3]                         # some positives already aligned
    want = float(jax_info_nce(jnp.asarray(q), jnp.asarray(d), tau))
    got = float(info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), tau))
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("init,peak,warmup,steps,end", [
    (0.0, 4e-4, 30, 300, 8e-6),          # train_semantic's cut geometry
    (0.0, 4e-4, 200, 3000, 8e-6),        # its defaults
    (1e-5, 1e-3, 0, 12, 0.0),            # no warmup
    (0.0, 4e-4, 1, 5, 8e-6),             # steps 5 <= warmup 200: clamped to 1
    (0.0, 4e-4, 1, 10, 8e-6),            # steps 10 <= warmup 10: clamped to 1
])
def test_warmup_cosine_decay_matches_optax(init, peak, warmup, steps, end):
    """Within optax's own f32 rounding: it computes (init - peak) * frac +
    peak in f32, so its values carry errors of a few f32 ulps of peak."""
    atol = 2 * float(np.finfo(np.float32).eps) * peak
    want = optax.warmup_cosine_decay_schedule(
        init_value=init, peak_value=peak, warmup_steps=warmup, decay_steps=steps,
        end_value=end)
    got = warmup_cosine_decay(init, peak, warmup, steps, end)
    for step in range(steps + 6):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=atol,
                                   err_msg=f"step {step}")


def test_warmup_cosine_decay_without_decay_steps_raises_as_optax():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1)
    with pytest.raises(ValueError):
        warmup_cosine_decay(0.0, 1e-3, 1, 1)


def test_adamw_and_schedule_match_optax():
    """The trainer's optimizer alone, 20 steps at peak lr 1e-2 under the
    warmup + cosine schedule, against optax.adamw on the same parameters and
    fixed gradients: weight decay (1e-4 on every tensor) shows at this lr.
    Parameters agree within 1e-6 plus 1e-6 of their size: the two round
    each f32 update in a different order, a few ulps a step (an ulp of a
    parameter near 2 is 2.4e-7)."""
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "b": (5,), "ln": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(20)]
    sched = dict(init_value=0.0, peak_value=1e-2, warmup_steps=4, decay_steps=20,
                 end_value=2e-4)

    opt = optax.adamw(optax.warmup_cosine_decay_schedule(**sched))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    module = torch.nn.ParameterDict(tp)
    opt = contrastive.adamw(module.parameters())
    schedule = warmup_cosine_decay(*sched.values())
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        moved = float(np.abs(np.asarray(jp[k]) - params[k]).max())
        assert moved > 1e-2                              # the steps did move them
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_three_train_steps_match_tpu_rag():
    """Three steps of both trainers (remat on, lr 5e-4, half-masked rows)
    from tpu_rag's initial parameters.

    Losses agree within 1e-5 at every step.  Parameters agree within 1e-5
    (lr / 50): Adam moves each parameter by about lr a step whatever its
    gradient's size, so agreement well below lr shows both took the same
    steps.  One tensor per layer is exempt: the attention's key bias.
    Adding a vector to every key shifts each row of scores by a constant,
    which softmax ignores, so that bias's gradient is exactly zero in exact
    arithmetic; both frameworks compute rounding noise for it, which Adam
    scales up to steps of up to lr with signs that differ between them.  For
    it the test checks that the port's gradient is rounding noise and that
    both trainers keep it within Adam's bound of the shared start."""
    rng = np.random.default_rng(0)
    jt = JaxTrainer(JaxSpec(**SPEC), _mesh11(), lr=LR)
    start = params_from_flax(jax.device_get(jt.params))
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=LR, device="cpu")
    assert trainer.module.remat and not trainer.module.flash
    trainer.module.load_state_dict(start)
    for step in range(3):
        batch = _batch(rng)
        want, got = jt.train_step(batch), trainer.train_step(batch)
        assert abs(got - want) <= 1e-5, (step, got, want)

    ref = params_from_flax(jax.device_get(jt.params))
    sd = trainer.module.state_dict()
    key_bias = {f"layers.{i}.attention.key.bias" for i in range(SPEC["layers"])}
    for name in ref:
        if name in key_bias:
            continue
        np.testing.assert_allclose(sd[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not torch.equal(sd[name], start[name]), name     # every tensor trained
    grads = {n: p.grad for n, p in trainer.module.named_parameters()}
    for name in key_bias:
        scale = float(grads[name.replace("key", "query")].abs().max())
        assert float(grads[name].abs().max()) < 1e-4 * scale, name
        for params in (sd, ref):
            assert float((params[name] - start[name]).abs().max()) <= 3 * LR * 1.01


def _trained(tmp_path, seed: int = 0) -> tuple[ContrastiveTrainer, str]:
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=1e-3, seed=seed, device="cpu")
    trainer.train_step(_batch(np.random.default_rng(seed)))
    ckpt = str(tmp_path / f"ckpt{seed}")
    trainer.save(ckpt)
    return trainer, ckpt


TEXTS = ["the moon temple on the silver cliff", "dragons guard the northern pass",
         " ".join(f"w{i}" for i in range(40))]


def test_checkpoint_serves_in_both_packages(tmp_path):
    """trainer.save -> the port's BiEncoder with no spec= takes the
    architecture from config.json and holds the trained tensors bit for
    bit; tpu_rag's BiEncoder (HF import, spec given) embeds within 2e-4 of
    the port's CPU f32 embeddings."""
    trainer, ckpt = _trained(tmp_path)
    cfg = json.loads((tmp_path / "ckpt0" / "config.json").read_text())
    assert (cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["intermediate_size"],
            cfg["max_position_embeddings"], cfg["type_vocab_size"],
            cfg["layer_norm_eps"]) == (512, 64, 2, 4, 128, 64, 2, 1e-12)
    enc = BiEncoder("sentence-transformers/all-MiniLM-L6-v2", weights_path=ckpt,
                    seq_len=256, batch=8, device="cpu")
    assert enc.spec == trainer.spec and enc.seq_len == 64
    want = trainer.module.state_dict()
    got = enc.module.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    jax_enc = JaxBiEncoder(spec=JaxSpec(**SPEC), weights_path=ckpt, seq_len=64, batch=8)
    np.testing.assert_allclose(enc.embed(TEXTS), jax_enc.embed(TEXTS), rtol=0, atol=2e-4)


def test_checkpoint_loads_in_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    trainer, ckpt = _trained(tmp_path)
    hf = transformers.BertModel.from_pretrained(ckpt, add_pooling_layer=False).eval()
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(4, 512, (3, 24)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = trainer.module(ids, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_load_restores_params_and_resets_adamw(tmp_path):
    saved, ckpt = _trained(tmp_path, seed=0)
    trainer, _ = _trained(tmp_path, seed=1)
    assert trainer.step == 1 and trainer.optimizer.state
    trainer.load(ckpt)
    assert trainer.step == 0 and not trainer.optimizer.state
    for name, t in saved.module.state_dict().items():
        assert torch.equal(trainer.module.state_dict()[name], t), name
    with pytest.raises(FileNotFoundError):
        trainer.load(str(tmp_path / "missing"))


def test_mesh_of_more_than_one_device_raises():
    """A dict names a one-device mesh only; more devices take a
    parallel.Mesh (DP x TP, tests/test_torch_tp.py), whose "model" axis must
    divide the heads."""
    from tpu_rag_torch.parallel import mesh_from_spec

    spec = BertSpec(**SPEC)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContrastiveTrainer(spec, device="cpu", mesh={"data": 2, "model": 1})
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ContrastiveTrainer(spec, device="cpu", mesh={"data": 1, "model": 2})
    ContrastiveTrainer(spec, device="cpu", mesh={"data": 1, "model": 1})
    trainer = ContrastiveTrainer(spec, device="cpu",
                                 mesh=mesh_from_spec("data:2,model:2", ["cpu"] * 4))
    assert np.isfinite(trainer.train_step(_batch(np.random.default_rng(1))))
    with pytest.raises(ValueError, match='"model" mesh axis of size 8'):
        ContrastiveTrainer(spec, device="cpu", mesh=mesh_from_spec("model:8", ["cpu"] * 8))


def test_training_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ContrastiveTrainer(BertSpec(**SPEC))
    corpus = tmp_path / "corpus.jsonl"
    corpus.write_text(json.dumps({"id": "a", "title": "t", "query": "q", "body": "b"}) + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        train_semantic.main(["--corpus", str(corpus), "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()       # raised before writing anything
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text("".join(json.dumps({"q": f"q{i}", "d": f"d{i}"}) + "\n"
                             for i in range(4)))
    with pytest.raises(RuntimeError, match="cuda"):
        train_biencoder.main(["--pairs", str(pairs), "--out", str(tmp_path / "b")])


def test_fused_mha_cuda_raises_under_autograd(monkeypatch):
    """The kernel has no backward: a call autograd would differentiate
    raises first thing, before any build (which a host without nvcc could
    not do)."""
    def no_build(*a, **k):
        raise AssertionError("the guard must come before the build")
    monkeypatch.setattr(_build, "function", no_build)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 4, 32)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 128, dtype=torch.int32)
    for grad_of in ("q", "k", "v"):
        args = {"q": q.clone(), "k": k.clone(), "v": v.clone()}
        args[grad_of].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            attention._fused_mha_cuda(args["q"], args["k"], args["v"], mask)
    q.requires_grad_(True)
    with torch.no_grad(), pytest.raises(AssertionError, match="before the build"):
        attention._fused_mha_cuda(q, k, v, mask)   # no autograd: it goes on to build


def test_training_forward_at_t128_never_calls_fused_mha(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("the training step called fused_mha")
    monkeypatch.setattr(bert_mod, "fused_mha", forbidden)
    monkeypatch.setattr(attention, "fused_mha", forbidden)
    spec = BertSpec(**{**SPEC, "max_len": 128})
    trainer = ContrastiveTrainer(spec, lr=LR, device="cpu")
    batch = _batch(np.random.default_rng(4), b=4, seq=128)
    assert np.isfinite(trainer.train_step(batch))
    # the serving module at the same T does reach it
    enc = BiEncoder(spec=spec, state_dict=trainer.module.state_dict(), device="cpu",
                    seq_len=128)
    with pytest.raises(AssertionError, match="called fused_mha"):
        enc.forward_ids(np.asarray(batch["d_ids"]))


@pytest.mark.parametrize("kw", [dict(vocab_size=500, min_freq=1), dict()])
def test_vocab_matches_tpu_rag(tmp_path, kw):
    want = jax_train_vocab(CORPUS, **kw)
    got = train_wordpiece_vocab(CORPUS, **kw)
    assert got == want
    save_vocab(got, tmp_path / "port" / "vocab.txt")
    jax_save_vocab(want, tmp_path / "jax" / "vocab.txt")
    assert ((tmp_path / "port" / "vocab.txt").read_bytes()
            == (tmp_path / "jax" / "vocab.txt").read_bytes())


_DOC_BODY = ("The function walks every entry of the table in order and returns "
             "a new mapping whose values are the results of applying the callable "
             "to each value, keeping the keys.  Entries that raise are skipped "
             "and reported in the log, so a partial result is still returned to "
             "the caller.  Large tables are processed in chunks of a thousand "
             "rows to bound the memory that the intermediate copies take.")


def _py_tree(root, n_files: int = 3):
    """A few .py files with docstrings that make_corpus keeps (a summary of
    4+ words, a body of 250+ chars), one duplicate body and one rejected."""
    for f in range(n_files):
        src = [f'"""Module {f}."""\n']
        for j in range(3):
            src.append(f"def fn_{f}_{j}(x):\n    \"\"\"Apply the transform number {j} "
                       f"to every row of table {f}.\n\n    {_DOC_BODY} Case {f}.{j}.\n"
                       f"    \"\"\"\n    return x\n\n")
        src.append("class Dup:\n    \"\"\"Apply the transform to every row again.\n\n"
                   f"    {_DOC_BODY} Case 0.0.\n    \"\"\"\n\n")
        src.append("def short():\n    \"\"\"Too short.\"\"\"\n")
        (root / f"mod_{f}.py").write_text("".join(src))
    (root / "tests").mkdir()
    (root / "tests" / "test_skipped.py").write_text(src[1])


def test_make_corpus_matches_script(tmp_path, monkeypatch):
    lib, std = tmp_path / "lib", tmp_path / "std"
    lib.mkdir()
    std.mkdir()
    _py_tree(lib)
    (std / "os_like.py").write_text(
        "def walk(top):\n    \"\"\"Generate the file names in a directory tree by walking it.\n\n"
        f"    {_DOC_BODY}\n    \"\"\"\n")
    monkeypatch.setattr(sysconfig, "get_paths", lambda: {"purelib": str(lib),
                                                         "stdlib": str(std)})
    monkeypatch.setattr("sys.argv", ["make_corpus", "--out", str(tmp_path / "jax.jsonl")])
    jax_make_corpus.main()
    make_corpus.main(["--out", str(tmp_path / "port.jsonl")])
    want = (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == want
    assert len(want.splitlines()) == 10             # 9 functions + walk; Dup deduped


_WORDS = ("table row column index value key merge join sort filter group window "
          "stream batch cache shard replica token vector query score rank model "
          "layer weight tensor device kernel memory buffer queue thread lock").split()


def _corpus(path, n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        topic = [str(w) for w in rng.choice(_WORDS, 4, replace=False)]
        body = " ".join(topic[j % 4] if j % 3 == 0 else str(rng.choice(_WORDS))
                        for j in range(60))
        docs.append({"id": f"doc-{i:06d}", "title": f"fn_{i}",
                     "query": "Compute the " + " ".join(topic) + " result.", "body": body})
    path.write_text("".join(json.dumps(d) + "\n" for d in docs))
    return docs


def test_split_holdout_matches_tpu_rag(tmp_path):
    docs = _corpus(tmp_path / "c.jsonl", 500)
    for frac in (0.1, 0.25, 0.5):
        assert train_semantic.split_holdout(docs, frac) == jax_semantic.split_holdout(docs, frac)


def test_eval_rows_match_tpu_rag(tmp_path):
    """eval_encoder, eval_bm25 and eval_hybrid_rrf give tpu_rag's rows and
    rankings on a corpus of 150 docs (random embeddings)."""
    docs = _corpus(tmp_path / "c.jsonl", 150, seed=1)
    _, holdout = jax_semantic.split_holdout(docs, 0.2)

    class Enc:
        def __init__(self):
            self.rng = np.random.default_rng(7)

        def embed(self, texts):
            return _unit(self.rng, len(texts), 16)

    want_row, want_top = jax_semantic.eval_encoder(Enc(), docs, holdout, "trained_biencoder")
    got_row, got_top = train_semantic.eval_encoder(Enc(), docs, holdout, "trained_biencoder")
    want_row.pop("embed_seconds"), got_row.pop("embed_seconds")
    assert got_row == want_row
    np.testing.assert_array_equal(got_top, want_top)
    want_bm, want_bm_top = jax_semantic.eval_bm25(docs, holdout)
    got_bm, got_bm_top = train_semantic.eval_bm25(docs, holdout)
    assert (got_bm, got_bm_top) == (want_bm, want_bm_top)
    assert (train_semantic.eval_hybrid_rrf(docs, holdout, got_top, got_bm_top)
            == jax_semantic.eval_hybrid_rrf(docs, holdout, want_top, want_bm_top))


def test_train_semantic_end_to_end_on_cpu(tmp_path):
    corpus = tmp_path / "corpus.jsonl"
    docs = _corpus(corpus, 60)
    out = tmp_path / "semantic"
    report = train_semantic.main([
        "--corpus", str(corpus), "--out", str(out), "--device", "cpu",
        "--vocab-size", "512", "--seq-len", "32", "--q-len", "16", "--batch", "8",
        "--steps", "3", "--warmup", "1"])
    for name in ("vocab.txt", "ckpt/model.safetensors", "ckpt/config.json",
                 "quality.json", "QUALITY.md"):
        assert (out / name).is_file(), name
    quality = json.loads((out / "quality.json").read_text())
    assert quality == json.loads(json.dumps(report))
    labels = [r["label"] for r in quality["results"]]
    assert labels == ["trained_biencoder", "random_weights_round1", "bm25_fts5",
                      "hybrid_trained+bm25_rrf"]
    ref_src = inspect.getsource(jax_semantic)
    assert all(f'"{label}"' in ref_src for label in labels)
    assert set(quality) == {"task", "corpus_docs", "holdout_queries", "train_steps", "batch",
                            "spec", "results", "serving"}
    _, holdout = jax_semantic.split_holdout(docs, 0.1)
    assert quality["holdout_queries"] == len(holdout) and quality["corpus_docs"] == 60
    for row in quality["results"]:
        assert 0.0 <= row["recall@1"] <= row["recall@5"] <= row["recall@10"] <= 1.0
    assert quality["serving"]["EMBEDDING_WEIGHTS"] == str((out / "ckpt").resolve())
    assert "| trained_biencoder |" in (out / "QUALITY.md").read_text()
    enc = BiEncoder(weights_path=str(out / "ckpt"), device="cpu")
    assert (enc.spec.hidden, enc.spec.layers, enc.spec.vocab_size, enc.spec.max_len) == (
        384, 6, 512, 128)


def test_train_biencoder_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("EMBEDDING_MODEL", "tiny")
    monkeypatch.setenv("TOKENIZER_PATH", "")
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text("".join(json.dumps({"q": f"query {i}", "d": f"document {i} body"}) + "\n"
                             for i in range(6)))
    out = tmp_path / "ckpt"
    train_biencoder.main(["--pairs", str(pairs), "--out", str(out), "--steps", "2",
                          "--batch", "4", "--seq-len", "32", "--device", "cpu"])
    enc = BiEncoder(weights_path=str(out), device="cpu")
    assert (enc.spec.hidden, enc.spec.layers, enc.spec.vocab_size) == (64, 2, 1024)
    tp_out = tmp_path / "ckpt_tp"
    train_biencoder.main(["--pairs", str(pairs), "--out", str(tp_out), "--steps", "2",
                          "--batch", "4", "--seq-len", "32", "--device", "cpu",
                          "--mesh", "data:2,model:2"])
    tp_enc = BiEncoder(weights_path=str(tp_out), device="cpu")
    assert tp_enc.spec == enc.spec
    with pytest.raises(ValueError, match='"model" mesh axis of size 3'):
        train_biencoder.main(["--pairs", str(pairs), "--out", str(out), "--device", "cpu",
                              "--mesh", "data:1,model:3"])
