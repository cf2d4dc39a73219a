"""The port's reranker training against tpu_rag's on the CPU: the ranking
step, optimiser and divergence guard (train/ranking.py) against the optax
chain and tpu_rag's CrossEncoderModule as scripts/train_reranker.py builds
them; the trained checkpoint read by the port, tpu_rag and transformers;
the script's pieces against the reference module; and train_reranker end
to end against the reference script on the same corpus and bi-encoder.

Tiny widths (vocab 256-800, hidden 32-64, 2 layers, 4 heads), numpy seeds,
one torch thread.  Tolerances are stated in each test.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import scripts.train_reranker as jax_rr
from tpu_rag.models.bert import BertSpec as JaxSpec
from tpu_rag.models.biencoder import BiEncoder as JaxBiEncoder
from tpu_rag.models.crossencoder import CrossEncoderModule as JaxCEModule
from tpu_rag.models import hf_import as jax_hf
from tpu_rag.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from tpu_rag.models.tokenizer import encode_pair_batch as jax_encode_pair_batch
from tpu_rag.models.vocab_train import save_vocab as jax_save_vocab
from tpu_rag.models.vocab_train import train_wordpiece_vocab as jax_train_vocab
from tpu_rag_torch.config import Config
from tpu_rag_torch.engine import RagEngine
from tpu_rag_torch.models.bert import BertSpec, params_from_flax
from tpu_rag_torch.models.crossencoder import CrossEncoder, cross_encoder_params_from_flax
from tpu_rag_torch.models.hf_export import save_bert
from tpu_rag_torch.scripts import train_reranker
from tpu_rag_torch.train import ranking
from tpu_rag_torch.train.ranking import RankingTrainer, clip_by_global_norm_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(vocab_size=256, hidden=32, layers=2, heads=4, ffn=64, max_len=32)
GROUP, N_POS, T = 4, 4, 16
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(rng, vocab: int = 256):
    """N_POS groups of GROUP pair rows at T: [CLS]-like first token, a query
    segment (type 0), a body segment (type 1), pad tails (id 0, mask 0)."""
    b = N_POS * GROUP
    ids = rng.integers(4, vocab, (b, T)).astype(np.int32)
    mask = np.ones((b, T), np.int32)
    types = np.zeros((b, T), np.int32)
    for r in range(b):
        n = int(rng.integers(6, T + 1))
        q = int(rng.integers(2, n - 2))
        types[r, q:n] = 1
        ids[r, n:], mask[r, n:] = 0, 0
    return ids, mask, types


def _jax_step(spec, lr_mult: float, warmup: int, steps: int, max_errors: int = 100):
    """scripts/train_reranker.py:303-307 and 330-352, as written there: the
    CrossEncoderModule in f32 (the reference's dtype off the TPU), the
    schedule, apply_if_finite(chain(clip_by_global_norm(1.0), adamw)) and
    the grouped softmax loss (without the jit's buffer donation)."""
    module = JaxCEModule(spec, dtype=jnp.float32)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR * lr_mult, warmup, steps,
                                                  LR * lr_mult * 0.02)
    optimizer = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule)),
        max_consecutive_errors=max_errors)

    @jax.jit
    def step_fn(params, opt_state, ids, mask, types):
        def loss_fn(p):
            logits = module.apply({"params": p}, ids, mask, types)
            g = logits.reshape(N_POS, GROUP)
            return optax.softmax_cross_entropy_with_integer_labels(
                g, jnp.zeros((N_POS,), jnp.int32)).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return module, optimizer, step_fn


def _shared_start(warmup: int = 1, steps: int = 10, max_errors: int = 100):
    """tpu_rag's module, optimiser and step; the port's trainer loaded with
    the same initial parameters."""
    module, optimizer, step_fn = _jax_step(JaxSpec(**SPEC), 1.0, warmup, steps, max_errors)
    z = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(0), z, jnp.ones((1, 8), jnp.int32), z)["params"]
    trainer = RankingTrainer(BertSpec(**SPEC), lr=LR, warmup=warmup, steps=steps,
                             group=GROUP, device="cpu")
    assert not trainer.module.bert.flash
    trainer.module.load_state_dict(cross_encoder_params_from_flax(jax.device_get(params)))
    return params, optimizer.init(params), step_fn, trainer


def _key_biases():
    """The tensors whose true gradient is exactly zero: each attention key
    bias (softmax ignores a shift of every key) and the classifier bias (the
    group softmax ignores a shift of every logit)."""
    return {f"bert.layers.{i}.attention.key.bias"
            for i in range(SPEC["layers"])} | {"classifier.bias"}


def test_three_steps_match_the_reference_chain():
    """Three steps from shared parameters, clipping engaged (the initial
    gradient norm is above 1).  Losses within 1e-5 at every step;
    parameters within 1e-5 (lr / 100) after the third, but the attention's
    key biases and the classifier bias: their true gradient is zero
    (softmax ignores a shift of every key, the group softmax a shift of
    every logit), so Adam turns each framework's rounding noise into steps
    of up to lr with signs of its own; both stay within 3 lr of the
    start."""
    params, opt_state, step_fn, trainer = _shared_start()
    start = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    rng = np.random.default_rng(0)
    norms = []
    for step in range(3):
        ids, mask, types = _batch(rng)
        params, opt_state, want = step_fn(params, opt_state, ids, mask, types)
        got = trainer.train_step(ids, mask, types)
        assert abs(got - float(want)) <= 1e-5, (step, got, float(want))
        grads = [p.grad for p in trainer.module.parameters()]
        norms.append(float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))))
    assert max(norms) <= 1.0 + 1e-5          # the port's gradients were clipped ...
    assert trainer.count == 3 and trainer.skipped == 0
    ref = cross_encoder_params_from_flax(jax.device_get(params))
    sd = trainer.module.state_dict()
    for name in ref:
        if name in _key_biases():
            for p in (sd, ref):
                assert float((p[name] - start[name]).abs().max()) <= 3 * LR * 1.01, name
            continue
        np.testing.assert_allclose(sd[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not torch.equal(sd[name], start[name]), name


# the long run: a CE of chip_smoke.py's reranker shape cut to hidden 64, 2
# layers and 2 heads at T 48, 16 pairs (4 groups of 4), through warmup (20
# steps), the learning rate's peak and 40 steps of its cosine decay
LONG_SPEC = dict(vocab_size=256, hidden=64, layers=2, heads=2, ffn=128, max_len=48)
LONG_T, LONG_WARMUP, LONG_STEPS, LONG_LR = 48, 20, 60, 1e-3


def _ranked_batch(rng):
    """N_POS groups of GROUP rows at LONG_T, [positive, negatives...]:
    [CLS] (id 1), a query of 4-9 tokens, [SEP] (2), a body segment (type
    1) of random tokens, pad tails; the positive's body repeats the
    query's tokens, so the ranking can be learned."""
    b = N_POS * GROUP
    ids = rng.integers(4, 256, (b, LONG_T)).astype(np.int32)
    mask = np.ones((b, LONG_T), np.int32)
    types = np.zeros((b, LONG_T), np.int32)
    for g in range(N_POS):
        qlen = int(rng.integers(4, 10))
        q = rng.integers(4, 256, qlen)
        for j in range(GROUP):
            r = g * GROUP + j
            n = int(rng.integers(LONG_T - 12, LONG_T + 1))
            ids[r, 0], ids[r, 1:1 + qlen], ids[r, 1 + qlen] = 1, q, 2
            types[r, 2 + qlen:n] = 1
            if j == 0:
                ids[r, rng.choice(np.arange(3 + qlen, n), qlen, replace=False)] = q
            ids[r, n:], mask[r, n:] = 0, 0
    return ids, mask, types


def _track_the_reference(spec_kw: dict, warmup: int, steps: int, lr: float, dtype: str,
                         loss_rtol: float, std_rtol: float) -> list[float]:
    """tpu_rag's step (scripts/train_reranker.py:303-352: its module in
    `dtype`, the schedule, apply_if_finite, clip_by_global_norm(1.0), adamw,
    the grouped loss) and RankingTrainer in the same compute dtype, from
    shared parameters on the same batches: every step's loss within a
    relative loss_rtol, the spread of the logits over the batch (their std)
    after every 10th step within a relative std_rtol.  Returns the port's
    losses."""
    spec = JaxSpec(**spec_kw)
    module = JaxCEModule(spec, dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.02)
    optimizer = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule)),
        max_consecutive_errors=100)

    @jax.jit
    def step_fn(params, opt_state, ids, mask, types):
        def loss_fn(p):
            g = module.apply({"params": p}, ids, mask, types).reshape(N_POS, GROUP)
            return optax.softmax_cross_entropy_with_integer_labels(
                g, jnp.zeros((N_POS,), jnp.int32)).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    z = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(0), z, jnp.ones((1, 8), jnp.int32), z)["params"]
    opt_state = optimizer.init(params)
    trainer = RankingTrainer(BertSpec(**spec_kw), lr=lr, warmup=warmup, steps=steps,
                             group=GROUP, device="cpu",
                             compute_dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    trainer.module.load_state_dict(cross_encoder_params_from_flax(jax.device_get(params)))
    rng = np.random.default_rng(12)
    losses = []
    for step in range(1, steps + 1):
        batch = _ranked_batch(rng)
        params, opt_state, want = step_fn(params, opt_state, *batch)
        want = float(want)
        got = trainer.train_step(*batch)
        assert abs(got - want) <= loss_rtol * abs(want), (step, got, want)
        losses.append(got)
        if step % 10 == 0:
            ref_std = float(np.std(np.asarray(module.apply({"params": params}, *batch),
                                              np.float32)))
            port_std = float(np.std(trainer.score(*batch)))
            assert abs(port_std - ref_std) <= std_rtol * ref_std, (step, port_std, ref_std)
    assert trainer.count == steps and trainer.skipped == 0
    return losses


def test_sixty_steps_match_the_reference_through_the_peak():
    """Whether the port or the card's cut kept the reranker from learning
    (ROADMAP queue 3, resolved: the cut).  Sixty steps in f32 through the
    warmup, the peak (step 20) and into the cosine decay: every step's loss
    within a relative 1e-4, the logits' spread within a relative 1e-3.  The
    two sum in other orders (f32 reorderings drift by ~1e-6 relative over
    the sixty steps on a CPU).  The loss itself moves by more than 0.05
    over the run: the steps are not no-ops."""
    losses = _track_the_reference(LONG_SPEC, LONG_WARMUP, LONG_STEPS, LONG_LR, "f32",
                                  loss_rtol=1e-4, std_rtol=1e-3)
    assert max(losses) - min(losses) > 0.05


# MiniLM-L6's width (hidden 384, 12 heads, ffn 1536) at 2 layers, at the
# card's learning rate (1e-4), warmup 10 of 30 steps
MINILM_SPEC = dict(vocab_size=256, hidden=384, layers=2, heads=12, ffn=1536, max_len=48)


@pytest.mark.parametrize("dtype,loss_rtol,std_rtol", [("f32", 1e-4, 1e-3),
                                                      ("bf16", 2e-2, 1e-1)])
def test_minilm_width_tracks_the_reference(dtype, loss_rtol, std_rtol):
    """The long run's comparison at the card's width and, in bf16, its
    compute dtype (the reference's module in bf16 as on a TPU, the port's
    trunk under bf16 compute with f32 parameters).  bf16 rounds in other
    places in the two (measured: losses within 5.3e-3 relative, spreads
    within 2.7%, with no growth over the 30 steps); f32 as the long run
    (measured ~1e-6).  The collapse guard is not compared here: it reads
    only past step 1,000 (test_guard_rolls_back_on_a_scripted_loss_sequence
    holds it to the reference's rule)."""
    _track_the_reference(MINILM_SPEC, 10, 30, 1e-4, dtype, loss_rtol, std_rtol)


def test_clip_by_global_norm_matches_optax():
    """Above the limit g / |g| * 1.0 (optax's rule, no epsilon) within 1e-7;
    below it the gradients stay bit-equal."""
    rng = np.random.default_rng(1)
    for scale in (5.0, 0.05):
        tree = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in {"a": (7, 3), "b": (11,), "c": (2, 2, 2)}.items()}
        want, _ = optax.clip_by_global_norm(1.0).update(
            {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
        grads = [torch.from_numpy(v.copy()) for v in tree.values()]
        norm = float(clip_by_global_norm_(grads, 1.0))
        assert (norm > 1.0) == (scale > 1.0)
        for g, (k, v) in zip(grads, tree.items()):
            if scale < 1.0:
                assert np.array_equal(g.numpy(), v), k
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=0, atol=1e-7,
                                       err_msg=k)
        if scale > 1.0:
            got = float(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads])))
            assert abs(got - 1.0) <= 1e-6


def test_non_finite_steps_are_skipped_then_applied_as_optax_does(monkeypatch):
    """A NaN in the classifier bias makes every gradient NaN.  Both skip
    the update (parameters, AdamW's moments and the schedule's count
    unchanged) for max_consecutive_errors steps in a row, then apply the
    next one; a good step after the skips then matches the reference's
    within 1e-5.  max_consecutive_errors is 2 here (100 in training)."""
    monkeypatch.setattr(ranking, "MAX_CONSECUTIVE_ERRORS", 2)
    params, opt_state, step_fn, trainer = _shared_start(max_errors=2)
    rng = np.random.default_rng(2)
    good = _batch(rng)
    params, opt_state, _ = step_fn(params, opt_state, *good)
    trainer.train_step(*good)
    clean = {k: v.clone() for k, v in trainer.module.state_dict().items()}

    def poisoned(tree):
        tree = jax.tree_util.tree_map(lambda a: a, tree)
        tree["classifier"]["bias"] = jnp.full_like(tree["classifier"]["bias"], jnp.nan)
        return tree

    params = poisoned(params)
    with torch.no_grad():
        trainer.module.classifier.bias.fill_(float("nan"))
    for n in (1, 2):                                      # skipped by both
        bad = _batch(rng)
        params, opt_state, _ = step_fn(params, opt_state, *bad)
        trainer.train_step(*bad)
        assert trainer.count == 1 and trainer.skipped == n
        assert int(opt_state.notfinite_count) == n == trainer.notfinite_count
        for name, v in trainer.module.state_dict().items():
            if name != "classifier.bias":
                assert torch.equal(v, clean[name]), name
    assert int(opt_state.inner_state[1][0].count) == 1   # adamw's count: one step
    bad = _batch(rng)                                     # the third: applied
    params, opt_state, _ = step_fn(params, opt_state, *bad)
    trainer.train_step(*bad)
    assert trainer.count == 2 and int(opt_state.inner_state[1][0].count) == 2
    assert torch.isnan(trainer.module.bert.word_embeddings.weight).any()
    assert bool(jnp.isnan(params["bert"]["word_embeddings"]["embedding"]).any())

    # a skipped step leaves the count: from the clean state, a skip and a
    # good step equal one good step at count 1
    params, opt_state, step_fn, trainer = _shared_start(max_errors=2)
    params, opt_state, _ = step_fn(params, opt_state, *good)
    trainer.train_step(*good)
    nan_batch, nxt = _batch(rng), _batch(rng)
    with torch.no_grad():
        trainer.module.classifier.bias.fill_(float("nan"))
    trainer.train_step(*nan_batch)
    with torch.no_grad():
        trainer.module.classifier.bias.copy_(clean["classifier.bias"])
    assert trainer.count == 1 and trainer.notfinite_count == 1
    skipped, opt_state, _ = step_fn(poisoned(params), opt_state, *nan_batch)
    assert int(opt_state.inner_state[1][0].count) == 1
    skipped = dict(skipped)
    skipped["classifier"] = params["classifier"]
    params, opt_state, want = step_fn(skipped, opt_state, *nxt)
    got = trainer.train_step(*nxt)
    assert abs(got - float(want)) <= 1e-5 and trainer.count == 2
    ref = cross_encoder_params_from_flax(jax.device_get(params))
    for name, v in trainer.module.state_dict().items():
        if name not in _key_biases():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def test_guard_rolls_back_on_a_scripted_loss_sequence():
    """scripts/train_reranker.py:486-510 on a scripted sequence of 100-step
    readings (warmup 150, so counting starts past step 1000): healthy
    readings refresh the snapshot on multiples of 500; four readings at
    chance (>= ln 4 - 0.03, or NaN) restore it, halve the peak lr, reset
    AdamW and restart the schedule's count."""
    trainer = RankingTrainer(BertSpec(**SPEC), lr=LR, warmup=150, steps=3000, group=GROUP,
                             device="cpu")
    chance = float(np.log(GROUP))
    rng = np.random.default_rng(3)
    for _ in range(3):
        trainer.train_step(*_batch(rng))
    assert trainer.count == 3 and trainer.optimizer.state
    for step in (0, 500, 900, 1000):                # before counting starts
        assert not trainer.guard(step, chance)
    assert trainer.at_chance == 0 and trainer.snapshot_step == 0
    assert not trainer.guard(1100, 0.5)             # healthy, not a multiple of 500
    assert trainer.snapshot_step == 0
    assert not trainer.guard(1500, 0.5)             # healthy: snapshot refreshed
    snap = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    assert trainer.snapshot_step == 1500
    trainer.train_step(*_batch(rng))                # the parameters move on
    moved = trainer.module.state_dict()["classifier.weight"].clone()
    assert not torch.equal(moved, snap["classifier.weight"])
    readings = [(1600, chance - 0.02), (1700, float("nan")), (1800, chance + 0.5)]
    for step, loss in readings:
        assert not trainer.guard(step, loss)
    assert trainer.at_chance == 3
    assert not trainer.guard(1900, 0.5)             # a healthy reading resets the run
    assert trainer.at_chance == 0
    for step in (2100, 2200, 2300):
        assert not trainer.guard(step, chance)
    assert trainer.guard(2400, chance)              # the fourth in a row
    assert trainer.lr_mult == 0.5 and trainer.rollbacks == 1 and trainer.at_chance == 0
    assert trainer.count == 0 and not trainer.optimizer.state
    for name, v in trainer.module.state_dict().items():
        assert torch.equal(v, snap[name]), name
    # the schedule restarts: warmup from 0 towards half the peak
    assert trainer.schedule(0) == 0.0
    assert trainer.schedule(150) == pytest.approx(LR * 0.5)


def test_best_val_keeping_compares_tuples():
    trainer = RankingTrainer(BertSpec(**SPEC), lr=LR, warmup=1, steps=10, group=GROUP,
                             device="cpu")
    assert not trainer.restore_best({"ensemble": 0.0, "ce_alone": 0.0})
    assert trainer.offer(100, {"ensemble": 0.5, "ce_alone": 0.4})
    kept = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    assert not trainer.offer(200, {"ensemble": 0.5, "ce_alone": 0.4})     # equal: not better
    assert trainer.offer(300, {"ensemble": 0.5, "ce_alone": 0.45})
    assert not trainer.offer(400, {"ensemble": 0.45, "ce_alone": 0.9})
    assert trainer.best["step"] == 300
    kept = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    trainer.train_step(*_batch(np.random.default_rng(4)))
    assert trainer.restore_best({"ensemble": 0.5, "ce_alone": 0.45})      # final not better
    for name, v in trainer.module.state_dict().items():
        assert torch.equal(v, kept[name]), name
    trainer.train_step(*_batch(np.random.default_rng(5)))
    assert not trainer.restore_best({"ensemble": 0.6, "ce_alone": 0.0})


def test_split_holdout_and_rank_metrics_match_the_reference():
    docs = [{"id": f"doc-{i:05d}"} for i in range(700)]
    for frac in (0.1, 0.2, 0.5):
        assert train_reranker.split_holdout(docs, frac) == jax_rr.split_holdout(docs, frac)
    ranks = np.random.default_rng(6).integers(0, 30, 200)
    ranks[:7] = 10**6
    assert train_reranker.rank_metrics("x", ranks) == jax_rr.rank_metrics("x", ranks)


def _corpus_docs(n: int = 60) -> list[dict]:
    """tests/test_reranker_train.py:59-66's corpus."""
    docs = []
    for i in range(n):
        topic = ["alpha", "beta", "gamma", "delta"][i % 4]
        docs.append({"id": f"doc-{i:03d}", "title": f"t{i}",
                     "query": f"how to use {topic} widget {i}",
                     "body": f"the {topic} widget number {i} is configured by "
                             f"calling setup_{topic} with option {i} " * 4})
    return docs


def test_pair_rows_of_an_uncropped_pair_equal_encode_pair_batch(tmp_path):
    docs = _corpus_docs()
    vocab = jax_train_vocab((d["query"] + "\n" + d["body"] for d in docs), vocab_size=800)
    jax_save_vocab(vocab, str(tmp_path / "vocab.txt"))
    tok = JaxWordPiece(tmp_path / "vocab.txt")
    rng = np.random.default_rng(0)
    for d in docs[:8]:
        q, b = d["query"], d["body"][:60]
        ids, types = train_reranker.pair_rows(tok.tokenize_ids(q), tok.tokenize_ids(b), 96,
                                              rng, tok.cls_id, tok.sep_id)
        assert len(ids) < 96                                  # no crop drew from rng
        want_ids, want_mask, want_types = jax_encode_pair_batch(tok, [(q, b)], 96)
        got_ids, got_mask, got_types = train_reranker.assemble_pairs([(ids, types)], 96,
                                                                     tok.pad_id)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_array_equal(got_types, want_types)
    assert rng.random() == np.random.default_rng(0).random()   # nothing was drawn


def test_position_table_extension_matches_the_reference_lines():
    """scripts/train_reranker.py:286-296's arithmetic on a table of 64 rows
    grown to 160 and to 96: bit-equal (the end-to-end test below also holds
    it against the reference script's own checkpoint)."""
    pe = np.random.default_rng(7).standard_normal((64, 32)).astype(np.float32)
    for seq_len, seed in ((160, 0), (96, 3)):
        reps = -(-seq_len // pe.shape[0])
        want = np.concatenate([pe] * reps, axis=0)[:seq_len]
        jit_rng = np.random.default_rng(seed + 17)
        want[pe.shape[0]:] += jit_rng.normal(0, 0.02, want[pe.shape[0]:].shape).astype(
            np.float32)
        got = train_reranker.extend_positions(pe, seq_len, seed)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(got[:64], pe)


def test_checkpoint_reads_alike_in_port_tpu_rag_and_transformers(tmp_path):
    """A trained checkpoint (vocab 800, position table 96) saved by
    RankingTrainer.save: the port's CrossEncoder under the default
    RERANK_MODEL with no spec takes config.json's geometry and gives the
    trainer's logits (not seeded ones), bit for bit on the CPU in f32;
    tpu_rag's HF import (spec given) and transformers'
    BertForSequenceClassification give the same logits within 2e-4."""
    transformers = pytest.importorskip("transformers")
    spec = BertSpec(vocab_size=800, hidden=32, layers=2, heads=4, ffn=64, max_len=96)
    trainer = RankingTrainer(spec, lr=LR, warmup=1, steps=10, group=GROUP, device="cpu")
    rng = np.random.default_rng(8)
    trainer.train_step(*_batch(rng, vocab=800))
    trainer.train_step(*_batch(rng, vocab=800))
    ckpt = tmp_path / "ckpt"
    trainer.save(ckpt)
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["architectures"] == ["BertForSequenceClassification"]
    assert cfg["num_labels"] == 1 and cfg["max_position_embeddings"] == 96

    ce = CrossEncoder(Config().rerank_model, weights_path=str(ckpt), seq_len=256,
                      device="cpu")
    assert ce.spec == spec and ce.seq_len == 96
    ids, mask, types = _batch(np.random.default_rng(9), vocab=800)
    got = ce.forward_ids(ids, mask, types).numpy()
    with torch.no_grad():
        want = trainer.module(*(torch.from_numpy(a).long() for a in (ids, mask, types)))
    np.testing.assert_array_equal(got, want.numpy())
    seeded = CrossEncoder(Config().rerank_model, spec=spec, device="cpu")
    assert not np.allclose(seeded.forward_ids(ids, mask, types).numpy(), got, atol=1e-2)

    jspec = JaxSpec(vocab_size=800, hidden=32, layers=2, heads=4, ffn=64, max_len=96)
    jparams = jax_hf.load_cross_encoder_params(ckpt, jspec)
    jax_logits = np.asarray(JaxCEModule(jspec).apply({"params": jparams}, ids, mask, types))
    np.testing.assert_allclose(got, jax_logits, rtol=0, atol=2e-4)
    hf = transformers.BertForSequenceClassification.from_pretrained(ckpt).eval()
    with torch.no_grad():
        hf_logits = hf(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long(),
                       token_type_ids=torch.from_numpy(types).long()).logits[:, 0]
    np.testing.assert_allclose(got, hf_logits.numpy(), rtol=0, atol=2e-4)

    engine = RagEngine(Config(persist_dir=str(tmp_path / "vs"),
                              kb_db_path=str(tmp_path / "db" / "kb.sqlite3"),
                              db_path=str(tmp_path / "db" / "app.sqlite3"),
                              docs_dir=str(tmp_path / "docs"), device="cpu",
                              embedding_model="tiny", rerank_weights=str(ckpt)))
    try:
        assert engine.get_cross_encoder().spec == spec
    finally:
        engine.shutdown()


# ------------------------------------------------------------ end to end


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """tests/test_reranker_train.py:59-92's corpus and tiny bi-encoder (an
    orbax checkpoint for the reference, the same parameters as a HF
    directory for the port), and the reference script started on them at lr
    0 (its checkpoint then holds its initial trunk: the extended position
    table) in a process of its own as the module starts: it compiles for
    ~30 s while the tests before the end-to-end ones run."""
    tmp = tmp_path_factory.mktemp("rerank_e2e")
    import orbax.checkpoint as ocp

    docs = _corpus_docs()
    corpus = tmp / "corpus.jsonl"
    corpus.write_text("".join(json.dumps(d) + "\n" for d in docs))
    vocab = jax_train_vocab((d["query"] + "\n" + d["body"] for d in docs), vocab_size=800)
    dirs = {"jax": tmp / "bi_jax", "port": tmp / "bi_port"}
    for d in dirs.values():
        d.mkdir()
        jax_save_vocab(vocab, str(d / "vocab.txt"))
    spec = JaxSpec(vocab_size=800, hidden=64, layers=2, heads=4, ffn=128, max_len=64)
    enc = JaxBiEncoder("tiny", tokenizer_path=str(dirs["jax"] / "vocab.txt"), seq_len=48,
                       batch=8, spec=spec)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), enc.params)
    ck = ocp.StandardCheckpointer()
    ck.save(str(dirs["jax"] / "ckpt"), tree, force=True)
    ck.wait_until_finished()
    save_bert(params_from_flax(tree), BertSpec(**{**spec.__dict__}), dirs["port"] / "ckpt")

    flags = ["--steps", "4", "--batch", "8", "--seq-len", "96", "--warmup", "1",
             "--hard-k", "2", "--cand-k", "5"]
    ref_out = tmp / "rr_jax"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "train_reranker.py"),
         "--corpus", str(corpus), "--biencoder", str(dirs["jax"]), "--out", str(ref_out),
         "--lr", "0", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_COMPILATION_CACHE_DIR": str(tmp / "jax_cache")})
    run = {"tmp": tmp, "corpus": corpus, "dirs": dirs, "flags": flags, "proc": proc,
           "ref_out": ref_out}
    yield run
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=60)


@pytest.fixture(scope="module")
def e2e(_reference_run):
    """The port's train_reranker at lr 3e-4 on the CPU beside the reference
    script's run on the same corpus and bi-encoder."""
    run = dict(_reference_run)
    port_out = run["tmp"] / "rr_port"
    report = train_reranker.main(["--corpus", str(run["corpus"]), "--biencoder",
                                  str(run["dirs"]["port"]), "--out", str(port_out),
                                  "--device", "cpu", *run["flags"]])
    _, err = run["proc"].communicate(timeout=600)
    assert run["proc"].returncode == 0, err[-2000:]
    import orbax.checkpoint as ocp

    ref_out = run["ref_out"]
    run.update(ref=json.loads((ref_out / "rerank.json").read_text()),
               ref_params=ocp.StandardCheckpointer().restore(str(ref_out / "ckpt")),
               report=report, out=port_out)
    return run


def _label_kinds(report) -> list[str]:
    return [re.sub(r"alpha=[0-9.]+", "alpha=X", r["label"]) for r in report["results"]]


def test_train_reranker_end_to_end_matches_the_reference(e2e):
    report, ref, out = e2e["report"], e2e["ref"], e2e["out"]
    assert json.loads((out / "rerank.json").read_text()) == json.loads(json.dumps(report))
    assert set(report) == set(ref) and set(report["serving"]) == set(ref["serving"])
    assert _label_kinds(report) == _label_kinds(ref)
    assert report["results"][0]["label"] == "biencoder_top20_no_rerank"
    assert report["results"][0] == ref["results"][0]      # same bi-encoder, same inputs
    for key in ("corpus_docs", "holdout_queries", "train_steps", "batch_pairs",
                "hard_negatives", "mine_rounds"):
        assert report[key] == ref[key], key
    assert report["serving"]["RERANK_WEIGHTS"] == str((out / "ckpt").resolve())
    assert (out / "RERANK.md").read_text().startswith("# Reranker quality")
    ce = CrossEncoder(weights_path=str(out / "ckpt"), device="cpu")
    assert (ce.spec.vocab_size, ce.spec.hidden, ce.spec.max_len) == (800, 64, 96)


def test_position_table_is_bit_equal_to_the_reference_scripts(e2e):
    """The reference's lr-0 checkpoint holds its extended table (64 -> 96);
    the port's reranker_spec builds the same bits from the same trunk."""
    args = train_reranker.parse_args(["--corpus", str(e2e["corpus"]), "--biencoder",
                                      str(e2e["dirs"]["port"]), "--out", "unused",
                                      "--device", "cpu", *e2e["flags"]])
    _, bi_sd = train_reranker.load_biencoder(args, torch.device("cpu"))
    spec, bert = train_reranker.reranker_spec(args, 800, bi_sd)
    assert spec.max_len == 96 and args.seq_len == 96
    want = np.asarray(e2e["ref_params"]["bert"]["position_embeddings"]["embedding"])
    assert want.shape == (96, 64)
    assert np.array_equal(bert["position_embeddings.weight"].numpy(), want)


def test_rerank_gate_reads_the_trained_serving_row(e2e, caplog):
    report, out = e2e["report"], e2e["out"]
    rows = {r["label"]: r for r in report["results"]}
    alpha = report["serving"]["RERANK_ENSEMBLE_ALPHA"]
    serving = rows[f"ensemble_bi+trained_ce(alpha={alpha})"]
    tmp = e2e["tmp"]
    engine = RagEngine(Config(persist_dir=str(tmp / "vs"), kb_db_path=str(tmp / "db" / "kb"),
                              db_path=str(tmp / "db" / "app"), docs_dir=str(tmp / "docs"),
                              device="cpu", embedding_model="tiny", rerank_mode="ensemble",
                              rerank_weights=report["serving"]["RERANK_WEIGHTS"],
                              rerank_ensemble_alpha=alpha))
    try:
        with caplog.at_level("WARNING"):
            verdict = engine._rerank_gate_verdict()
    finally:
        engine.shutdown()
    assert "has no row" not in caplog.text
    want = ("demote" if serving["recall@10"] < rows["biencoder_top20_no_rerank"]["recall@10"]
            else "pass")
    assert verdict == want


def test_missing_biencoder_checkpoint_raises_unless_no_init(e2e, tmp_path):
    """Divergence from tpu_rag, which trains a seeded trunk silently there;
    with --no-biencoder-init a seeded MiniLM-L6 bi-encoder mines, as in
    tpu_rag."""
    empty = tmp_path / "bi"
    empty.mkdir()
    (empty / "vocab.txt").write_bytes((e2e["dirs"]["port"] / "vocab.txt").read_bytes())
    argv = ["--corpus", str(e2e["corpus"]), "--biencoder", str(empty), "--out",
            str(tmp_path / "out"), "--device", "cpu", *e2e["flags"]]
    with pytest.raises(FileNotFoundError, match="no-biencoder-init"):
        train_reranker.main(argv)
    args = train_reranker.parse_args(argv + ["--no-biencoder-init"])
    bi, bi_sd = train_reranker.load_biencoder(args, torch.device("cpu"))
    assert bi_sd is None and (bi.spec.hidden, bi.spec.layers) == (384, 6)
    spec, bert = train_reranker.reranker_spec(args, 800, bi_sd)
    assert bert is None and (spec.vocab_size, spec.max_len) == (800, 128)


def test_train_reranker_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        RankingTrainer(BertSpec(**SPEC), lr=LR, warmup=1, steps=10, group=GROUP)
    corpus = tmp_path / "c.jsonl"
    corpus.write_text(json.dumps(_corpus_docs(1)[0]) + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        train_reranker.main(["--corpus", str(corpus), "--biencoder", str(tmp_path),
                             "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
