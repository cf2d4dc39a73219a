"""ModernBERT's training step on the card (each test skips without one).

This file imports no JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest tests/test_torch_modernbert_card.py -q`.

- The step replayed from a CUDA graph against the same steps run eagerly,
  as tests/test_torch_train_graph.py holds BERT's: a narrow spec with both
  kinds of layer (hidden 128, 2 heads of 64, 3 layers: global, local,
  local; a window of 16) at batch 8, query length 16 and document length
  80, bf16.  Deterministic algorithms are on (the fused attention's
  backward otherwise sums in an order that varies between runs), so
  losses, parameters and AdamW's first moments agree bit for bit.
- One step at the published context, T 8,192, batch 4, at ModernBERT-
  large's widths and one whole period of its layers (3 of 28): finite, and
  its loss within 2e-3 of the f32 reference's (relative; bf16 products
  over 8,192 positions against f32, three layers deep).
"""

import numpy as np
import pytest
import torch

from tpu_rag_torch.models.modernbert import ModernBertEncoder, ModernBertSpec
from tpu_rag_torch.reference import modernbert as ref
from tpu_rag_torch.train.contrastive import ContrastiveTrainer, info_nce_loss, warmup_cosine_decay
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

pytestmark = pytest.mark.cuda

SPEC = ModernBertSpec(vocab_size=512, hidden=128, layers=3, heads=2, ffn=192, max_len=128,
                      window=16)
B, TQ, TD = 8, 16, 80
COUNTERS = ("train_eager_steps_total", "train_graph_captures_total",
            "train_graph_replays_total")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured only there")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield torch.device("cuda")
    finally:
        torch.use_deterministic_algorithms(False)


def _batch(rng, spec=SPEC, b: int = B, tq: int = TQ, td: int = TD, lens=None) -> dict:
    """int32 numpy rows as train_semantic's sampler draws them: a real
    prefix of 2..T tokens (or `lens` for the documents), then pad."""
    out = {}
    for side, t in (("q", tq), ("d", td)):
        n = rng.integers(2, t + 1, b) if side == "q" or lens is None else np.asarray(lens)
        mask = (np.arange(t)[None, :] < n[:, None]).astype(np.int32)
        out[f"{side}_ids"] = rng.integers(4, spec.vocab_size, (b, t)).astype(np.int32) * mask
        out[f"{side}_mask"] = mask
    return out


def _trainer(card, start=None, spec=SPEC) -> ContrastiveTrainer:
    tr = ContrastiveTrainer(spec, lr=warmup_cosine_decay(0.0, 1e-3, 2, 20, 2e-5),
                            compute_dtype=torch.bfloat16, seed=3, device=card)
    if start is not None:
        tr.module.load_state_dict(start)
    return tr


def _state(tr, start) -> list:
    return [{k: p.detach() - start[k] for k, p in tr.module.named_parameters()},
            {k: tr.optimizer.state[p]["exp_avg"].clone()
             for k, p in tr.module.named_parameters()}]


def _eager(card, batches, start) -> list:
    tr = _trainer(card, start)
    losses = []
    for b in batches:
        losses.append(float(tr._eager_step(b).detach()))
        tr.step += 1
    return [losses] + _state(tr, start)


def _same(a, b) -> bool:
    if isinstance(a, list):
        return a == b
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_replayed_steps_match_eager_steps(card):
    """8 steps of one shape: 1 eager, 1 captured and replayed, 6 replayed,
    against 8 eager steps from the same parameters and batches."""
    rng = np.random.default_rng(21)
    batches = [_batch(rng) for _ in range(8)]
    start = _trainer(card).module.state_dict()
    c0 = [GLOBAL_METRICS.counter(n) for n in COUNTERS]
    tr = _trainer(card, start)
    assert isinstance(tr.module, ModernBertEncoder)
    got = [[tr.train_step(b) for b in batches]] + _state(tr, start)
    assert [GLOBAL_METRICS.counter(n) - c for n, c in zip(COUNTERS, c0)] == [1, 1, 7]
    want, again = _eager(card, batches, start), _eager(card, batches, start)
    assert all(_same(x, y) for x, y in zip(again, want)), "two eager runs differ"
    assert [_same(x, y) for x, y in zip(got, want)] == [True] * 3


def test_a_step_at_the_published_context(card):
    """B 4 at T 8,192 (documents of 8,192, 6,000, 3,000 and 100 real
    tokens), ModernBERT-large's widths, 3 layers: the trainer's first step
    is finite and its loss matches the f32 reference's, rows run one at a
    time at their real lengths."""
    spec = ModernBertSpec(layers=3)
    cfg = {"hidden_size": spec.hidden, "num_attention_heads": spec.heads, "num_hidden_layers": 3,
           "norm_eps": spec.ln_eps, "local_attention": spec.window,
           "global_attn_every_n_layers": spec.global_every,
           "global_rope_theta": spec.global_rope_theta, "local_rope_theta": spec.local_rope_theta}
    batch = _batch(np.random.default_rng(5), spec, b=4, tq=64, td=8192,
                   lens=[8192, 6000, 3000, 100])
    tr = _trainer(card, spec=spec)
    start = {k: v.clone() for k, v in tr.module.state_dict().items()}
    loss = tr.train_step(batch)
    assert np.isfinite(loss)
    assert all(torch.isfinite(tr.optimizer.state[p]["exp_avg"]).all()
               for p in tr.module.parameters())
    emb = {}
    with torch.no_grad(), ref.f32_matmul():
        for side in ("q", "d"):
            ids = torch.as_tensor(batch[f"{side}_ids"], dtype=torch.int64, device=card)
            mask = torch.as_tensor(batch[f"{side}_mask"], device=card)
            emb[side] = torch.cat([ref.embed(start, cfg, ids[r:r + 1, :int(mask[r].sum())],
                                             mask[r:r + 1, :int(mask[r].sum())])
                                   for r in range(4)])
        want = float(info_nce_loss(emb["q"], emb["d"], 0.05))
    assert loss == pytest.approx(want, rel=2e-3)
