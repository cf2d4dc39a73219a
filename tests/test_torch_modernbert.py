"""ModernBERT in the port (models/modernbert.py) against the plain f32
reference (tpu_rag_torch/reference/modernbert.py) on the CPU, at a small
shape with both kinds of layer: hidden 64, 4 heads of 16, 6 layers (two
whole periods of global, local, local), a local window of 8 (keys within
4), at T 40 (the band narrower than T) and T 6 (wider), with padded rows.

Tolerances, each for a reason:
- the trunk, f32 on both sides: 2e-5 of the largest hidden value (8e-5
  absolute at these sizes; it reads 2.6e-6): the only differences are the
  order of the products' sums, SDPA's fused softmax and the band's blocks;
- the band against the dense masked attention: 1e-6 absolute, on outputs
  and gradients of unit-scale inputs: the same pairs, summed in another
  order;
- a training step's loss, rel 1e-5, and each leaf's gradient, 1e-4 of
  the leaf's norm: the loss divides by tau 0.05, which scales the trunk's
  rounding by 20, and the gradient rounds once more in the backward;
- the checkpoint round trip and the reference against transformers'
  ModernBertModel: exact, the same tensors and the same arithmetic.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_rag_torch.models import modernbert as mb
from tpu_rag_torch.models.biencoder import MODEL_SPECS, BiEncoder, init_params, spec_for_model
from tpu_rag_torch.models.hf_export import save_bert
from tpu_rag_torch.models.hf_import import load_bert_params, spec_from_hf_config
from tpu_rag_torch.models.tokenizer import load_tokenizer
from tpu_rag_torch.ops import ragged_attention as ra
from tpu_rag_torch.reference import modernbert as ref
from tpu_rag_torch.scripts import train_semantic
from tpu_rag_torch.train.contrastive import ContrastiveTrainer, info_nce_loss
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
from tpu_rag_torch.utils.timing import SPANS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VOCAB = REPO / "examples" / "vocab.txt"
SPEC = mb.ModernBertSpec(vocab_size=30522, hidden=64, layers=6, heads=4, ffn=96, max_len=64,
                         window=8)
CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 6, "norm_eps": 1e-5,
       "local_attention": 8, "global_attn_every_n_layers": 3, "global_rope_theta": 160000.0,
       "local_rope_theta": 10000.0}


def _weights(seed: int = 3) -> dict[str, torch.Tensor]:
    """init_params, with LayerNorm scales drawn around 1 so that each one
    takes part in the comparison."""
    sd = init_params(SPEC, seed)
    g = torch.Generator().manual_seed(seed)
    return {k: 1 + 0.1 * torch.randn(v.shape, generator=g) if v.dim() == 1 else v
            for k, v in sd.items()}


def _rows(t: int, seed: int = 1, b: int = 3):
    """(B, T) ids and a 0/1 mask of real prefixes: T, about T / 2 and 2
    tokens long."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, 2000, (b, t), generator=g)
    lens = torch.tensor([t, max(2, t // 2), 2][:b])
    mask = (torch.arange(t)[None, :] < lens[:, None]).to(torch.int32)
    return ids * mask, mask


def _encoder(sd=None) -> mb.ModernBertEncoder:
    m = mb.ModernBertEncoder(SPEC)
    m.load_state_dict(_weights() if sd is None else sd)
    return m.eval()


@pytest.mark.parametrize("t", [40, 6])
def test_trunk_matches_the_reference(t):
    sd = _weights()
    ids, mask = _rows(t)
    with torch.no_grad():
        got = _encoder(sd)(ids, mask)
        want = ref.hidden_states(sd, CFG, ids, mask)
    real = mask.bool()
    scale = float(want[real].abs().max())
    assert float((got - want)[real].abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("t", [40, 6])
def test_reference_is_transformers_modernbert(t, tmp_path):
    """The plain reference against transformers' own ModernBertModel
    (eager attention) on the port's exported checkpoint."""
    from transformers import ModernBertModel

    sd = _weights()
    save_bert(sd, SPEC, tmp_path)
    hf = ModernBertModel.from_pretrained(tmp_path, attn_implementation="eager").eval()
    ids, mask = _rows(t)
    with torch.no_grad():
        theirs = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        mine = ref.hidden_states(sd, CFG, ids, mask)
    real = mask.bool()
    assert torch.equal(theirs[real], mine[real])


@pytest.mark.parametrize("t", [40, 6, 8, 9])
def test_band_equals_dense_masked_attention(t):
    """band_attention against SDPA over the whole (T, T) mask |i - j| <= w
    and key real, forward and backward, on the real query rows."""
    w, b, h, d = 4, 3, 2, 8
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(b, t, h, d, generator=g, requires_grad=True) for _ in range(3))
    _, mask = _rows(t, b=b)
    pos = torch.arange(t)
    keep = ((pos[:, None] - pos[None, :]).abs() <= w)[None, None] & (mask > 0)[:, None, None, :]
    dense = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), attn_mask=keep).transpose(1, 2)
    band = ra.band_attention(q, k, v, ra.band_bias(mask, w, torch.float32), w)
    real = mask.bool()
    torch.testing.assert_close(band[real], dense[real], rtol=0, atol=1e-6)
    r = torch.randn(band.shape, generator=g) * mask[:, :, None, None]
    want = torch.autograd.grad((dense * r).sum(), (q, k, v))
    got = torch.autograd.grad((band * r).sum(), (q, k, v))
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-6)


def test_attention_counts_match_a_count_of_the_pairs():
    lens, t, w = [40, 17, 5, 2, 0], 40, SPEC.window // 2
    local, glob, real = mb.attention_counts(SPEC, lens, t)
    n_global = sum(SPEC.is_global(i) for i in range(SPEC.layers))
    assert n_global == 2
    assert local == 4 * len(lens) * 40 * 12 and glob == 2 * len(lens) * 40 * 40
    band = sum(1 for n in lens for i in range(n) for j in range(n) if abs(i - j) <= w)
    assert real == 4 * band + 2 * sum(n * n for n in lens)
    # at ModernBERT-large's sizes the band scores 192 keys a query row
    big = MODEL_SPECS["modernbert-large"]
    local, _, _ = mb.attention_counts(big, [4096], 4096)
    assert local / (18 * 4096) == 192


def _batch(seed: int = 7, b: int = 4, tq: int = 6, td: int = 40) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for side, t in (("q", tq), ("d", td)):
        n = rng.integers(2, t + 1, b)
        mask = (np.arange(t)[None, :] < n[:, None]).astype(np.int32)
        out[f"{side}_ids"] = rng.integers(5, 2000, (b, t)).astype(np.int32) * mask
        out[f"{side}_mask"] = mask
    return out


def test_a_training_step_matches_the_reference():
    """One ContrastiveTrainer step (f32 on the CPU): its loss and every
    leaf's gradient (AdamW's first moment after one step, over 1 - beta1)
    against autograd through the reference's embeddings; the step adds the
    attention's counts from the batch's masks."""
    sd = _weights()
    batch = _batch()
    tr = ContrastiveTrainer(SPEC, lr=1e-3, tau=0.05, device="cpu")
    assert isinstance(tr.module, mb.ModernBertEncoder) and tr.module.remat
    tr.module.load_state_dict(sd)
    before = [GLOBAL_METRICS.counter(n) for n in ("attn_local_key_slots_total",
                                                  "attn_global_key_slots_total",
                                                  "attn_real_pairs_total")]
    loss = tr.train_step(batch)
    after = [GLOBAL_METRICS.counter(n) for n in ("attn_local_key_slots_total",
                                                 "attn_global_key_slots_total",
                                                 "attn_real_pairs_total")]
    counts = [sum(x) for x in zip(*(mb.attention_counts(SPEC, batch[k].sum(1), batch[k].shape[1])
                                    for k in ("q_mask", "d_mask")))]
    assert [a - b for a, b in zip(after, before)] == counts

    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    t = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}
    want_loss = info_nce_loss(ref.embed(params, CFG, t["q_ids"], t["q_mask"]),
                              ref.embed(params, CFG, t["d_ids"], t["d_mask"]), 0.05)
    grads = dict(zip(params, torch.autograd.grad(want_loss, list(params.values()))))
    assert loss == pytest.approx(float(want_loss.detach()), rel=1e-5)
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    for k, p in tr.module.named_parameters():
        got = tr.optimizer.state[p]["exp_avg"] / (1 - beta1)
        torch.testing.assert_close(got, grads[k], rtol=0, atol=1e-4 * float(grads[k].norm()))


def test_the_trainer_refuses_a_mesh():
    from tpu_rag_torch.parallel.mesh import mesh_from_spec

    with pytest.raises(ValueError, match="tensor-parallel"):
        ContrastiveTrainer(SPEC, device="cpu", mesh=mesh_from_spec("data:2", ["cpu"] * 2))
    with pytest.raises(ValueError, match="tensor-parallel"):
        BiEncoder("modernbert-large", spec=SPEC, device="cpu", dtype="float32",
                  state_dict=_weights(), mesh=mesh_from_spec("model:2", ["cpu"] * 2))


def test_biencoder_embeds_as_the_reference(tmp_path):
    """BiEncoder with a ModernBERT spec (given, and read from an exported
    checkpoint's config.json) embeds texts as the reference does on the
    same token ids; the name alone picks ModernBERT-large."""
    assert spec_for_model("answerdotai/ModernBERT-large") == MODEL_SPECS["modernbert-large"]
    sd = _weights()
    texts = ["the moon temple stands on the silver cliff", "a", "rust and iron " * 9]
    enc = BiEncoder("modernbert-large", spec=SPEC, tokenizer_path=str(VOCAB), seq_len=64,
                    batch=8, device="cpu", dtype="float32", state_dict=sd)
    got = enc.embed(texts)
    save_bert(sd, SPEC, tmp_path)
    again = BiEncoder("modernbert-large", weights_path=str(tmp_path), tokenizer_path=str(VOCAB),
                      seq_len=64, batch=8, device="cpu", dtype="float32").embed(texts)
    tok = load_tokenizer(str(VOCAB))
    rows = [[tok.cls_id, *tok.tokenize_ids(s)[:62], tok.sep_id] for s in texts]
    ids = torch.zeros((len(rows), 64), dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
    with torch.no_grad():
        want = ref.embed(sd, CFG, ids, (ids != tok.pad_id).to(torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(again, got)


def test_checkpoint_round_trip(tmp_path):
    """Export under HF ModernBertModel's names and config keys, import
    back; ModernBertForMaskedLM's "model." names load too."""
    sd = _weights()
    save_bert(sd, SPEC, tmp_path / "a")
    assert spec_from_hf_config(tmp_path / "a") == SPEC
    back = load_bert_params(tmp_path / "a", SPEC)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    masked = {"model." + k: v for k, v in sd.items()} | {"head.dense.weight": torch.ones(2, 2)}
    (tmp_path / "b").mkdir()
    torch.save(masked, tmp_path / "b" / "pytorch_model.bin")
    back = load_bert_params(tmp_path / "b", SPEC)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_spans_name_each_kind_of_attention():
    ids, mask = _rows(40)
    SPANS.enable()
    try:
        SPANS.drain()
        with torch.no_grad():
            _encoder()(ids, mask)
        spans, _ = SPANS.drain()
    finally:
        SPANS.disable()
    names = [s.name for s in spans]
    assert names.count("modernbert.attn_global") == 2
    assert names.count("modernbert.attn_local") == 4


def _corpus(n: int = 300, seed: int = 5) -> list[dict]:
    """Documents of whole vocabulary words, 3 to 600 words a body, and a
    summary of some of them or none."""
    words = [w for w in VOCAB.read_text().splitlines() if w.isalpha() and w.islower()]
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        body = rng.choice(words, size=int(rng.integers(3, 600)))
        summ = body[:int(rng.integers(0, 12))]
        docs.append({"id": f"d{i}", "query": " ".join(summ), "body": " ".join(body)})
    return docs


def _digest(draw, n: int) -> str:
    h = hashlib.sha256()
    for _ in range(n):
        batch = draw()
        for k in ("q_ids", "q_mask", "d_ids", "d_mask"):
            h.update(k.encode())
            h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def test_the_sampler_draws_the_same_minilm_batches_at_its_defaults():
    """train_semantic at its defaults (MiniLM-L6, bodies cut at 320) draws
    the batches it drew before --model and --body-cut existed: the digest
    was taken from the parent revision's batch_sampler on this corpus."""
    args = train_semantic.parse_args(["--corpus", "c", "--out", "o", "--batch", "32"])
    assert args.model == "minilm-l6" and args.body_cut == 320
    spec = train_semantic.semantic_spec(args)
    assert spec == MODEL_SPECS["minilm-l6"].__class__(hidden=384, layers=6, heads=12, ffn=1536,
                                                      vocab_size=30522, max_len=128)
    draw = train_semantic.batch_sampler(_corpus(), load_tokenizer(str(VOCAB)), args)
    assert _digest(draw, 6) == "24317e38e1717572091ddb8fb333fe33e2d1897d46a95fc9140c8cade7af673c"


def test_the_sampler_reaches_a_body_cut_of_8192():
    """--body-cut 8192: document windows come from a body's first 8,192
    tokens; a window wider than that (--seq-len 16,386) takes all of them
    and no more.  ModernBERT-large holds --seq-len 8192."""
    args = train_semantic.parse_args(["--corpus", "c", "--out", "o", "--model",
                                      "modernbert-large", "--seq-len", "8192", "--q-len", "64",
                                      "--body-cut", "8192"])
    assert train_semantic.semantic_spec(args) == MODEL_SPECS["modernbert-large"]
    words = [w for w in VOCAB.read_text().splitlines() if w.isalpha() and w.islower()]
    body = " ".join(words[i % len(words)] for i in range(9000))
    tok = load_tokenizer(str(VOCAB))
    toks = tok.tokenize_ids(body)
    assert len(toks) == 9000
    args.seq_len, args.batch, args.seed = 16386, 1, 4
    draw = train_semantic.batch_sampler([{"id": "x", "query": "", "body": body}], tok, args)
    rows = []
    for _ in range(8):
        b = draw()
        rows.append([int(x) for x in b["d_ids"][0, 1:int(b["d_mask"][0].sum()) - 1]])
    assert max(len(r) for r in rows) == 8192
    assert all(r == toks[:8192] for r in rows if len(r) == 8192)


def test_semantic_spec_refuses_what_modernbert_cannot_hold():
    args = train_semantic.parse_args(["--corpus", "c", "--out", "o", "--model",
                                      "modernbert-large", "--seq-len", "16384"])
    with pytest.raises(SystemExit):
        train_semantic.semantic_spec(args)


def test_the_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys\n"
            "for n in ('jax', 'tpu_rag', 'tpu_rag_torch.models', 'tpu_rag_torch.ops'):\n"
            "    sys.modules[n] = None\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import tpu_rag_torch.reference.modernbert\n"
            "assert sorted(m for m, v in sys.modules.items() if v is not None\n"
            "              and m.startswith('tpu_rag_torch')) == "
            "['tpu_rag_torch', 'tpu_rag_torch.reference', 'tpu_rag_torch.reference.modernbert']\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

