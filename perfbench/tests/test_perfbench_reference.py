"""The plain reference against the port at small widths on the CPU: the
same seeded weights and texts give the same tokens, batches and training
steps (the port runs f32 on the CPU, so they agree to rounding)."""

import numpy as np
import pytest
import torch
from conftest import tiny_parts

from perfbench import common, judge, textgen, weights
from perfbench.drivers.train import corpus, sampler_args
from perfbench.reference import train
from perfbench.reference.tokenizer import WordPiece


def test_reference_tokenizer_matches_the_port():
    from tpu_rag_torch.models.tokenizer import load_tokenizer

    port = load_tokenizer(str(textgen.VOCAB))
    ref = WordPiece(textgen.VOCAB)
    _, _, _, _, tr = tiny_parts("minilm-l6-1m.train")
    texts = [t for d in corpus(tr, 3)[:100] for t in (d["query"], d["body"])]
    texts += ["Hello, World!  naïve café_au lait 42", "moon-temple CJK 月之殿"]
    assert [ref.ids(t) for t in texts] == [port.tokenize_ids(t) for t in texts]
    assert ref.special == (port.cls_id, port.sep_id, port.pad_id)


def test_seeded_weights_fit_the_ports_encoder():
    from tpu_rag_torch.models.bert import BertEncoder

    _, _, _, cfg, _ = tiny_parts("minilm-l6-1m.train")
    w = weights.seeded_bert(cfg, 5, "cpu")
    sd = BertEncoder(common.port_spec(cfg)).state_dict()
    assert {k: tuple(v.shape) for k, v in w.items()} == {k: tuple(v.shape) for k, v in sd.items()}
    again = weights.seeded_bert(cfg, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_reference_steps_match_the_ports_trainer():
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay

    _, _, _, cfg, tr = tiny_parts("minilm-l6-1m.train")
    tcfg = cfg["train"]
    docs = corpus(tr, 3)
    tok = WordPiece(textgen.VOCAB)
    batches = train.batches(docs, tok.ids, tcfg, 3, tok.special, 3)
    w = weights.seeded_bert(cfg, 3, "cpu")
    lr = warmup_cosine_decay(0.0, tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    trainer = ContrastiveTrainer(common.port_spec(cfg), lr=lr, tau=tcfg["tau"], device="cpu")
    trainer.module.load_state_dict(w)
    start = {k: p.detach().clone() for k, p in trainer.module.named_parameters()}
    losses = [trainer.train_step(b) for b in batches]
    ref = train.three_steps(w, cfg, [{k: torch.as_tensor(v, dtype=torch.int64)
                                      for k, v in b.items()} for b in batches], tcfg)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    keep = judge.kept_leaves(ref["grad"])              # key biases: no gradient but round-off
    assert sorted(set(ref["grad"]) - set(keep)) == ["layers.0.attention.key.bias",
                                                    "layers.1.attention.key.bias"]
    for k, p in trainer.module.named_parameters():
        if k not in keep:
            continue
        assert float((p.detach() - start[k]).norm()) == pytest.approx(ref["update"][k],
                                                                      rel=1e-3, abs=1e-9)
    mine = train.schedule(tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    assert [mine(i) for i in range(12)] == pytest.approx([lr(i) for i in range(12)])


def test_reference_batches_are_the_ports_sampler_draws():
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts.train_semantic import batch_sampler

    _, _, _, cfg, tr = tiny_parts("minilm-l6-1m.train")
    tcfg = dict(cfg["train"], batch=64)
    docs = corpus(tr, 2**31 + 5)
    docs[7]["query"] = ""                                # an empty summary: always a crop
    port = batch_sampler(docs, load_tokenizer(str(textgen.VOCAB)), sampler_args(tcfg, 2**31 + 5))
    tok = WordPiece(textgen.VOCAB)
    ref = train.batches(docs, tok.ids, tcfg, 2**31 + 5, tok.special, 4)
    for r in ref:
        p = port()
        assert set(p) == set(r) and all(np.array_equal(p[k], r[k]) for k in r)
    d = ref[0]["d_mask"].sum(1) - 2
    q = ref[0]["q_mask"].sum(1) - 2
    assert d.min() >= 1 and d.max() <= tcfg["doc_len"] - 2 and q.max() <= tcfg["query_len"] - 2
