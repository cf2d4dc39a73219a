"""Seeded traffic: the same seed gives the same texts; every seed gives
the same set of lengths, in its own order, and the lengths follow the
measured quantiles."""

import json

import numpy as np

from perfbench import harness, textgen
from perfbench.drivers.train import corpus
from perfbench.reference.tokenizer import WordPiece

TRAIN = harness.traffic_of(harness.PKG, "train")


def test_lengths_are_one_multiset_in_the_seeds_order():
    spec = {"quantiles": [3, 5, 6, 9, 16]}
    a = textgen.lengths(1000, spec, np.random.default_rng(1))
    b = textgen.lengths(1000, spec, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() == 3 and a.max() == 16 and np.median(a) == 6


def test_lengths_follow_the_measured_quantiles_and_the_cap():
    spec = TRAIN["body_tokens"]
    lens = textgen.lengths(TRAIN["docs"], spec, np.random.default_rng(3))
    q = spec["quantiles"]
    for pct in (5, 25, 50, 75, 95):
        assert abs(np.percentile(lens, pct) - min(q[pct], spec["max"])) <= 1
    assert lens.max() == spec["max"] and lens.min() == q[0]


def test_texts_are_as_many_tokens_as_their_lengths():
    tr = dict(TRAIN, docs=200)
    big = 2**31 + 12345
    docs = corpus(tr, big)
    assert docs == corpus(tr, big) and docs != corpus(tr, big + 1)
    tok = WordPiece(textgen.VOCAB)
    lens = sorted(len(tok.ids(d["body"])) for d in docs)
    assert lens == sorted(textgen.lengths(200, tr["body_tokens"], np.random.default_rng(0)))
    vocab = set(textgen.words())
    assert all(w in vocab for d in docs[:50] for w in d["body"].split() + d["query"].split())


def test_the_traffic_file_says_where_its_lengths_come_from():
    raw = json.loads((harness.PKG / "traffic" / "train.json").read_text())
    assert "make_corpus" in raw["measured"]
    assert len(raw["body_tokens"]["quantiles"]) == len(raw["summary_tokens"]["quantiles"]) == 101
