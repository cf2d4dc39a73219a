"""Seeded texts for every traffic mix: one general generator that the
traffic files parameterise.

Words are the whole lower-case words of perfbench/data/wordpiece_vocab.txt,
so each is one WordPiece token and a text of n words is n tokens long.  A
length spec gives a measured length's quantiles at evenly spaced
probabilities (`quantiles`, the first at 0 and the last at 1) and may cap
them (`max`).  The set of lengths is the same for every seed (the
quantile function, interpolated, at (i + 0.5) / n) and the seed sets their
order and the words, so seeds change the texts and not the amount of work.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

VOCAB = Path(__file__).resolve().parent / "data" / "wordpiece_vocab.txt"


def words(vocab: Path = VOCAB) -> np.ndarray:
    """The vocabulary's whole lower-case words, in file order."""
    lines = vocab.read_text(encoding="utf-8").splitlines()
    return np.array([w for w in lines if re.fullmatch(r"[a-z]+", w)])


def lengths(n: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    """n lengths: the spec's quantile function at (i + 0.5) / n, capped at
    its `max`, in the order the seed's rng gives."""
    q = np.asarray(spec["quantiles"], np.float64)
    out = np.rint(np.interp((np.arange(n) + 0.5) / n, np.linspace(0.0, 1.0, len(q)), q))
    out = np.minimum(out, spec.get("max", q[-1])).astype(np.int64)
    return out[rng.permutation(n)]


def word_ids(lens: np.ndarray, n_words: int, rng: np.random.Generator) -> list[np.ndarray]:
    """One array of uniform word indices a length."""
    flat = rng.integers(0, n_words, size=int(lens.sum()))
    return np.split(flat, np.cumsum(lens)[:-1])


def join(vocab_words: np.ndarray, ids: np.ndarray) -> str:
    return " ".join(vocab_words[ids].tolist())
