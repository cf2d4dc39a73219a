"""Corpus-driven WordPiece vocabulary builder (port of tpu_rag/models/vocab_train.py).

Air-gapped deployments have no pretrained vocab files, so the framework can build one from the corpus being indexed: BERT-style
specials + every seen character (with ## continuations) + the most frequent
words and suffix pieces.  Greedy longest-match WordPiece over this vocab
then degrades gracefully to characters for rare words — self-consistent
between index and query time, and usable by the JAX package's C++ fast
path (tpu_rag/native/wordpiece.cc).  Same list, same file bytes as
tpu_rag's builder.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

from tpu_rag_torch.models.tokenizer import pretokenize

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def train_wordpiece_vocab(
    texts,
    *,
    vocab_size: int = 30522,
    min_freq: int = 2,
    max_suffix_len: int = 6,
) -> list[str]:
    """Build a vocab list (index = token id) from an iterable of texts."""
    word_freq: Counter[str] = Counter()
    for text in texts:
        word_freq.update(pretokenize(text))

    char_freq: Counter[str] = Counter()
    suffix_freq: Counter[str] = Counter()
    for word, freq in word_freq.items():
        for ch in word:
            char_freq[ch] += freq
        # suffix pieces (##xyz) make longest-match split long/rare words well
        # (up to max_suffix_len chars INCLUSIVE, shorter than the word)
        for ln in range(1, min(max_suffix_len, len(word) - 1) + 1):
            suffix_freq["##" + word[-ln:]] += freq

    vocab: list[str] = list(SPECIALS)
    seen = set(vocab)

    def add(tok: str) -> None:
        if tok and tok not in seen and len(vocab) < vocab_size:
            vocab.append(tok)
            seen.add(tok)

    # all characters first (guarantees char-level fallback coverage)
    for ch, _ in char_freq.most_common():
        add(ch)
        add("##" + ch)
    # then frequent whole words
    for word, freq in word_freq.most_common():
        if freq < min_freq:
            break
        add(word)
    # then frequent suffixes
    for suf, freq in suffix_freq.most_common():
        if freq < min_freq or len(vocab) >= vocab_size:
            break
        add(suf)
    return vocab


def save_vocab(vocab: list[str], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(vocab), encoding="utf-8")
