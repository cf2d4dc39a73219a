"""Tokenizers feeding fixed-shape batches to the TPU encoders.

The reference relies on HuggingFace tokenizers (Rust) inside
sentence-transformers (SURVEY.md §2.4).  Here tokenization is host-side and
first-party, with three interchangeable implementations:

- WordPieceTokenizer: greedy longest-match WordPiece over a vocab.txt
  (BERT-compatible).  Uses the C++ fast path (native/wordpiece.cc, built
  with g++ at first use) when it builds, pure Python otherwise; `backend`
  says which, and a fall back logs why, once a process.
- HashTokenizer: deterministic vocab-free fallback for environments with no
  vocab file (e.g. this image): words and CJK characters hash into a fixed
  id space.  Index and query use the same mapping, so retrieval is
  self-consistent even without pretrained weights.
- HF `tokenizers` library when a tokenizer.json is configured (optional).

All produce (ids, mask[, type_ids]) int32 arrays of a *static* (batch, seq)
shape, so the encoder runs a few fixed sequence buckets.
"""

from __future__ import annotations

import hashlib
import logging
import unicodedata
from pathlib import Path

import numpy as np

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
N_SPECIAL = 4


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x3040 <= cp <= 0x30FF   # kana
        or 0xAC00 <= cp <= 0xD7AF   # hangul
    )


def pretokenize(text: str) -> list[str]:
    """Lowercase, NFKC-normalize, split CJK per character and latin on
    non-alphanumerics. Shared by all tokenizer implementations."""
    text = unicodedata.normalize("NFKC", text).lower()
    tokens: list[str] = []
    word: list[str] = []

    def flush():
        if word:
            tokens.append("".join(word))
            word.clear()

    for ch in text:
        if _is_cjk(ch):
            flush()
            tokens.append(ch)
        elif ch.isalnum() or ch == "_":
            word.append(ch)
        else:
            flush()
    flush()
    return tokens


class HashTokenizer:
    """Vocab-free deterministic tokenizer: stable 64-bit hash -> id bucket."""

    name = "hash"

    def __init__(self, vocab_size: int = 30522) -> None:
        self.vocab_size = vocab_size
        self._cache: dict[str, int] = {}

    def _hash_id(self, token: str) -> int:
        got = self._cache.get(token)
        if got is None:
            h = int.from_bytes(hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "little")
            got = N_SPECIAL + h % (self.vocab_size - N_SPECIAL)
            if len(self._cache) < 2_000_000:
                self._cache[token] = got
        return got

    def tokenize_ids(self, text: str) -> list[int]:
        return [self._hash_id(t) for t in pretokenize(text)]


class WordPieceTokenizer:
    """BERT-compatible greedy WordPiece over a vocab.txt."""

    name = "wordpiece"

    def __init__(self, vocab_path: str | Path, max_word_chars: int = 100) -> None:
        text = Path(vocab_path).read_text(encoding="utf-8")
        lines = text.splitlines()
        self.vocab = {tok: i for i, tok in enumerate(lines)}
        self.vocab_size = len(lines)
        self.max_word_chars = max_word_chars
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self._native = _load_native(vocab_path, text, lines, self)
        self.backend = "python" if self._native is None else "native"

    def tokenize_ids(self, text: str) -> list[int]:
        if self._native is not None:
            return self._native.tokenize_ids(text)
        ids: list[int] = []
        for word in pretokenize(text):
            if len(word) > self.max_word_chars:
                ids.append(self.unk_id)
                continue
            start = 0
            pieces: list[int] = []
            bad = False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    pid = self.vocab.get(piece)
                    if pid is not None:
                        cur = pid
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            ids.extend([self.unk_id] if bad else pieces)
        return ids


_fallbacks_logged: set[str] = set()


def _load_native(vocab_path, text: str, lines: list[str], tok: WordPieceTokenizer):
    """The C++ WordPiece over vocab_path (native/binding.py), or None where
    it would not give the Python path's ids or does not build or load; the
    reason is logged once a process."""
    if tok.max_word_chars != 100:
        reason = f"max_word_chars {tok.max_word_chars} (the C++ path cuts at 100)"
    elif len(tok.vocab) != len(lines):
        reason = "duplicate vocab lines (Python keeps the last id, C++ the first)"
    elif [ln[:-1] if ln.endswith("\r") else ln
          for ln in text.split("\n")][:len(lines)] != lines:
        reason = "a line break in the vocab that only str.splitlines() splits on"
    else:
        from tpu_rag_torch.native.binding import NativeWordPiece

        try:
            return NativeWordPiece(str(vocab_path))
        except (OSError, RuntimeError) as e:
            reason = str(e) or type(e).__name__
    if reason not in _fallbacks_logged:
        _fallbacks_logged.add(reason)
        logging.getLogger("tpu_rag_torch").warning(
            "native WordPiece not used (%s); tokenizing in Python", reason)
    return None


class HFTokenizerAdapter:
    """Wraps a HuggingFace `tokenizers` Tokenizer (when tokenizer.json exists)."""

    name = "hf"

    def __init__(self, path: str | Path) -> None:
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(str(path))
        self.vocab_size = self._tok.get_vocab_size()
        cls = self._tok.token_to_id("[CLS]")
        sep = self._tok.token_to_id("[SEP]")
        self.cls_id = CLS_ID if cls is None else cls
        self.sep_id = SEP_ID if sep is None else sep
        # look the pad token up like [CLS]/[SEP]: id 0 is a REAL token in
        # BPE/RoBERTa-style vocabs, and the mask-free serving path treats
        # every pad_id position as padding (ids != pad_id)
        pad = self._tok.token_to_id("[PAD]")
        if pad is None:
            pad = self._tok.token_to_id("<pad>")
        self.pad_id = 0 if pad is None else pad

    def tokenize_ids(self, text: str) -> list[int]:
        enc = self._tok.encode(text, add_special_tokens=False)
        return list(enc.ids)


def load_tokenizer(path: str = "", vocab_size: int = 30522):
    """tokenizer.json -> HF adapter; vocab.txt -> WordPiece; else HashTokenizer."""
    if path:
        p = Path(path)
        if p.is_dir():
            if (p / "tokenizer.json").is_file():
                p = p / "tokenizer.json"
            elif (p / "vocab.txt").is_file():
                p = p / "vocab.txt"
        if p.is_file() and p.suffix == ".json":
            try:
                return HFTokenizerAdapter(p)
            except Exception as e:
                # do NOT fall through to WordPiece: it would treat each JSON
                # text line as a vocab token and silently produce a garbage
                # vocabulary (every real word -> UNK).  Hash fallback keeps
                # serving functional and the warning makes the reason loud.
                import logging
                logging.getLogger("tpu_rag_torch").warning(
                    "failed to load HF tokenizer %s (%s); falling back to "
                    "hash tokenizer", p, e)
                return HashTokenizer(vocab_size)
        if p.is_file():
            return WordPieceTokenizer(p)
    return HashTokenizer(vocab_size)


# --------------------------------------------------------------- batching


def _special_ids(tok) -> tuple[int, int, int]:
    return (
        getattr(tok, "cls_id", CLS_ID),
        getattr(tok, "sep_id", SEP_ID),
        getattr(tok, "pad_id", PAD_ID),
    )


def encode_batch(tok, texts: list[str], seq_len: int, batch: int | None = None):
    """-> (ids, mask) int32 arrays of shape (B, seq_len); B = batch or len(texts).

    Layout: [CLS] tokens... [SEP] padding...  (BERT single-segment)
    """
    cls_id, sep_id, pad_id = _special_ids(tok)
    n = len(texts)
    b = batch or n
    ids = np.full((b, seq_len), pad_id, np.int32)
    mask = np.zeros((b, seq_len), np.int32)
    for i, text in enumerate(texts):
        body = tok.tokenize_ids(text)[: seq_len - 2]
        row = [cls_id] + body + [sep_id]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask


def encode_pair_batch(tok, pairs: list[tuple[str, str]], seq_len: int, batch: int | None = None):
    """-> (ids, mask, type_ids) for cross-encoder scoring:
    [CLS] a... [SEP] b... [SEP] with type 0 / 1 segments."""
    cls_id, sep_id, pad_id = _special_ids(tok)
    n = len(pairs)
    b = batch or n
    ids = np.full((b, seq_len), pad_id, np.int32)
    mask = np.zeros((b, seq_len), np.int32)
    types = np.zeros((b, seq_len), np.int32)
    for i, (a, bb) in enumerate(pairs):
        ta = tok.tokenize_ids(a)
        tb = tok.tokenize_ids(bb)
        # budget: keep the query intact, truncate the document
        max_a = min(len(ta), (seq_len - 3) // 2 if len(tb) > (seq_len - 3) // 2 else seq_len - 3 - len(tb))
        ta = ta[:max_a]
        tb = tb[: seq_len - 3 - len(ta)]
        row = [cls_id] + ta + [sep_id] + tb + [sep_id]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
        types[i, len(ta) + 2 : len(row)] = 1
    return ids, mask, types
