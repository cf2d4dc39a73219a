"""Plain WordPiece (BERT's greedy longest match first) over a vocab.txt.

Lower-cases, NFKC-normalises, makes each CJK ideograph a word of its own
(BERT's basic tokenizer) and splits on every character that is not a
letter, a digit or `_`; a word is cut into the longest vocabulary entries
from its start, later pieces with a `##` prefix, and a word that cannot be
cut, or is over 100 characters, becomes [UNK].  The reference tokenises
every text it is handed with this, apart from the program.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path


# CJK Unified Ideographs and their extensions and compatibility blocks
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


class WordPiece:
    def __init__(self, vocab_path: str | Path) -> None:
        lines = Path(vocab_path).read_text(encoding="utf-8").splitlines()
        self.vocab = {tok: i for i, tok in enumerate(lines)}
        self.unk = self.vocab["[UNK]"]
        self.special = (self.vocab["[CLS]"], self.vocab["[SEP]"], self.vocab["[PAD]"])

    @staticmethod
    def words(text: str) -> list[str]:
        out, cur = [], []
        for ch in unicodedata.normalize("NFKC", text).lower():
            if any(lo <= ord(ch) <= hi for lo, hi in _CJK):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            elif ch.isalnum() or ch == "_":
                cur.append(ch)
            elif cur:
                out.append("".join(cur))
                cur = []
        if cur:
            out.append("".join(cur))
        return out

    def ids(self, text: str) -> list[int]:
        out: list[int] = []
        for word in self.words(text):
            if len(word) > 100:
                out.append(self.unk)
                continue
            pieces, start = [], 0
            while start < len(word):
                for end in range(len(word), start, -1):
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        pieces.append(self.vocab[piece])
                        start = end
                        break
                else:
                    pieces = [self.unk]
                    break
            out.extend(pieces)
        return out
