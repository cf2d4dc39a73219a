"""Metadata tag vocabulary: string tags <-> int32 ids for in-kernel filtering.

The reference filters retrieval with Chroma `where={namespace, canonicality}`
dicts (reference api/app.py:556-559).  On TPU the filter must not break the
dense matmul, so string tag values are interned to int32 ids; the kernel masks
scores where the row's tag id mismatches (tpu_rag/ops/topk.py).
"""

from __future__ import annotations


class TagVocab:
    """Bidirectional string<->int32 tag interning. id 0 is reserved for ''."""

    def __init__(self, items: list[str] | None = None) -> None:
        self._to_id: dict[str, int] = {"": 0}
        self._to_str: list[str] = [""]
        for s in items or []:
            self.intern(s)

    def intern(self, tag: str | None) -> int:
        tag = tag or ""
        got = self._to_id.get(tag)
        if got is None:
            got = len(self._to_str)
            self._to_id[tag] = got
            self._to_str.append(tag)
        return got

    def lookup(self, tag: str | None) -> int:
        """Return the tag id; -1 = no-filter sentinel (tag is None);
        -2 = tag never interned (callers should return zero hits —
        see FlatIndex.search)."""
        if tag is None:
            return -1
        return self._to_id.get(tag, -2)

    def to_str(self, tag_id: int) -> str:
        if 0 <= tag_id < len(self._to_str):
            return self._to_str[tag_id]
        return ""

    def as_list(self) -> list[str]:
        return list(self._to_str)

    def __len__(self) -> int:
        return len(self._to_str)
