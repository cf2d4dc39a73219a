"""Document schema helpers: normalization, hashing, slugs.

Behavior parity with the reference's helpers (reference api/app.py:150-193,
scripts/build_index.py:19-27): the doc JSON schema is
{id, namespace, canonicality, title, summary, body} where body may be a
string, list, or nested dict of sections.
"""

from __future__ import annotations

import hashlib
import re


def normalize_text(t: str) -> str:
    """Collapse whitespace (used for content hashing — reference api/app.py:150)."""
    return re.sub(r"\s+", " ", t or "").strip()


def content_hash(t: str) -> str:
    """sha256 of whitespace-normalized text (reference api/app.py:153)."""
    return hashlib.sha256(normalize_text(t).encode("utf-8")).hexdigest()


def slug(s: str) -> str:
    """Lowercase slug keeping CJK chars; max 80 chars (reference api/app.py:189-193)."""
    s = (s or "untitled").lower()
    s = re.sub(r"[^a-z0-9一-龥]+", "-", s).strip("-")
    return s[:80] or "untitled"


def normalize_value(x) -> str:
    """Flatten nested dict/list body values into text with SECTION markers
    (reference scripts/build_index.py:19-27)."""
    if isinstance(x, list):
        return "\n".join(str(i) for i in x)
    if isinstance(x, dict):
        parts = []
        for k, v in x.items():
            parts.append(f"SECTION: {k}\n{normalize_value(v)}")
        return "\n\n".join(parts)
    return str(x)
