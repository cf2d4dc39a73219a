"""Hybrid retrieval helpers: hit shaping, meta filtering, recency, highlight.

Behavior parity with the reference (hit dict shapes, defaults, edge cases):
- vector hits: {rank, id, score=distance, metadata, text}
  (reference api/app.py:539-566; k clamped 1..20)
- meta filter heuristics (reference api/app.py:126-148)
- recency mixing (reference api/app.py:317-363) — the reference defines it
  but never wires it into search; here it is exposed and wired behind the
  `recency` search flag (default off to preserve ranking parity).
- highlight (reference api/app.py:525-536)
"""

from __future__ import annotations

import re
import time
from typing import Any

META_TITLE_KEYWORDS = ("curator", "schema", "prompt手冊", "prompt 指南", "系統說明", "資料庫說明")


def clamp_k(k, cap: int = 20) -> int:
    """The reference's k clamp: default 5, bounded to 1..20
    (reference api/app.py:546).  Single source of truth for every
    retrieval path (two-step, batched, fused).

    `cap` stays 20 for request-supplied k (parity); the RERANK_CANDIDATES
    extension raises it so reranking can look deeper than the response k
    (recall@k after rerank is ceilinged by retrieval recall@cap)."""
    return max(1, min(int(5 if k is None else k), max(int(cap), 1)))


def result_hits(res, qi: int = 0) -> list[dict]:
    """Shape one query's SearchResult row like the reference's _query_chroma
    hits (score = distance, rank from 1)."""
    hits = []
    for i in range(len(res.ids[qi])):
        hits.append({
            "rank": i + 1,
            "id": res.ids[qi][i],
            "score": float(res.distances[qi][i]),
            "metadata": res.metadatas[qi][i],
            "text": res.documents[qi][i],
        })
    return hits


def vector_hits(index, query_vec, k: int, namespace: str | None,
                canonicality: str | None, cap: int = 20) -> list[dict]:
    """Search the vector index and shape hits like the reference's
    _query_chroma (score = distance, rank from 1)."""
    k = clamp_k(k, cap)
    res = index.search(query_vec, k, namespace=namespace or None,
                       canonicality=canonicality or None)
    return result_hits(res, 0)


def vector_hits_batch(index, query_vecs, k: int, namespace: str | None,
                      canonicality: str | None, cap: int = 20) -> list[list[dict]]:
    """Batched variant of vector_hits: one index.search call for all queries."""
    k = clamp_k(k, cap)
    res = index.search(query_vecs, k, namespace=namespace or None,
                       canonicality=canonicality or None)
    return [result_hits(res, qi) for qi in range(len(res.ids))]


def is_meta_hit(h: dict, meta_tags: tuple[str, ...]) -> bool:
    m = h.get("metadata") or {}
    t = (m.get("type") or m.get("category") or "").strip().lower()
    ns = (m.get("namespace") or "").strip().lower()
    canon = (m.get("canonicality") or "").strip().lower()
    title = (m.get("title") or "").strip().lower()
    if canon == "meta" or ns == "meta":
        return True
    if t in meta_tags:
        return True
    if any(k in title for k in META_TITLE_KEYWORDS):
        return True
    return False


def filter_meta_hits(hits: list[dict], enabled: bool, meta_tags: tuple[str, ...]) -> list[dict]:
    if not enabled:
        return hits
    try:
        return [h for h in hits if not is_meta_hit(h, meta_tags)]
    except Exception:
        return hits


# ------------------------------------------------------------------ recency


def hit_updated_ts(h: dict) -> int:
    m = h.get("metadata") or {}
    ts = h.get("updated_ts") or m.get("updated_ts")
    try:
        return int(ts)
    except (TypeError, ValueError):
        return 0


def base_similarity(h: dict) -> float:
    """rerank score when present, else 1/(1+distance)
    (reference api/app.py:327-337).  FTS hits carry NEGATIVE bm25 scores
    (score_kind="bm25") — 1/(1+d) would invert their ranking and divide by
    zero at -1.0, so they use -bm25 (higher = better; min-max normalization
    in mix_with_recency puts both families on [0, 1])."""
    if "rerank_score" in h:
        try:
            return float(h["rerank_score"])
        except (TypeError, ValueError):
            return 0.0
    d = h.get("score")
    try:
        if d is None:
            return 0.0
        if h.get("score_kind") == "bm25":
            return -float(d)
        return 1.0 / (1.0 + max(0.0, float(d)))
    except (TypeError, ValueError):
        return 0.0


def mix_with_recency(hits: list[dict], alpha: float = 0.7,
                     half_life_days: float = 45.0) -> list[dict]:
    """Blend min-max-normalized similarity with exponential time decay and
    re-rank (reference api/app.py:339-363)."""
    if not hits:
        return hits
    sims = [base_similarity(h) for h in hits]
    lo, hi = min(sims), max(sims)
    if hi > lo:
        sims = [(s - lo) / (hi - lo) for s in sims]
    now = time.time()
    mixed = []
    for h, s in zip(hits, sims):
        ts = hit_updated_ts(h)
        days = max(0.0, (now - (ts or 0)) / 86400.0)
        recency = 0.5 ** (days / half_life_days) if ts else 0.0
        h = dict(h)
        h["recency_score"] = recency
        h["mixed_score"] = alpha * s + (1 - alpha) * recency
        mixed.append(h)
    mixed.sort(key=lambda x: x.get("mixed_score", 0.0), reverse=True)
    for i, h in enumerate(mixed, 1):
        h["rank"] = i
    return mixed


# ---------------------------------------------------------------- highlight

_SENT_SPLIT = re.compile(r"[。！？!?；;\n]")
_KW_SPLIT = re.compile(r"[\s,，。.\-_/|]+")


def highlight(query: str, text: str, max_spans: int = 3) -> list[str]:
    kws = [w.strip() for w in _KW_SPLIT.split(query) if w.strip()]
    if not kws:
        return []
    spans: list[str] = []
    for sent in _SENT_SPLIT.split(text or ""):
        s = sent.strip()
        if not s:
            continue
        if any(k in s for k in kws):
            spans.append(s)
            if len(spans) >= max_spans:
                break
    return spans


def hits_signature(hits: list[dict]) -> str:
    """Stable digest of the top hits (reference api/app.py:600-602)."""
    import hashlib
    import json

    basis = [{"id": h.get("id"), "score": round(float(h.get("score", 0.0)), 6)}
             for h in hits[:6]]
    return hashlib.md5(json.dumps(basis, sort_keys=True).encode()).hexdigest()
