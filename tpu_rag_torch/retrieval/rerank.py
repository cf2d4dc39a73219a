"""Cross-encoder reranking (port of tpu_rag/retrieval/rerank.py).

Parity with reference api/app.py:568-583: score [query, text] pairs, attach
rerank_score, sort descending, rewrite ranks.  One divergence: a failure of
the cross-encoder (a kernel that fails to launch, say) propagates, where
tpu_rag logs it and returns the hits unchanged, which its /search then
reports as `reranked: true`.  The port's /search turns the exception into
`reranked: false` plus `rerank_error` (api/routes/kb.py).

mode="ensemble" blends the retriever ordering with the cross-encoder via
per-list z-score interpolation instead of replacing it — measured better
than either alone on labeled held-out retrieval (docs/QUALITY.md: recall@10
0.664 vs 0.648 bi-encoder-only vs 0.630 CE-only).  "replace" stays the
default for reference parity.
"""

from __future__ import annotations


def _znorm(vals: list[float]) -> list[float]:
    n = len(vals)
    mu = sum(vals) / n
    var = sum((v - mu) ** 2 for v in vals) / n
    sd = max(var ** 0.5, 1e-6)
    return [(v - mu) / sd for v in vals]


def rerank_hits(cross_encoder, query: str, hits: list[dict],
                mode: str = "replace", alpha: float = 0.5) -> list[dict]:
    """mode: "replace" (reference parity: sort by CE score), "ensemble"
    (z-score blend), or "annotate" (attach rerank_score, keep the retriever
    order — the quality-gate fallback when a checkpoint's own eval manifest
    shows its ensemble LOSES to the retriever it wraps)."""
    if not hits or cross_encoder is None:
        return hits
    pairs = [(query, h.get("text", "")) for h in hits]
    scores = cross_encoder.predict(pairs).tolist()
    for h, s in zip(hits, scores):
        h["rerank_score"] = float(s)
    if mode == "annotate":
        return hits
    if mode == "ensemble" and len(hits) > 1:
        # Retriever similarity comes from two distributions: vector hits
        # carry a distance (1 - cos, ~[0, 2]) while FTS hits (id prefix
        # "db:") carry FTS5 bm25 (unbounded negative, magnitudes ~0-10).
        # Z-normalizing them together pins whichever family has the larger
        # magnitude to the top regardless of cross-encoder signal, so
        # normalize per family; a singleton family centers to 0 (pure-CE).
        base = [0.0] * len(hits)
        fam: dict[str, list[int]] = {}
        for i, h in enumerate(hits):
            kind = h.get("score_kind") or (
                "bm25" if str(h.get("id", "")).startswith("db:") else "vector")
            fam.setdefault(kind, []).append(i)
        for idxs in fam.values():
            # negate so "bigger is better" within each family (distance and
            # bm25 are both ascending-better)
            z = _znorm([-float(hits[i].get("score", 0.0)) for i in idxs])
            for i, v in zip(idxs, z):
                base[i] = v
        # alpha weights the CE against the retriever (0.5 = equal; the
        # training harness tunes it on a validation split and ships it as
        # RERANK_ENSEMBLE_ALPHA — scripts/train_reranker.py)
        a = min(max(float(alpha), 0.0), 1.0)
        blend = [(1.0 - a) * b + a * c for b, c in zip(base, _znorm(scores))]
        for h, m in zip(hits, blend):
            h["ensemble_score"] = float(m)
        hits.sort(key=lambda x: x.get("ensemble_score", 0.0), reverse=True)
    else:
        hits.sort(key=lambda x: x.get("rerank_score", 0.0), reverse=True)
    for i, h in enumerate(hits, 1):
        h["rank"] = i
    return hits
