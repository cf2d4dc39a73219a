"""KB / docs routes: docs CRUD with background indexing, kb upsert/search,
hybrid /search.

Endpoint/response parity with reference api/routes/kb.py:27-206, including:
- docs stored as JSON files under DOCS_DIR (source of truth; index is
  derived), doc ids "doc-{ts}-{uuid8}", filenames "{ts}_{slug}.json"
- PUT schedules delete-old + reindex as background tasks
- /search merges vector + FTS hits, optional rerank/highlight, partial
  failures annotated as db_error / rerank_error
Extensions: READONLY_MODE actually enforced (dead flag in the reference,
api/config.py:17), per-stage timings in /search, optional recency mix.
"""

from __future__ import annotations

import json
import time
import uuid
from datetime import datetime, timezone
from pathlib import Path

from tpu_rag_torch.api.asgi import App, HTTPException, Request
from tpu_rag_torch.api.models import KbUpsertItem, SaveDocItem, SearchRequest
from tpu_rag_torch.engine import RagEngine
from tpu_rag_torch.ingest.schema import content_hash, slug
from tpu_rag_torch.retrieval.hybrid import filter_meta_hits, highlight
from tpu_rag_torch.utils.timing import StageTimings


def register(app: App, engine: RagEngine) -> None:
    cfg = engine.config

    def docs_dir() -> Path:
        return Path(cfg.docs_dir)

    def guard_writes() -> None:
        if cfg.readonly_mode:
            raise HTTPException(403, "readonly mode: write operations are disabled")

    def find_doc(doc_id: str):
        base = docs_dir()
        if not base.exists():
            return None, None
        for fp in base.rglob("*.json"):
            try:
                data = json.loads(fp.read_text(encoding="utf-8"))
            except Exception:
                continue
            if data.get("id") == doc_id:
                return fp, data
        return None, None

    def build_payload(doc_id: str, item: SaveDocItem) -> dict:
        now_ts = int(time.time())
        src_key = item.metadata.get("source_key") if isinstance(item.metadata, dict) else None
        if not src_key:
            src_key = slug(item.title)
        metadata = dict(item.metadata or {})
        metadata.update({
            "updated_ts": now_ts,
            "source_key": src_key,
            "content_hash": content_hash(item.content),
        })
        return {"id": doc_id, "title": item.title, "content": item.content,
                "metadata": metadata}

    # ------------------------------------------------------------- docs CRUD

    @app.get("/docs/list")
    def docs_list():
        docs = []
        base = docs_dir()
        if not base.exists():
            return {"docs": docs}
        for fp in base.rglob("*.json"):
            try:
                data = json.loads(fp.read_text(encoding="utf-8"))
                rel = fp.relative_to(base)
                docs.append({
                    "id": data.get("id"),
                    "title": data.get("title"),
                    "metadata": data.get("metadata") or {},
                    "path": str(rel),
                    "folder": str(rel.parent),
                    "file": rel.name,
                })
            except Exception:
                continue
        docs.sort(key=lambda x: x.get("metadata", {}).get("updated_ts", 0), reverse=True)
        return {"docs": docs}

    @app.get("/docs/{doc_id}")
    def docs_get(doc_id: str):
        _, data = find_doc(doc_id)
        if not data:
            raise HTTPException(404, "doc not found")
        return data

    @app.put("/docs/{doc_id}")
    def docs_put(doc_id: str, body: SaveDocItem, request: Request):
        guard_writes()
        path, old = find_doc(doc_id)
        if not old:
            raise HTTPException(404, "doc not found")
        payload = build_payload(doc_id, body)
        path.write_text(json.dumps(payload, ensure_ascii=False, indent=2), encoding="utf-8")
        old_src = (old.get("metadata") or {}).get("source_key")
        request.add_background(engine.indexer.delete_doc, doc_id, old_src)
        request.add_background(engine.indexer.index_doc, payload)
        return {"ok": True, "id": doc_id, "file": path.name, "path": str(path)}

    @app.delete("/docs/{doc_id}")
    def docs_delete(doc_id: str, request: Request):
        guard_writes()
        path, data = find_doc(doc_id)
        if not data:
            raise HTTPException(404, "doc not found")
        path.unlink()
        src_key = (data.get("metadata") or {}).get("source_key")
        request.add_background(engine.indexer.delete_doc, doc_id, src_key)
        return {"ok": True}

    @app.post("/docs/save")
    def docs_save(body: SaveDocItem, request: Request):
        guard_writes()
        base = docs_dir()
        base.mkdir(parents=True, exist_ok=True)
        ts = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
        uid = uuid.uuid4().hex[:8]
        doc_id = f"doc-{ts}-{uid}"
        # the uid keeps two same-second saves of the same title from
        # clobbering each other's file (the first doc would stay indexed but
        # 404 on fetch)
        fname = f"{ts}_{slug(body.title)}_{uid}.json"
        payload = build_payload(doc_id, body)
        (base / fname).write_text(json.dumps(payload, ensure_ascii=False, indent=2),
                                  encoding="utf-8")
        request.add_background(engine.indexer.index_doc, payload)
        return {"ok": True, "id": doc_id, "file": fname, "path": str(base / fname)}

    # ------------------------------------------------------------- kb items

    @app.post("/kb/upsert")
    def kb_upsert(body: dict):
        guard_writes()
        body = body or {}
        # KbUpsertItem is the schema of record; keep the reference's 400 +
        # "missing field: X" contract (the default body binding would 422)
        for f in KbUpsertItem.model_fields:
            if f not in body:
                raise HTTPException(400, f"missing field: {f}")
        try:
            item = KbUpsertItem.model_validate(
                {f: body[f] for f in KbUpsertItem.model_fields})
        except Exception as e:
            raise HTTPException(400, f"invalid kb item: {e}")
        engine.db.upsert_kb_item(item.source, item.ref_id, item.title, item.content)
        return {"ok": True}

    @app.post("/kb/search")
    def kb_search(body: dict):
        q = ((body or {}).get("query") or "").strip()
        if not q:
            raise HTTPException(400, "query required")
        try:
            k = int((body or {}).get("k") or 5)
        except (TypeError, ValueError):
            raise HTTPException(400, f"invalid k: {(body or {}).get('k')!r}")
        try:
            return {"hits": engine.db.search_kb_fts(q, limit=k)}
        except Exception as e:
            # FTS5 MATCH syntax errors (quotes, unbalanced parens) are caller
            # errors, not server faults (the reference 500s here)
            raise HTTPException(400, f"invalid FTS query: {e}")

    # ------------------------------------------------------------- hybrid search

    def assemble(query: str, hits: list[dict], body: SearchRequest,
                 timings: StageTimings) -> dict:
        """FTS merge + meta filter + rerank + recency + highlight + truncate
        for one query (the reference's /search post-processing,
        api/routes/kb.py:173-206)."""
        out: dict = {"hits": hits}
        try:
            with timings.stage("fts"):
                db_hits = engine.db.search_kb_fts(query, limit=max(1, (body.k or 6) // 2))
            for h in db_hits:
                h["metadata"] = {**h.get("metadata", {}), "title": h.get("title", ""),
                                 "source": "db"}
                h["score_kind"] = "bm25"
            if cfg.fts_docs:
                # extension (FTS_DOCS=1): also search the docs FTS table the
                # indexer populates — the reference writes it
                # (DocIndexer.fts_upsert) but never reads it, which looks
                # unintended; off by default for ranking parity
                with timings.stage("fts"):
                    doc_fts = engine.indexer.fts_search(
                        query, limit=max(1, (body.k or 6) // 2))
                seen = {h.get("id") for h in hits}
                for h in doc_fts:
                    if h.get("id") in seen:
                        continue  # vector retrieval already surfaced it
                    h["score_kind"] = "bm25"
                    h["metadata"] = {**h.get("metadata", {}), "source": "docs_fts"}
                    db_hits.append(h)
            do_filter = cfg.filter_meta_default and not (
                (body.canonicality or "").strip().lower() == "meta")
            hits = (filter_meta_hits(hits, do_filter, cfg.meta_tags)
                    + filter_meta_hits(db_hits, do_filter, cfg.meta_tags))
        except Exception as e:
            out["db_error"] = str(e)

        if body.rerank:
            try:
                with timings.stage("rerank"):
                    hits = engine.rerank(query, hits)
                out["reranked"] = True
            except Exception as e:
                out["reranked"] = False
                out["rerank_error"] = str(e)

        if body.recency:
            hits = engine.recency_mix(hits)
            out["recency_mixed"] = True

        if body.highlight:
            for h in hits:
                try:
                    h["highlights"] = highlight(query, h.get("text", ""))
                except Exception:
                    h["highlights"] = []

        out["hits"] = hits[: max(1, body.k or 5)]
        out["source"] = "chroma+db"
        return out

    @app.post("/search")
    def search(body: SearchRequest):
        timings = StageTimings()
        # RERANK_CANDIDATES extension: retrieve deeper for the cross-encoder
        # (assemble() truncates back to body.k after reranking)
        k_ret, k_cap = body.k, 20
        if body.rerank and cfg.rerank_candidates:
            from tpu_rag_torch.retrieval.hybrid import clamp_k

            k_ret = max(clamp_k(body.k), cfg.rerank_candidates)
            k_cap = k_ret
        if body.queries:
            # batched extension: one encoder/kernel pass for all queries
            with timings.stage("embed+vector_search"):
                batch_hits = engine.query_vector_batch(
                    body.queries, k_ret, body.namespace, body.canonicality,
                    k_cap=k_cap)
            results = [assemble(q, hits, body, timings)
                       for q, hits in zip(body.queries, batch_hits)]
            return {"results": results, "source": "chroma+db",
                    "timings_ms": timings.as_dict()}

        hits = engine.query_vector(body.query, k_ret, body.namespace,
                                   body.canonicality, timings, k_cap=k_cap)
        out = assemble(body.query, hits, body, timings)
        out["timings_ms"] = timings.as_dict()
        return out
