"""Online (write-path) document indexer with dedup + versioning.

Behavior parity with the reference's background indexer (reference
api/app.py:227-315):

- content-hash dedup: identical (whitespace-normalized) content is never
  re-embedded; the ingest_registry timestamp is refreshed and indexing skips.
- source-key versioning: a new doc with the same source_key (title slug)
  replaces the previous doc's FTS rows and vectors.
- stores: `docs` FTS5 table (id, title, text, metadata) in KB_DB_PATH +
  the vector index; registries ingest_registry(content_hash -> last_doc_id)
  and docs_registry(source_key -> doc_id).

The vector side is dependency-injected (embed_fn + index + persist_fn) so it
works with any tpu_rag index and is trivially fakeable in tests — the
reference needed monkeypatching of module globals instead
(reference tests/test_kb_crud.py:58-88).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Callable

from tpu_rag_torch.ingest.schema import content_hash, slug
from tpu_rag_torch.memory.db import _PooledConn


class DocIndexer:
    def __init__(
        self,
        kb_db_path: str,
        *,
        embed_fn: Callable[[list[str]], "object"] | None = None,
        index=None,
        persist_fn: Callable[[], None] | None = None,
    ) -> None:
        self.kb_db_path = kb_db_path
        self.embed_fn = embed_fn
        self.index = index
        self.persist_fn = persist_fn
        self._tls = threading.local()
        Path(kb_db_path).parent.mkdir(parents=True, exist_ok=True)

    def _db(self) -> sqlite3.Connection:
        # thread-local pooled handle (see memory/db.py _PooledConn): the
        # schema DDL and PRAGMAs run once per thread, not once per call
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            if conn.in_transaction:
                conn.rollback()
            return conn
        conn = sqlite3.connect(self.kb_db_path, timeout=30, factory=_PooledConn)
        conn.execute("PRAGMA busy_timeout=30000")
        conn.execute(
            "CREATE VIRTUAL TABLE IF NOT EXISTS docs USING fts5(id, title, text, metadata)"
        )
        conn.execute(
            "CREATE TABLE IF NOT EXISTS ingest_registry("
            "content_hash TEXT PRIMARY KEY, last_doc_id TEXT, updated_ts INTEGER)"
        )
        conn.execute(
            "CREATE TABLE IF NOT EXISTS docs_registry("
            "source_key TEXT PRIMARY KEY, doc_id TEXT, updated_ts INTEGER)"
        )
        self._tls.conn = conn
        return conn

    # ------------------------------------------------------------- FTS

    def fts_upsert(self, doc_id: str, title: str, text: str, meta: dict) -> None:
        conn = self._db()
        try:
            conn.execute("DELETE FROM docs WHERE id = ?", (doc_id,))
            conn.execute(
                "INSERT INTO docs (id, title, text, metadata) VALUES (?, ?, ?, ?)",
                (doc_id, title, text, json.dumps(meta, ensure_ascii=False)),
            )
            conn.commit()
        finally:
            conn.close()

    def fts_search(self, query: str, limit: int = 10) -> list[dict]:
        conn = self._db()
        try:
            cur = conn.execute(
                "SELECT id, title, text, metadata, bm25(docs) AS score FROM docs "
                "WHERE docs MATCH ? ORDER BY score LIMIT ?",
                (query, limit),
            )
            rows = cur.fetchall()
        finally:
            conn.close()
        out = []
        for doc_id, title, text, meta_json, score in rows:
            try:
                meta = json.loads(meta_json) if meta_json else {}
            except ValueError:
                meta = {}
            out.append({"id": doc_id, "title": title, "text": text,
                        "metadata": meta, "score": float(score or 0.0)})
        return out

    # ------------------------------------------------------------- vectors

    def _vector_add(self, doc_id: str, text: str, meta: dict) -> None:
        if self.index is None or self.embed_fn is None:
            return
        vec = self.embed_fn([text])
        self.index.add([doc_id], vec, [text], [meta])
        if self.persist_fn:
            self.persist_fn()

    def _vector_delete(self, ids: list[str] | None = None, where: dict | None = None) -> None:
        if self.index is None:
            return
        self.index.delete(ids=ids, where=where)
        if self.persist_fn:
            self.persist_fn()

    # ------------------------------------------------------------- main paths

    def index_doc(self, payload: dict) -> bool:
        """Index one doc payload {id, title, content, metadata}. Returns False
        when skipped by hash dedup (reference api/app.py:244-251)."""
        doc_id = payload.get("id")
        title = payload.get("title") or "untitled"
        text = payload.get("content") or ""
        meta = dict(payload.get("metadata") or {})
        src_key = meta.get("source_key") or slug(title)
        upd_ts = int(meta.get("updated_ts") or time.time())
        c_hash = meta.get("content_hash") or content_hash(text)

        conn = self._db()
        try:
            row = conn.execute(
                "SELECT last_doc_id FROM ingest_registry WHERE content_hash=?", (c_hash,)
            ).fetchone()
            if row:
                conn.execute(
                    "UPDATE ingest_registry SET last_doc_id=?, updated_ts=? WHERE content_hash=?",
                    (row[0], upd_ts, c_hash),
                )
                conn.commit()
                return False  # identical content already indexed

            prev = conn.execute(
                "SELECT doc_id FROM docs_registry WHERE source_key=?", (src_key,)
            ).fetchone()
            if prev and prev[0] and prev[0] != doc_id:
                conn.execute("DELETE FROM docs WHERE id=?", (prev[0],))
                self._vector_delete(where={"source_key": src_key})

            conn.commit()
        finally:
            conn.close()

        self.fts_upsert(doc_id, title, text, {**meta, "title": title})
        self._vector_add(doc_id, text, {**meta, "title": title})

        conn = self._db()
        try:
            conn.execute(
                "INSERT OR REPLACE INTO ingest_registry(content_hash, last_doc_id, updated_ts) VALUES (?,?,?)",
                (c_hash, doc_id, upd_ts),
            )
            conn.execute(
                "INSERT OR REPLACE INTO docs_registry(source_key, doc_id, updated_ts) VALUES (?,?,?)",
                (src_key, doc_id, upd_ts),
            )
            conn.commit()
        finally:
            conn.close()
        return True

    def delete_doc(self, doc_id: str, source_key: str | None = None) -> None:
        """Remove a doc from FTS, registries and the vector index
        (reference api/app.py:284-315)."""
        conn = self._db()
        try:
            conn.execute("DELETE FROM docs WHERE id=?", (doc_id,))
            conn.execute("DELETE FROM docs_registry WHERE doc_id=?", (doc_id,))
            if source_key:
                conn.execute("DELETE FROM docs_registry WHERE source_key=?", (source_key,))
            conn.execute("DELETE FROM ingest_registry WHERE last_doc_id=?", (doc_id,))
            conn.commit()
        finally:
            conn.close()
        self._vector_delete(ids=[doc_id])
        if source_key:
            self._vector_delete(where={"source_key": source_key})
