"""Conversation + KB-items SQLite store.

Schema parity with the reference conversation database (reference
api/db.py:26-74): messages / summaries / kb_items / kb_fts (FTS5,
content-synced via triggers) / idx_messages_thread.  Differences by design:

- A class holding the path (no module-global DB_PATH import-time coupling).
- Connections are per-call (like the reference) but WAL mode is enabled so
  concurrent readers don't block the writer — the reference had unguarded
  concurrency (SURVEY.md §5 "race detection: ABSENT").
- BM25 keyword search over kb_items lives here too (reference
  api/app.py:62-83) since it's a pure-SQLite concern.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from pathlib import Path


class _PooledConn(sqlite3.Connection):
    """Thread-local pooled connection: close() is a no-op so the existing
    open/use/close call pattern keeps working while the underlying handle
    (and its PRAGMA state) is reused across calls on the same thread —
    connection setup was measurable on the /search hot path."""

    def close(self) -> None:  # reused; OS closes it at process exit
        pass


class ConversationDB:
    def __init__(self, path: str) -> None:
        self.path = path
        self._tls = threading.local()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._init_db()

    def _db(self) -> sqlite3.Connection:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30, factory=_PooledConn)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._tls.conn = conn
        elif conn.in_transaction:
            # a previous caller errored before commit; don't leak its
            # half-transaction into this call
            conn.rollback()
        return conn

    def _init_db(self) -> None:
        conn = self._db()
        try:
            conn.execute(
                """CREATE TABLE IF NOT EXISTS messages(
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                thread_id TEXT, ts INTEGER, role TEXT, content TEXT, lang TEXT)"""
            )
            conn.execute(
                """CREATE TABLE IF NOT EXISTS summaries(
                thread_id TEXT PRIMARY KEY, summary TEXT, lang TEXT, updated_ts INTEGER)"""
            )
            conn.execute(
                """CREATE TABLE IF NOT EXISTS kb_items(
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                source TEXT, ref_id TEXT, title TEXT, content TEXT, updated_ts INTEGER)"""
            )
            conn.execute(
                """CREATE VIRTUAL TABLE IF NOT EXISTS kb_fts
                USING fts5(title, content, content='kb_items', content_rowid='id')"""
            )
            conn.execute(
                """CREATE TRIGGER IF NOT EXISTS kb_ai AFTER INSERT ON kb_items BEGIN
                INSERT INTO kb_fts(rowid, title, content) VALUES (new.id, new.title, new.content);
                END;"""
            )
            conn.execute(
                """CREATE TRIGGER IF NOT EXISTS kb_ad AFTER DELETE ON kb_items BEGIN
                INSERT INTO kb_fts(kb_fts, rowid, title, content)
                VALUES('delete', old.id, old.title, old.content);
                END;"""
            )
            conn.execute(
                """CREATE TRIGGER IF NOT EXISTS kb_au AFTER UPDATE ON kb_items BEGIN
                INSERT INTO kb_fts(kb_fts, rowid, title, content)
                VALUES('delete', old.id, old.title, old.content);
                INSERT INTO kb_fts(rowid, title, content) VALUES (new.id, new.title, new.content);
                END;"""
            )
            conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_messages_thread ON messages(thread_id, id)"
            )
            # (source, ref_id) is the upsert identity: without a UNIQUE
            # constraint two concurrent upserts of the same item both passed
            # the SELECT check and inserted duplicates.  Dedupe first so the
            # index creation succeeds on databases that already raced (the
            # DELETE fires the FTS trigger, keeping kb_fts consistent).
            conn.execute(
                """DELETE FROM kb_items WHERE id NOT IN (
                SELECT MAX(id) FROM kb_items GROUP BY source, ref_id)"""
            )
            conn.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS idx_kb_src_ref "
                "ON kb_items(source, ref_id)"
            )
            conn.commit()
        finally:
            conn.close()

    # ------------------------------------------------------------ messages

    def save_message(self, thread_id: str, role: str, content: str, lang: str | None) -> None:
        conn = self._db()
        try:
            conn.execute(
                "INSERT INTO messages(thread_id,ts,role,content,lang) VALUES(?,?,?,?,?)",
                (thread_id, int(time.time()), role, content, lang or ""),
            )
            conn.commit()
        finally:
            conn.close()

    def load_recent_messages(
        self, thread_id: str, max_turns: int = 6, max_chars: int = 1200
    ) -> list[tuple[str, str]]:
        """Newest-backwards char-budgeted window, returned oldest-first
        (reference api/db.py:88-107 semantics)."""
        conn = self._db()
        try:
            cur = conn.execute(
                "SELECT role, content FROM messages WHERE thread_id=? ORDER BY id DESC LIMIT ?",
                (thread_id, max_turns * 2),
            )
            rows = cur.fetchall()
        finally:
            conn.close()
        out: list[tuple[str, str]] = []
        size = 0
        for role, content in rows:  # rows are newest first
            c = content or ""
            if size + len(c) > max_chars:
                break
            out.append((role, c))
            size += len(c)
        return out[::-1]

    def get_summary(self, thread_id: str) -> str:
        conn = self._db()
        try:
            cur = conn.execute("SELECT summary FROM summaries WHERE thread_id=?", (thread_id,))
            row = cur.fetchone()
        finally:
            conn.close()
        return row[0] if row else ""

    def set_summary(self, thread_id: str, summary: str, lang: str | None) -> None:
        conn = self._db()
        try:
            conn.execute(
                """INSERT INTO summaries(thread_id,summary,lang,updated_ts) VALUES(?,?,?,?)
                ON CONFLICT(thread_id) DO UPDATE SET
                summary=excluded.summary, lang=excluded.lang, updated_ts=excluded.updated_ts""",
                (thread_id, summary, lang or "", int(time.time())),
            )
            conn.commit()
        finally:
            conn.close()

    def list_threads(self, limit: int = 200) -> list[dict]:
        conn = self._db()
        try:
            cur = conn.execute(
                """SELECT thread_id, MAX(ts) AS last_ts, COUNT(*) AS cnt
                FROM messages GROUP BY thread_id ORDER BY last_ts DESC LIMIT ?""",
                (int(limit),),
            )
            return [
                {"thread_id": tid, "last_ts": ts, "count": cnt}
                for (tid, ts, cnt) in cur.fetchall()
            ]
        finally:
            conn.close()

    def thread_messages(self, thread_id: str, limit: int = 500) -> list[dict]:
        conn = self._db()
        try:
            cur = conn.execute(
                "SELECT ts, role, content, lang FROM messages WHERE thread_id=? ORDER BY id ASC LIMIT ?",
                (thread_id, int(limit)),
            )
            return [
                {"ts": ts, "role": role, "content": content, "lang": lang}
                for (ts, role, content, lang) in cur.fetchall()
            ]
        finally:
            conn.close()

    # ------------------------------------------------------------ kb items

    def upsert_kb_item(self, source: str, ref_id: str, title: str, content: str) -> None:
        conn = self._db()
        try:
            # atomic upsert (UNIQUE(source, ref_id)): the old SELECT-then-
            # INSERT let two concurrent upserts both insert.  DO UPDATE
            # preserves the rowid, so the FTS UPDATE trigger keeps kb_fts
            # aligned exactly like the old in-place UPDATE did.
            conn.execute(
                "INSERT INTO kb_items(source, ref_id, title, content, updated_ts) "
                "VALUES(?,?,?,?,?) ON CONFLICT(source, ref_id) DO UPDATE SET "
                "title=excluded.title, content=excluded.content, "
                "updated_ts=excluded.updated_ts",
                (source, ref_id, title, content, int(time.time())),
            )
            conn.commit()
        finally:
            conn.close()

    def search_kb_fts(self, query: str, limit: int = 5) -> list[dict]:
        """BM25(k1=1.2, b=0.75) keyword hits over kb_items; hit shape matches
        the reference (reference api/app.py:62-83): id "db:{source}:{ref_id}",
        score ascending (FTS5 bm25: more negative = better)."""
        conn = self._db()
        try:
            cur = conn.execute(
                "SELECT i.id, i.source, i.ref_id, i.title, i.content, i.updated_ts, "
                "bm25(kb_fts, 1.2, 0.75) as score "
                "FROM kb_fts JOIN kb_items i ON i.id = kb_fts.rowid "
                "WHERE kb_fts MATCH ? ORDER BY score LIMIT ?",
                (query, limit),
            )
            rows = cur.fetchall()
        finally:
            conn.close()
        hits = []
        for hid, src, rid, title, content, uts, score in rows:
            hits.append({
                "rank": 0,
                "id": f"db:{src}:{rid or hid}",
                "score": float(score) if score is not None else 0.0,
                "updated_ts": int(uts or 0),
                "metadata": {"source": src, "ref_id": rid, "title": title,
                             "updated_ts": int(uts or 0)},
                "text": content or "",
                "title": title or "",
            })
        return hits
