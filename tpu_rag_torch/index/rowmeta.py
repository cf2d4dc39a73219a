"""Row id/document/metadata storage for the host side of an index.

Completes the beyond-host-RAM story the vector arena (tpu_rag/index/arena.py)
started: vectors can spill to a memmap, but `FlatIndex` also keeps three
python lists (id, document, metadata per row) and an id->row dict — at 100M
rows those cost tens of GB of interpreter objects.  This module provides
list- and dict-shaped stores with two backings:

  - "ram": plain list / dict (the default — zero overhead vs before)
  - "disk": one shared SQLite file holding  rows(row, id, doc, meta)  and
    id_map(id -> row); the python objects for a row exist only while
    someone is looking at them

The disk tables deliberately mirror how the reference keeps its durable doc
registry in SQLite next to Chroma's vector segments (reference
api/app.py:195-315 `_sqlite_upsert` + registries): SQLite is the boring,
correct place for row metadata; the TPU holds only the dense scan arrays.

The stores expose just the operations FlatIndex uses (append/extend,
integer __getitem__, __len__, iteration; dict get/set/pop) so the index
code is backing-agnostic.  All disk ops serialize on an internal lock; the
connection is shared across threads (check_same_thread=False).
"""

from __future__ import annotations

import json
import os
import sqlite3
import tempfile
import threading
import uuid
import weakref
from pathlib import Path


class _DiskRows:
    """Shared SQLite backing for one index's row store + id map."""

    def __init__(self, dir: str | os.PathLike | None = None) -> None:
        if dir is None:  # same default dir as the vector arena
            dir = os.environ.get("TPU_RAG_MASTER_DIR") or tempfile.gettempdir()
        base = Path(dir)
        base.mkdir(parents=True, exist_ok=True)
        self.path = base / f"rowmeta-{uuid.uuid4().hex}.sqlite3"
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE rows (row INTEGER PRIMARY KEY, id TEXT, doc TEXT, meta TEXT)")
        self._conn.execute(
            "CREATE TABLE id_map (id TEXT PRIMARY KEY, row INTEGER)")
        self._conn.commit()
        self.lock = threading.RLock()
        self._finalizer = weakref.finalize(
            self, _cleanup_sqlite, str(self.path))

    def close(self) -> None:
        with self.lock:
            try:
                self._conn.close()
            finally:
                self._finalizer()


def _cleanup_sqlite(path: str) -> None:
    for suffix in ("", "-wal", "-shm"):
        try:
            os.unlink(path + suffix)
        except OSError:
            pass


class RowSeq:
    """Append-only sequence of (id, doc, meta) rows, RAM- or disk-backed.

    One RowSeq instance serves all three of FlatIndex's per-row fields
    through thin column views (see `.ids` / `.docs` / `.metas`), so a disk
    row is fetched once per access, not three times."""

    def __init__(self, *, backing: str = "ram",
                 dir: str | os.PathLike | None = None,
                 disk: _DiskRows | None = None) -> None:
        if backing not in ("ram", "disk"):
            raise ValueError(f"unknown rowmeta backing: {backing}")
        self.backing = backing
        self._n = 0
        if backing == "ram":
            self._ids: list[str] = []
            self._docs: list[str] = []
            self._metas: list[dict] = []
            self.disk = None
        else:
            self.disk = disk or _DiskRows(dir)

    def __len__(self) -> int:
        return self._n

    def append_row(self, id_: str, doc: str, meta: dict) -> int:
        return self.extend_rows([id_], [doc], [meta])

    def extend_rows(self, ids, docs, metas) -> int:
        """Append rows; returns the first new row number.

        RAM stores the provided objects as-is (FlatIndex copies metas at the
        call site); disk JSON-serializes metas BEFORE touching the store, so
        a non-serializable value raises with nothing inserted.  NOTE the ram
        backing keeps metas un-normalized while disk JSON-roundtrips them
        (tuples become lists, non-string keys become strings) — metadata that
        arrived through the HTTP API is already plain JSON, so the two only
        diverge for exotic programmatic metas."""
        ids, docs, metas = list(ids), list(docs), list(metas)
        if not (len(ids) == len(docs) == len(metas)):
            raise ValueError(f"length mismatch: {len(ids)} ids / "
                             f"{len(docs)} docs / {len(metas)} metas")
        if self.backing == "ram":
            start = self._n
            self._ids.extend(ids)
            self._docs.extend(docs)
            self._metas.extend(metas)
            self._n = len(self._ids)
            return start
        # serialize up front: an error here leaves the store untouched
        meta_json = [json.dumps(m or {}, ensure_ascii=False) for m in metas]
        with self.disk.lock:
            start = self._n
            try:
                self.disk._conn.executemany(
                    "INSERT INTO rows (row, id, doc, meta) VALUES (?,?,?,?)",
                    ((start + i, i_, d or "", s)
                     for i, (i_, d, s) in enumerate(zip(ids, docs, meta_json))))
                self.disk._conn.commit()
            except BaseException:
                # roll back the open implicit transaction: without this the
                # partial inserts linger on the SHARED connection and the
                # next unrelated commit() persists them, permanently
                # colliding every later extend with the stale row numbers
                self.disk._conn.rollback()
                raise
            self._n = start + len(ids)
        return start

    def row(self, row: int) -> tuple[str, str, dict]:
        if row < 0 or row >= self._n:
            raise IndexError(row)
        if self.backing == "ram":
            return self._ids[row], self._docs[row], self._metas[row]
        with self.disk.lock:
            cur = self.disk._conn.execute(
                "SELECT id, doc, meta FROM rows WHERE row = ?", (row,))
            got = cur.fetchone()
        if got is None:
            raise IndexError(row)
        return got[0], got[1], json.loads(got[2])

    def rows(self, row_list) -> list[tuple[str, str, dict]]:
        """Batch fetch (one query on disk) preserving order."""
        if self.backing == "ram":
            # negative rows would silently wrap to the wrong row via python
            # list indexing (flat.py uses -1 as its invalid-row sentinel);
            # fail loudly like the disk path does
            out = []
            for r in row_list:
                if r < 0 or r >= self._n:
                    raise IndexError(r)
                out.append((self._ids[r], self._docs[r], self._metas[r]))
            return out
        row_list = list(row_list)
        out: dict[int, tuple] = {}
        CH = 512  # SQLite parameter limit headroom
        with self.disk.lock:
            for i in range(0, len(row_list), CH):
                part = row_list[i:i + CH]
                q = ",".join("?" * len(part))
                for r, i_, d, m in self.disk._conn.execute(
                        f"SELECT row, id, doc, meta FROM rows WHERE row IN ({q})",
                        part):
                    out[r] = (i_, d, json.loads(m))
        return [out[r] for r in row_list]

    def iter_rows(self, batch: int = 4096):
        """Yield (row, id, doc, meta) in row order, RAM bounded by `batch`."""
        if self.backing == "ram":
            for r in range(self._n):
                yield r, self._ids[r], self._docs[r], self._metas[r]
            return
        lo = 0
        while lo < self._n:
            with self.disk.lock:
                part = self.disk._conn.execute(
                    "SELECT row, id, doc, meta FROM rows WHERE row >= ? "
                    "ORDER BY row LIMIT ?", (lo, batch)).fetchall()
            if not part:
                return
            for r, i_, d, m in part:
                yield r, i_, d, json.loads(m)
            lo = part[-1][0] + 1

    # -- thin column views so FlatIndex code reads naturally ---------------

    @property
    def ids(self) -> "_Col":
        return _Col(self, 0)

    @property
    def docs(self) -> "_Col":
        return _Col(self, 1)

    @property
    def metas(self) -> "_Col":
        return _Col(self, 2)


class _Col:
    """List-like read view of one RowSeq column."""

    __slots__ = ("_seq", "_i")

    def __init__(self, seq: RowSeq, i: int) -> None:
        self._seq = seq
        self._i = i

    def __len__(self) -> int:
        return len(self._seq)

    def __getitem__(self, row):
        if isinstance(row, (list, tuple)) or hasattr(row, "__len__"):
            return [t[self._i] for t in self._seq.rows(row)]
        return self._seq.row(int(row))[self._i]

    def __iter__(self):
        for t in self._seq.iter_rows():  # t = (row, id, doc, meta)
            yield t[self._i + 1]


class RowIdMap:
    """id -> latest row, dict-shaped; disk mode shares the RowSeq's SQLite."""

    def __init__(self, seq: RowSeq) -> None:
        self._seq = seq
        self._ram: dict[str, int] | None = {} if seq.backing == "ram" else None

    def get(self, id_: str, default=None):
        if self._ram is not None:
            return self._ram.get(id_, default)
        with self._seq.disk.lock:
            got = self._seq.disk._conn.execute(
                "SELECT row FROM id_map WHERE id = ?", (id_,)).fetchone()
        return got[0] if got else default

    def __setitem__(self, id_: str, row: int) -> None:
        if self._ram is not None:
            self._ram[id_] = row
            return
        with self._seq.disk.lock:
            self._seq.disk._conn.execute(
                "INSERT INTO id_map (id, row) VALUES (?,?) "
                "ON CONFLICT(id) DO UPDATE SET row=excluded.row", (id_, row))
            self._seq.disk._conn.commit()

    def set_many(self, pairs) -> None:
        if self._ram is not None:
            self._ram.update(pairs)
            return
        with self._seq.disk.lock:
            self._seq.disk._conn.executemany(
                "INSERT INTO id_map (id, row) VALUES (?,?) "
                "ON CONFLICT(id) DO UPDATE SET row=excluded.row", list(pairs))
            self._seq.disk._conn.commit()

    def get_many(self, ids) -> dict:
        """id -> row for the ids that exist (one query per ~512 on disk)."""
        ids = list(ids)
        if self._ram is not None:
            return {i: self._ram[i] for i in ids if i in self._ram}
        out: dict = {}
        CH = 512
        with self._seq.disk.lock:
            for i in range(0, len(ids), CH):
                part = ids[i:i + CH]
                q = ",".join("?" * len(part))
                for id_, row in self._seq.disk._conn.execute(
                        f"SELECT id, row FROM id_map WHERE id IN ({q})", part):
                    out[id_] = row
        return out

    def drop_many(self, ids) -> None:
        """Remove ids in one transaction (missing ids are ignored)."""
        ids = list(ids)
        if self._ram is not None:
            for i in ids:
                self._ram.pop(i, None)
            return
        with self._seq.disk.lock:
            self._seq.disk._conn.executemany(
                "DELETE FROM id_map WHERE id = ?", [(i,) for i in ids])
            self._seq.disk._conn.commit()

    def pop(self, id_: str, default=None):
        if self._ram is not None:
            return self._ram.pop(id_, default)
        with self._seq.disk.lock:
            got = self._seq.disk._conn.execute(
                "SELECT row FROM id_map WHERE id = ?", (id_,)).fetchone()
            if got is None:
                return default
            self._seq.disk._conn.execute(
                "DELETE FROM id_map WHERE id = ?", (id_,))
            self._seq.disk._conn.commit()
        return got[0]

    def __getitem__(self, id_: str) -> int:
        row = self.get(id_)
        if row is None:
            raise KeyError(id_)
        return row

    def __delitem__(self, id_: str) -> None:
        if self.pop(id_, None) is None:
            raise KeyError(id_)

    def __contains__(self, id_: str) -> bool:
        return self.get(id_) is not None

    def __len__(self) -> int:
        if self._ram is not None:
            return len(self._ram)
        with self._seq.disk.lock:
            return self._seq.disk._conn.execute(
                "SELECT COUNT(*) FROM id_map").fetchone()[0]
