"""Growable master-vector storage for the host copy of an index.

The reference keeps its master vectors inside Chroma's persist dir and
mutates them incrementally through hnswlib (reference api/app.py:86-91,
209-225; the on-disk segments under vector_store/).  Our host master was a
plain numpy array: O(n) reallocation per add and bounded by host RAM
(153 GB at 100M x 384 f32).  VectorArena replaces it with a row store that

  - appends with capacity doubling (amortized O(rows added) instead of a
    full copy per `add` call),
  - can live on disk as an np.memmap so the master may exceed host RAM
    ("disk" backing, or "auto" which starts in RAM and spills past a
    threshold), and
  - adopts read-only memmaps zero-copy, so opening a saved store
    (tpu_rag/index/store.py, tpu_rag/parallel/distributed.py) costs no
    read or copy of the vector file until rows are actually touched.

All reads go through `.view` — a numpy view of rows [0, n) that supports
slicing and fancy indexing on either backing (fancy indexing a memmap
returns an in-RAM copy of just the requested rows).

Env knobs (read at construction, overridable per instance):
  TPU_RAG_MASTER_BACKING   ram | disk | auto   (default auto)
  TPU_RAG_MASTER_SPILL_MB  auto-spill threshold in MiB (default 4096)
  TPU_RAG_MASTER_DIR       directory for backing files (default: tempdir)
"""

from __future__ import annotations

import os
import tempfile
import threading
import uuid
import weakref
from pathlib import Path

import numpy as np

_COPY_CHUNK_ROWS = 65536  # rows per chunk for backing migrations / file writes


def _default_spill_bytes() -> int:
    mb = os.environ.get("TPU_RAG_MASTER_SPILL_MB", "4096")
    try:
        return max(1, int(float(mb))) * (1 << 20)
    except ValueError:
        return 4096 << 20


class VectorArena:
    """Append-only (n, dim) float32 row store with RAM or disk backing.

    Rows are never moved once appended (stable row ids — the index layers
    address vectors by host row).  Deletion is the owner's concern
    (FlatIndex tombstones rows and compacts its *device* snapshot; the host
    master keeps dead rows until a future save/load cycle rewrites it).
    """

    def __init__(
        self,
        dim: int,
        *,
        backing: str | None = None,
        dir: str | os.PathLike | None = None,
        spill_bytes: int | None = None,
        initial_rows: int = 1024,
    ) -> None:
        backing = backing or os.environ.get("TPU_RAG_MASTER_BACKING", "auto")
        if backing not in ("ram", "disk", "auto"):
            raise ValueError(f"unknown arena backing: {backing!r}")
        self.dim = int(dim)
        self.policy = backing
        self.spill_bytes = (_default_spill_bytes() if spill_bytes is None
                            else int(spill_bytes))
        self._dir = Path(dir) if dir is not None else None
        self._initial_rows = max(1, int(initial_rows))
        self._n = 0
        self._path: Path | None = None          # backing file when on disk
        self._owns_path = False
        self._adopted = False                   # buf is foreign/read-only
        self._lock = threading.RLock()
        self._finalizer = None
        if backing == "disk":
            self._buf = self._new_disk_buf(self._initial_rows)
        else:  # ram, or auto (starts in RAM)
            self._buf = np.empty((self._initial_rows, self.dim), np.float32)

    # ------------------------------------------------------------- reads

    @property
    def view(self) -> np.ndarray:
        """Numpy view of rows [0, n).  Slices/fancy-indexes on any backing."""
        return self._buf[: self._n]

    def __len__(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        return self._n * self.dim * 4

    @property
    def backing(self) -> str:
        """Where the rows currently live: "ram" or "disk"."""
        return "disk" if isinstance(self._buf, np.memmap) else "ram"

    @property
    def path(self) -> Path | None:
        return self._path

    # ------------------------------------------------------------- writes

    def append(self, rows: np.ndarray) -> tuple[int, int]:
        """Append (g, dim) float32 rows; returns the (start, stop) row range."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (g, {self.dim}) rows, got {rows.shape}")
        g = rows.shape[0]
        with self._lock:
            if g == 0:
                # no capacity work for a no-op append: an adopted read-only
                # store would otherwise trigger a full O(n) migration copy
                return self._n, self._n
            self._ensure_capacity(self._n + g)
            self._buf[self._n : self._n + g] = rows
            start = self._n
            self._n += g
            return start, self._n

    def adopt(self, arr: np.ndarray) -> None:
        """Take `arr` (e.g. a read-only memmap of a saved store) as the row
        store without copying.  The first append after adopting migrates the
        rows into a writable backing chosen by the arena's policy — a
        one-time chunked copy."""
        arr = np.asarray(arr) if not isinstance(arr, np.memmap) else arr
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) rows, got {arr.shape}")
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        with self._lock:
            self._release_backing_file()
            self._buf = arr
            self._n = arr.shape[0]
            self._adopted = True
            self._path = arr.filename if isinstance(arr, np.memmap) else None
            self._owns_path = False

    # ------------------------------------------------------------- io

    def write_rows(self, path: str | os.PathLike, rows: np.ndarray | None = None,
                   chunk_rows: int = _COPY_CHUNK_ROWS) -> int:
        """Stream selected rows (default: all) to `path` as row-major f32,
        RAM bounded by one chunk.  Returns the row count written."""
        # the lock only pins the view: appends land past its rows, and a
        # migration or remap copies into a new buffer while this view keeps
        # the old one, so the write needs no lock (a save must not hold up
        # the appends of the adds that go on meanwhile)
        with self._lock:
            src = self.view
        with open(path, "wb") as f:
            if rows is None:
                # all-rows path: plain slices — no O(n) index array and
                # no fancy-indexing copy on the beyond-RAM export path
                for i in range(0, len(src), chunk_rows):
                    np.ascontiguousarray(src[i : i + chunk_rows],
                                         dtype=np.float32).tofile(f)
                return len(src)
            sel = np.asarray(rows)
            for i in range(0, len(sel), chunk_rows):
                np.ascontiguousarray(src[sel[i : i + chunk_rows]],
                                     dtype=np.float32).tofile(f)
        return len(sel)

    def flush(self) -> None:
        with self._lock:
            if isinstance(self._buf, np.memmap):
                self._buf.flush()

    def close(self) -> None:
        """Drop the buffer and delete any owned backing file."""
        with self._lock:
            self._buf = np.empty((0, self.dim), np.float32)
            self._n = 0
            self._release_backing_file()

    # ------------------------------------------------------------- internals

    def _backing_dir(self) -> Path:
        if self._dir is None:
            env = os.environ.get("TPU_RAG_MASTER_DIR")
            self._dir = Path(env) if env else Path(tempfile.gettempdir())
        self._dir.mkdir(parents=True, exist_ok=True)
        return self._dir

    def _new_disk_buf(self, cap_rows: int) -> np.memmap:
        self._release_backing_file()
        path = self._backing_dir() / f"arena-{uuid.uuid4().hex}.f32"
        buf = np.memmap(path, dtype=np.float32, mode="w+",
                        shape=(cap_rows, self.dim))
        self._path = path
        self._owns_path = True
        # delete the backing file when the arena is garbage collected
        self._finalizer = weakref.finalize(self, _unlink_quiet, str(path))
        return buf

    def _release_backing_file(self) -> None:
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if self._owns_path and self._path is not None:
            _unlink_quiet(str(self._path))
        self._path = None
        self._owns_path = False

    def _grow_disk(self, cap_rows: int) -> None:
        """Extend the backing file and remap (rows stay in place on disk)."""
        assert isinstance(self._buf, np.memmap) and self._owns_path
        self._buf.flush()
        path = self._path
        with open(path, "r+b") as f:
            f.truncate(cap_rows * self.dim * 4)
        self._buf = np.memmap(path, dtype=np.float32, mode="r+",
                              shape=(cap_rows, self.dim))

    def _migrate(self, cap_rows: int, to_disk: bool) -> None:
        """Chunked copy of the live rows into a fresh backing (used on auto
        spill and on the first append after adopting a read-only array)."""
        src = self._buf
        n = self._n
        keep_finalizer = self._finalizer  # may guard an owned source file
        self._finalizer = None
        old_path, old_owned = self._path, self._owns_path
        self._path, self._owns_path = None, False
        if to_disk:
            dst = self._new_disk_buf(cap_rows)
        else:
            dst = np.empty((cap_rows, self.dim), np.float32)
        for i in range(0, n, _COPY_CHUNK_ROWS):
            chunk = src[i : min(i + _COPY_CHUNK_ROWS, n)]
            dst[i : i + chunk.shape[0]] = chunk
        self._buf = dst
        self._adopted = False
        if keep_finalizer is not None:
            keep_finalizer.detach()
        if old_owned and old_path is not None:
            _unlink_quiet(str(old_path))

    def _ensure_capacity(self, need_rows: int) -> None:
        cap = self._buf.shape[0]
        writable = not self._adopted and (
            not isinstance(self._buf, np.memmap) or self._owns_path)
        if need_rows <= cap and writable:
            return
        new_cap = max(self._initial_rows, need_rows, 2 * cap)
        # judge the spill on the capacity ABOUT to be allocated, not the
        # logical rows: doubling growth otherwise held up to 2x the
        # configured threshold in RAM before finally spilling
        cap_bytes = new_cap * self.dim * 4
        if self.policy == "disk":
            spill = True
        elif self.policy == "ram":
            spill = False
        else:  # auto
            spill = cap_bytes > self.spill_bytes or self.backing == "disk"
        if writable and isinstance(self._buf, np.memmap) and spill:
            self._grow_disk(new_cap)
        else:
            self._migrate(new_cap, to_disk=spill)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
