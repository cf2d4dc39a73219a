"""Index persistence: manifest + raw binary shards (port of
tpu_rag/index/store.py, same on-disk format).

The TPU equivalent of Chroma's persist dir (reference vector_store/ —
chroma.sqlite3 + hnswlib data_level0.bin/link_lists.bin segments): a
directory per collection holding

    manifest.json   — dims, dtype, metric, kind, counts, file names
    vectors.f32     — row-major float32 master vectors
    ids.jsonl       — one JSON-encoded id per row (format v2; v1 stores
                      carry a single-array ids.json, loaded back-compat)
    meta.jsonl      — one metadata JSON object per row
    docs.jsonl      — one JSON-encoded document string per row

The index is always rebuildable from DOCS_DIR (same durability contract as
the reference, SURVEY.md §5 "Checkpoint / resume"), so the store favors
simplicity + mmap-ability over compression.  Quantized/bf16 device forms are
derived at load time.  IVF stores add an `ivf` manifest block (nlist,
nprobe) and, once trained, the centroids (`centroids.f32`, row-major f32)
with the row count they were trained on; a load re-assigns rows to those
centroids instead of re-running k-means.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.ivf import IVFIndex

MANIFEST = "manifest.json"
_YIELD_ROWS = 64       # rows of the row files a save writes between two yields


def iter_store_ids(ids_file: Path):
    """Yield the store's ids in row order.  Format v2 streams ids.jsonl
    line by line; v1 stores (a single JSON array in ids.json — e.g.
    previously-built demo indexes) load whole and iterate."""
    ids_file = Path(ids_file)
    if ids_file.suffix == ".jsonl":
        with open(ids_file, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)
        return
    yield from json.loads(ids_file.read_text(encoding="utf-8"))


def save_index(index: FlatIndex, path: str | Path) -> None:
    """Write `index` to `path` as the snapshot of one instant.

    The index lock is held only while the save pins what it reads: the live
    row set, the arena generation and the row-store generation (a vacuum
    swaps in fresh ones; rows are never moved within one).  The vector file
    and the row files are then written from that pin with the lock released,
    so searches and adds go on meanwhile.  Rows added or killed during the
    write belong to the next save.  Everything streams: vectors from the
    arena chunk by chunk, ids/meta/docs from the row store batch by batch."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    with index._save_lock:               # saves of one index share the temp name
        with index._lock:
            live = np.flatnonzero(index._alive)
            arena, rowmeta = index._arena, index._rowmeta
            n_rows = len(rowmeta)
            manifest = {
                "format_version": 2,
                "kind": index.kind,
                "dim": index.dim,
                "dtype": index.dtype_config,  # "auto" persists unresolved
                "metric": index.metric,
                "count": None,                # the rows written, below
                "files": {"vectors": "vectors.f32", "ids": "ids.jsonl",
                          "meta": "meta.jsonl", "docs": "docs.jsonl"},
            }
            centroids = None
            if isinstance(index, IVFIndex):
                manifest["ivf"] = {"nlist": index.nlist, "nprobe": index.nprobe}
                centroids = index._cached_centroids    # replaced, never mutated
                trained_n = int(index._centroids_trained_n)
        # write to a temp name + rename: the arena may have ADOPTED a
        # read-only memmap of this very vectors.f32 (zero-copy load) —
        # opening it "wb" in place would truncate the pages the write loop
        # is about to read (SIGBUS + a destroyed store).  The rename keeps
        # the old inode alive for any live memmap.
        tmp = p / "vectors.f32.tmp"
        manifest["count"] = arena.write_rows(tmp, rows=live)
        os.replace(tmp, p / "vectors.f32")
        alive = np.zeros(n_rows, bool)
        alive[live] = True
        # ids as jsonl (format v2): the loader streams all three row files
        # line by line — no 100M-entry list materializes on open
        with open(p / "ids.jsonl", "w", encoding="utf-8") as f_ids, \
                open(p / "meta.jsonl", "w", encoding="utf-8") as f_meta, \
                open(p / "docs.jsonl", "w", encoding="utf-8") as f_docs:
            for row, rid, doc, meta in rowmeta.iter_rows():
                if row >= n_rows:
                    break
                if alive[row]:
                    f_ids.write(json.dumps(rid, ensure_ascii=False) + "\n")
                    f_meta.write(json.dumps(meta, ensure_ascii=False) + "\n")
                    f_docs.write(json.dumps(doc, ensure_ascii=False) + "\n")
                if row % _YIELD_ROWS == _YIELD_ROWS - 1:
                    # this loop is pure Python: unless it yields, a search
                    # thread gets the interpreter back only once a switch
                    # interval (5 ms), and a search needs it many times
                    time.sleep(0)
        if centroids is not None:
            centroids.astype(np.float32).tofile(p / "centroids.f32")
            manifest["ivf"]["centroids"] = "centroids.f32"
            manifest["ivf"]["centroids_shape"] = list(centroids.shape)
            manifest["ivf"]["trained_n"] = trained_n
        # Write manifest last: its presence marks a complete snapshot.
        (p / MANIFEST).write_text(json.dumps(manifest, indent=2), encoding="utf-8")


def load_index(path: str | Path, **overrides) -> FlatIndex:
    """Open a saved flat or IVF store; `overrides` are keyword arguments of
    its index class (device, dtype, block_n, nprobe, ...)."""
    p = Path(path)
    manifest = json.loads((p / MANIFEST).read_text(encoding="utf-8"))
    count = manifest["count"]
    dim = manifest["dim"]
    # read-only memmap: the index adopts it zero-copy, so opening a
    # 100M-row store costs no read of the vector file; the first mutation
    # migrates rows to a writable (RAM or disk) backing
    vectors = np.memmap(p / manifest["files"]["vectors"], dtype=np.float32,
                        mode="r", shape=(count, dim)) if count else \
        np.zeros((0, dim), np.float32)
    ids = iter_store_ids(p / manifest["files"]["ids"])
    ivf_cfg = manifest.get("ivf", {})
    if manifest["kind"] == "ivf":
        overrides.setdefault("nlist", ivf_cfg.get("nlist", 0))
        overrides.setdefault("nprobe", ivf_cfg.get("nprobe", 8))
        cls = IVFIndex
    elif manifest["kind"] == "flat":
        cls = FlatIndex
    else:
        raise ValueError(f"unknown index kind {manifest['kind']!r}")
    idx = cls(dim, dtype=overrides.pop("dtype", manifest["dtype"]),
              metric=manifest["metric"], **overrides)

    def _doc_meta_iter():
        # stream the jsonl pair line by line — the doc/meta rows flow into
        # the index's row store in batches (RAM bounded even at 100M rows
        # with docmeta_backing="disk")
        with open(p / manifest["files"]["meta"], encoding="utf-8") as fm, \
                open(p / manifest["files"]["docs"], encoding="utf-8") as fd:
            for mline, dline in zip(fm, fd):
                if not mline.strip():
                    continue
                yield json.loads(dline), json.loads(mline)

    if count:
        idx._bulk_adopt_rows(vectors, ids, _doc_meta_iter(), count=count)
    if manifest["kind"] == "ivf" and "centroids" in ivf_cfg:
        shape = tuple(ivf_cfg["centroids_shape"])
        idx._cached_centroids = np.fromfile(
            p / ivf_cfg["centroids"], dtype=np.float32).reshape(shape)
        idx._centroids_trained_n = int(ivf_cfg.get("trained_n", count))
    return idx
