"""Index persistence: manifest + raw binary shards (port of
tpu_rag/index/store.py, same on-disk format).

The TPU equivalent of Chroma's persist dir (reference vector_store/ —
chroma.sqlite3 + hnswlib data_level0.bin/link_lists.bin segments): a
directory per collection holding

    manifest.json   — dims, dtype, metric, kind, counts, file names
    vectors.<g>.f32 — row-major float32 master vectors
    ids.<g>.jsonl   — one JSON-encoded id per row (format v2; v1 stores
                      carry a single-array ids.json, loaded back-compat)
    meta.<g>.jsonl  — one metadata JSON object per row
    docs.<g>.jsonl  — one JSON-encoded document string per row

Each save writes its files under a fresh tag <g>, then replaces
manifest.json (written to a temporary name) in one rename, then deletes the
files the old manifest named.  A load opens every file its manifest names
before it reads any, so it sees one whole snapshot: the old one, or, if a
save deleted the old files between its reading of the manifest and its
opening of them, the new one on a second reading.  Both packages' loaders
take the file names from the manifest (`files`, `ivf.centroids`), so
tpu_rag loads these stores as they are.

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
import secrets
import time
from pathlib import Path

import numpy as np

from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.ivf import IVFIndex

MANIFEST = "manifest.json"
_YIELD_ROWS = 64       # rows of the row files a save writes between two yields


def iter_store_ids(ids_file):
    """Yield the store's ids in row order from its open ids file.  Format
    v2 streams ids.jsonl line by line; v1 stores (a single JSON array in
    ids.json — e.g. previously-built demo indexes) load whole and
    iterate."""
    if not ids_file.name.endswith(".jsonl"):
        yield from json.loads(ids_file.read())
        return
    for line in ids_file:
        if line.strip():
            yield json.loads(line)


def _manifest_files(manifest: dict) -> list[str]:
    """Every file name a manifest refers to."""
    names = list(manifest.get("files", {}).values())
    if "centroids" in manifest.get("ivf", {}):
        names.append(manifest["ivf"]["centroids"])
    return names


def _read_manifest(p: Path) -> dict | None:
    try:
        return json.loads((p / MANIFEST).read_text(encoding="utf-8"))
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def save_index(index: FlatIndex, path: str | Path) -> None:
    """Write `index` to `path` as the snapshot of one instant.

    The index lock is held only while the save pins what it reads: the live
    row set, the arena generation and the row-store generation (a vacuum
    swaps in fresh ones; rows are never moved within one).  The vector file
    and the row files are then written from that pin with the lock released,
    so searches and adds go on meanwhile.  Rows added or killed during the
    write belong to the next save.  Everything streams: vectors from the
    arena chunk by chunk, ids/meta/docs from the row store batch by batch.
    The files go under a fresh tag and become the store in one rename of
    the manifest (module docstring)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    with index._save_lock:               # saves of one index, one at a time
        old = _read_manifest(p)
        tag = secrets.token_hex(6)
        files = {"vectors": f"vectors.{tag}.f32", "ids": f"ids.{tag}.jsonl",
                 "meta": f"meta.{tag}.jsonl", "docs": f"docs.{tag}.jsonl"}
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
                "files": files,
            }
            centroids = None
            if isinstance(index, IVFIndex):
                manifest["ivf"] = {"nlist": index.nlist, "nprobe": index.nprobe}
                centroids = index._cached_centroids    # replaced, never mutated
                trained_n = int(index._centroids_trained_n)
        # a fresh name: the arena may have ADOPTED a read-only memmap of the
        # old vector file (zero-copy load), whose pages the write loop reads
        manifest["count"] = arena.write_rows(p / files["vectors"], rows=live)
        alive = np.zeros(n_rows, bool)
        alive[live] = True
        # ids as jsonl (format v2): the loader streams all three row files
        # line by line — no 100M-entry list materializes on open
        with open(p / files["ids"], "w", encoding="utf-8") as f_ids, \
                open(p / files["meta"], "w", encoding="utf-8") as f_meta, \
                open(p / files["docs"], "w", encoding="utf-8") as f_docs:
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
            name = f"centroids.{tag}.f32"
            centroids.astype(np.float32).tofile(p / name)
            manifest["ivf"]["centroids"] = name
            manifest["ivf"]["centroids_shape"] = list(centroids.shape)
            manifest["ivf"]["trained_n"] = trained_n
        # the manifest last, in one rename: its presence marks a complete
        # snapshot, and a reader sees the old one or the new one whole
        tmp = p / f"{MANIFEST}.{tag}.tmp"
        tmp.write_text(json.dumps(manifest, indent=2), encoding="utf-8")
        os.replace(tmp, p / MANIFEST)
        if old is not None:
            # a live memmap or an open reader keeps an unlinked file's inode
            for name in set(_manifest_files(old)) - set(_manifest_files(manifest)):
                (p / name).unlink(missing_ok=True)


def _open_snapshot(p: Path):
    """(manifest, open files by role) of the store at p: every file the
    manifest names, opened before any is read.  A save that replaced the
    manifest and deleted its files in between gives FileNotFoundError; the
    caller reads the manifest again."""
    manifest = json.loads((p / MANIFEST).read_text(encoding="utf-8"))
    opened = {}
    try:
        for role, name in manifest["files"].items():
            opened[role] = open(p / name, "rb" if role == "vectors" else "r",
                                encoding=None if role == "vectors" else "utf-8")
        if "centroids" in manifest.get("ivf", {}):
            opened["centroids"] = open(p / manifest["ivf"]["centroids"], "rb")
    except FileNotFoundError:
        for f in opened.values():
            f.close()
        raise
    return manifest, opened


def load_index(path: str | Path, **overrides) -> FlatIndex:
    """Open a saved flat or IVF store; `overrides` are keyword arguments of
    its index class (device, dtype, block_n, nprobe, ...)."""
    p = Path(path)
    for attempt in range(3):
        try:
            manifest, opened = _open_snapshot(p)
            break
        except FileNotFoundError:
            if attempt == 2:
                raise
    try:
        return _load_opened(manifest, opened, overrides)
    finally:
        for f in opened.values():
            f.close()


def _load_opened(manifest: dict, opened: dict, overrides: dict) -> FlatIndex:
    count = manifest["count"]
    dim = manifest["dim"]
    # read-only memmap: the index adopts it zero-copy, so opening a
    # 100M-row store costs no read of the vector file; the first mutation
    # migrates rows to a writable (RAM or disk) backing.  The map outlives
    # the file object and keeps the file's inode after a later save.
    vectors = np.memmap(opened["vectors"], dtype=np.float32,
                        mode="r", shape=(count, dim)) if count else \
        np.zeros((0, dim), np.float32)
    ids = iter_store_ids(opened["ids"])
    ivf_cfg = manifest.get("ivf", {})
    # a sharded index saves its rows like any other: it loads unsharded
    # (the engine shards it again over its mesh)
    is_ivf = manifest["kind"] in ("ivf", "sharded_ivf")
    if is_ivf:
        overrides.setdefault("nlist", ivf_cfg.get("nlist", 0))
        overrides.setdefault("nprobe", ivf_cfg.get("nprobe", 8))
        cls = IVFIndex
    elif manifest["kind"] in ("flat", "sharded_flat", "dist_flat"):
        cls = FlatIndex
    else:
        raise ValueError(f"unknown index kind {manifest['kind']!r}")
    idx = cls(dim, dtype=overrides.pop("dtype", manifest["dtype"]),
              metric=manifest["metric"], **overrides)

    def _doc_meta_iter():
        # stream the jsonl pair line by line — the doc/meta rows flow into
        # the index's row store in batches (RAM bounded even at 100M rows
        # with docmeta_backing="disk")
        for mline, dline in zip(opened["meta"], opened["docs"]):
            if not mline.strip():
                continue
            yield json.loads(dline), json.loads(mline)

    if count:
        idx._bulk_adopt_rows(vectors, ids, _doc_meta_iter(), count=count)
    if is_ivf and "centroids" in ivf_cfg:
        shape = tuple(ivf_cfg["centroids_shape"])
        idx._cached_centroids = np.fromfile(
            opened["centroids"], dtype=np.float32).reshape(shape)
        idx._centroids_trained_n = int(ivf_cfg.get("trained_n", count))
    return idx
