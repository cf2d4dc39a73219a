"""Exact flat index resident in device memory (port of tpu_rag/index/flat.py).

A dense matrix on the device searched by the fused scan kernels of
ops/topk.py (exact below 2M rows, bucketed at and above in "auto" mode).
Mutations (add/delete/upsert) are host-side numpy appends + tombstones; the
device snapshot is refreshed lazily on the next search, and the refresh is
incremental: new rows go into a fixed-capacity device append block and
deletions flip the affected rows' filter tags to PAD_TAG.  A full re-upload
happens only when the append block fills or tombstones pass a threshold.

Snapshots are copy-on-write: a search holds the snapshot dict it started
with, so an append or a kill never writes into a tensor such a search may
hold — each update builds fresh tensors (index_fill / clone-then-write) and
swaps them into a new dict under the index lock.

Differences from the JAX index: no jit caches (PyTorch runs eagerly, so
nothing is keyed on shapes and n_pad is read from the snapshot on every
search), int32 ids are read back directly (the TPU readback's _ID_BIAS
workaround is gone), and the use_pallas / pallas_min_rows switches are gone:
on a CUDA device every scan runs the CUDA kernels.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpu_rag_torch.device import resolve
from tpu_rag_torch.index.arena import VectorArena
from tpu_rag_torch.index.filter import TagVocab
from tpu_rag_torch.index.rowmeta import RowIdMap, RowSeq
from tpu_rag_torch.ops.quant import quantize_int8_np, quantize_int8_rows
from tpu_rag_torch.ops.topk import (BUCKET, PAD_TAG, fused_matmul_topk,
                                    packed_k_scan, select_topk, topk_reference)

# Slack kept free in the append block: adds that would leave less than this
# many free slots force a full rebuild instead.
APPEND_GRANULE = 256

_TORCH_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


def refine_k_scan(dtype: str, refine_factor: int, k: int, n: int,
                  mode: str = "exact") -> int:
    """Candidate count for the two-stage refine (scan k_scan, re-score in
    ~f32, keep top k).  int8 scans the full refine_factor*k — quantization
    error genuinely reorders candidates; bf16 only needs to recover
    rounding-order near-ties, so 2x oversampling suffices.  mode="packed"
    keeps the JAX package's tie-census oversample (packed_k_scan), also
    for f32 storage or refine_factor 0."""
    if mode == "packed":
        return packed_k_scan(k, n)
    if refine_factor <= 0 or dtype not in ("int8", "bfloat16"):
        return k
    f = refine_factor if dtype == "int8" else min(refine_factor, 2)
    return min(max(k * f, k), max(n, 1))


def pad_rows(block_n: int) -> int:
    """Snapshot padding granule: block_n rounded down to whole 128-row
    buckets (the kernels take any n; padding keeps snapshot shapes stable
    as a corpus grows)."""
    return max(BUCKET, (int(block_n) // BUCKET) * BUCKET)


def _quantize_residual(res: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize the storage residual with the host mirror's arithmetic
    (as the JAX index does); exact rows get scale 0."""
    r8, rs = quantize_int8_rows(res, true_division=True)
    rs = torch.where(res.abs().amax(dim=1) > 0, rs, torch.zeros_like(rs))
    return r8, rs


def _kill_tags_2d(ns_lists: torch.Tensor, canon_lists: torch.Tensor, flat_slots):
    """Tombstone (nlist, cap) IVF tag tensors at flattened list*cap+slot
    positions, out of place: returns fresh (ns, canon) tensors, so in-flight
    snapshots keep theirs."""
    idx = torch.as_tensor(np.asarray(flat_slots, np.int64), device=ns_lists.device)
    return tuple(t.reshape(-1).index_fill(0, idx, PAD_TAG).reshape(t.shape)
                 for t in (ns_lists, canon_lists))


@dataclass
class SearchResult:
    """One query's worth of hits lives at index i of each field."""

    ids: list[list[str]]
    similarities: list[list[float]]
    distances: list[list[float]]          # 1 - cosine, parity with Chroma-style distance
    rows: list[list[int]]
    metadatas: list[list[dict]] = field(default_factory=list)
    documents: list[list[str]] = field(default_factory=list)


def _normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.maximum(norms, 1e-12)).astype(np.float32)


class FlatIndex:
    """Exact cosine/IP index. Host master copy in numpy, device snapshot lazily."""

    kind = "flat"

    def __init__(
        self,
        dim: int,
        *,
        dtype: str = "bfloat16",
        metric: str = "cosine",
        block_n: int = 8192,          # snapshot padding granule (see pad_rows)
        search_mode: str = "auto",    # "auto" | "exact" | "bucketed" | "packed"
        master_backing: str | None = None,  # ram | disk | auto (env default)
        master_dir: str | None = None,      # backing-file dir for disk/auto
        docmeta_backing: str | None = None,  # ram | disk (id/doc/meta rows)
        device: str | torch.device = "cuda",
    ) -> None:
        if metric not in ("cosine", "ip"):
            raise ValueError(f"unsupported metric: {metric}")
        if dtype not in ("bfloat16", "float32", "int8", "auto"):
            raise ValueError(f"unsupported index dtype: {dtype}")
        self.device = resolve(device)
        self.dim = dim
        # "auto" resolves per corpus size (see the dtype property): bf16
        # below auto_int8_min_rows, int8 at/above — at scale the scan is
        # bandwidth-bound, int8 halves the bytes, and the always-on
        # two-stage refine re-scores candidates in ~f32
        self._dtype_cfg = dtype
        self.auto_int8_min_rows = 2_000_000
        self.metric = metric
        self.block_n = block_n
        self.search_mode = search_mode
        # "auto" routes to the exact kernel below this row count and to the
        # one-pass bucketed kernel above it (a bucketed miss needs two true
        # top-k members in the same 128-row bucket: P ~ C(k,2)*128/n)
        self.auto_bucketed_min_rows = 2_000_000
        # two-stage refine: scan refine_factor*k (int8) or 2k (bf16)
        # candidates, re-score them in ~f32 and keep k.  0 disables.
        self.refine_factor = 4
        # device-side refine: keep an int8-quantized residual
        # (x_f32 - dequant(stored)) next to the stored vectors and re-score
        # the scan's candidates on the device (stored + residual ~ f32).
        # Costs +1 byte/dim of device memory; capped.
        self.device_refine = True
        self.device_refine_max_rows = 4_000_000

        # Host master copy: growable RAM/disk arena.  All reads go through
        # the `_vectors` property (a numpy view of the live range).
        self._arena = VectorArena(dim, backing=master_backing, dir=master_dir)
        # Per-row id/document/metadata + id->row map: RAM lists by default,
        # SQLite-backed with docmeta_backing="disk"
        import os as _os
        docmeta_backing = docmeta_backing or _os.environ.get(
            "TPU_RAG_DOCMETA_BACKING", "ram")
        self._rowmeta = RowSeq(backing=docmeta_backing, dir=master_dir)
        self._id_to_row = RowIdMap(self._rowmeta)
        # tag/liveness arrays grow with doubled capacity; `_tag_n` rows of
        # the buffers are live, the properties below expose that prefix
        self._tag_n = 0
        self._ns_buf: np.ndarray = np.zeros((0,), np.int32)
        self._canon_buf: np.ndarray = np.zeros((0,), np.int32)
        self._alive_buf: np.ndarray = np.zeros((0,), bool)
        self.ns_vocab = TagVocab()
        self.canon_vocab = TagVocab()

        self._device: dict[str, Any] | None = None  # lazily built snapshot
        self._dirty = True
        # wall-time split of the most recent search() call
        self.last_search_stats: dict[str, float] | None = None
        # incremental snapshot refresh: adds go into a device append block,
        # deletes flip tags; a full re-upload happens only when the block
        # fills or tombstones pass max_dead_fraction
        self.incremental = True
        self.append_capacity = 4096            # rows before forced compaction
        self.max_dead_fraction = 0.3
        # reclaim host arena/row-store space for tombstoned rows whenever a
        # full device rebuild happens with > max_dead_fraction dead rows
        self.auto_vacuum = True
        self._pending_add: list[int] = []      # host rows awaiting device append
        self._pending_dead: list[int] = []     # host rows awaiting device kill
        self._append_rows: np.ndarray | None = None  # append slot -> host row
        self._append_slot: dict[int, int] = {}       # host row -> append slot
        self._dead_since_compact = 0
        self.snapshot_stats = {"full_rebuilds": 0, "incremental_appends": 0,
                               "incremental_kills": 0, "rows_uploaded_last": 0}
        # Upload the snapshot in chunks (instead of staging a full
        # (n_pad, dim) f32 copy host-side) once the staging buffer would
        # exceed this many bytes; only above device_refine_max_rows (the
        # residual needs the whole staged copy, and at refine scale it is
        # small)
        self.stream_upload_bytes = 4 << 30
        self.stream_upload_chunk = 131_072          # rows per streamed chunk
        # guards host-side state and snapshot swaps across concurrent requests
        self._lock = threading.RLock()
        # serializes store saves of this index (store.save_index), which
        # hold _lock only while they pin what they write
        self._save_lock = threading.Lock()

    # Tag/liveness views: writable numpy views of the live prefix.  Bulk
    # replacement goes through _replace_tag_rows (one atomic length update);
    # appends through _append_tag_rows.  There are deliberately NO setters:
    # per-array assignment would leave the shared prefix length inconsistent.
    @property
    def _ns(self) -> np.ndarray:
        return self._ns_buf[: self._tag_n]

    @property
    def _canon(self) -> np.ndarray:
        return self._canon_buf[: self._tag_n]

    @property
    def _alive(self) -> np.ndarray:
        return self._alive_buf[: self._tag_n]

    @property
    def dtype(self) -> str:
        """Storage dtype, resolved: "auto" -> bf16 below auto_int8_min_rows,
        int8 at/above (device_snapshot rebuilds when a corpus crosses the
        threshold — the snapshot records the dtype it was built with)."""
        if self._dtype_cfg != "auto":
            return self._dtype_cfg
        return ("int8" if len(self._alive) and self.count() >= self.auto_int8_min_rows
                else "bfloat16")

    @dtype.setter
    def dtype(self, value: str) -> None:
        self._dtype_cfg = value

    @property
    def dtype_config(self) -> str:
        """The configured (unresolved) dtype — what persistence records."""
        return self._dtype_cfg

    def _replace_tag_rows(self, ns, canon, alive) -> None:
        ns = np.asarray(ns, np.int32)
        canon = np.asarray(canon, np.int32)
        alive = np.asarray(alive, bool)
        if not (len(ns) == len(canon) == len(alive)):
            raise ValueError("tag array length mismatch")
        self._ns_buf, self._canon_buf, self._alive_buf = ns, canon, alive
        self._tag_n = len(ns)

    def _append_tag_rows(self, ns: np.ndarray, canon: np.ndarray) -> None:
        """Append g rows to the tag/liveness buffers (amortized O(g))."""
        g = len(ns)
        need = self._tag_n + g
        if need > len(self._ns_buf):
            cap = max(1024, 2 * len(self._ns_buf), need)
            for name, dtype in (("_ns_buf", np.int32), ("_canon_buf", np.int32),
                                ("_alive_buf", bool)):
                old = getattr(self, name)
                buf = np.zeros((cap,), dtype)
                buf[: len(old)] = old
                setattr(self, name, buf)
        self._ns_buf[self._tag_n : need] = ns
        self._canon_buf[self._tag_n : need] = canon
        self._alive_buf[self._tag_n : need] = True
        self._tag_n = need

    # Read views over the row store (RAM lists or SQLite — rowmeta.py).
    # They support [row], [row_list], len() and iteration; all writes go
    # through self._rowmeta / self._id_to_row.
    @property
    def _ids(self):
        return self._rowmeta.ids

    @property
    def _documents(self):
        return self._rowmeta.docs

    @property
    def _metadatas(self):
        return self._rowmeta.metas

    @property
    def _vectors(self) -> np.ndarray:
        """Live view of the host master rows (RAM or disk-backed)."""
        return self._arena.view

    # ------------------------------------------------------------- mutation

    def add(
        self,
        ids: list[str],
        vectors: np.ndarray,
        documents: list[str] | None = None,
        metadatas: list[dict] | None = None,
    ) -> None:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, got {vectors.shape}")
        if len(ids) != vectors.shape[0]:
            raise ValueError("ids/vectors length mismatch")
        documents = documents or [""] * len(ids)
        metadatas = metadatas or [{} for _ in ids]
        if self.metric == "cosine":
            vectors = _normalize(vectors)

        with self._lock:
            # Upsert semantics: tombstone any existing row with the same id
            # (parity with Chroma upsert used by scripts/build_index.py:89-96).
            # Batched lookups/drops: per-id pops cost one SQLite commit each
            # on the disk backing.
            existing = self._id_to_row.get_many(ids)
            for row in existing.values():
                self._alive[row] = False
                self._note_dead(row)
            self._id_to_row.drop_many(existing.keys())

            start = len(self._rowmeta)
            self._arena.append(vectors)
            ns = np.array([self.ns_vocab.intern(str(m.get("namespace", ""))) for m in metadatas], np.int32)
            canon = np.array([self.canon_vocab.intern(str(m.get("canonicality", ""))) for m in metadatas], np.int32)
            self._append_tag_rows(ns, canon)
            self._rowmeta.extend_rows(
                ids, [d or "" for d in documents],
                [dict(m or {}) for m in metadatas])
            self._id_to_row.set_many(
                (i, start + off) for off, i in enumerate(ids))
            self._note_added(range(start, start + len(ids)))

    upsert = add

    def _note_added(self, rows) -> None:
        """Stage freshly-added host rows for an incremental device append.
        Called under the lock.  Falls back to a full rebuild when the append
        block cannot absorb them (reserving one granule of slack so chunked
        dynamic_update_slice writes never run past the block)."""
        if self._dirty or self._device is None or not self.incremental:
            self._dirty = True
            return
        rows = list(rows)
        fill = int(self._device.get("a_fill", 0))
        if fill + len(self._pending_add) + len(rows) > self.append_capacity - APPEND_GRANULE:
            self._dirty = True
            self._pending_add.clear()
            return
        self._pending_add.extend(rows)

    def _note_dead(self, row: int) -> None:
        """Stage a tombstoned host row for an in-place device tag kill.
        Called under the lock."""
        self._dead_since_compact += 1
        if self._dirty or self._device is None or not self.incremental:
            self._dirty = True
            return
        if self._dead_since_compact > self.max_dead_fraction * max(len(self._rowmeta), 1):
            self._dirty = True  # reclaim tombstoned rows with a full compact
            return
        if row in self._append_slot or self._pending_add.count(row) == 0:
            self._pending_dead.append(row)
        # rows still waiting in _pending_add are dropped before upload
        self._pending_add = [r for r in self._pending_add if r != row]

    def delete(self, ids: list[str] | None = None, where: dict | None = None) -> int:
        """Delete by explicit ids and/or metadata equality (parity with
        Chroma collection.delete(ids=...) / delete(where={'source_key': ...}),
        reference api/app.py:264-271,290-315)."""
        n = 0
        with self._lock:
            if ids:
                found = self._id_to_row.get_many(ids)
                for row in found.values():
                    self._alive[row] = False
                    self._note_dead(row)
                    n += 1
                self._id_to_row.drop_many(found.keys())
            if where:
                # streamed row-order scan: RAM bounded by one rowmeta batch
                # even with the SQLite backing (beyond-RAM corpora); id-map
                # drops batched into one transaction (per-row pops cost one
                # SQLite commit each on the disk backing)
                drop: list[str] = []
                for row, rid, _doc, meta in self._rowmeta.iter_rows():
                    if not self._alive[row]:
                        continue
                    if all(str(meta.get(k)) == str(v) for k, v in where.items()):
                        self._alive[row] = False
                        drop.append(rid)
                        self._note_dead(row)
                        n += 1
                if drop:
                    self._id_to_row.drop_many(drop)
        return n

    def count(self) -> int:
        # count_nonzero, not sum: a bool sum converts every element and, at
        # millions of rows, cost milliseconds on each search (count() and
        # the auto dtype run per search)
        return int(np.count_nonzero(self._alive))

    def compact(self) -> None:
        """Force a full device-snapshot rebuild on the next search: reclaims
        tombstoned rows' HBM and (for IVF) re-clusters absorbed appends."""
        with self._lock:
            self._dirty = True

    def vacuum(self) -> int:
        """Reclaim the HOST storage of tombstoned rows: stream live rows
        into fresh arena / row stores and renumber.  The device snapshot
        already drops dead rows on its own full rebuilds (max_dead_fraction),
        but without a vacuum the host master grows without bound under
        upsert churn.  Returns rows reclaimed.

        Host row NUMBERS change; SearchResult.rows values obtained before a
        vacuum are stale afterwards (ids remain the stable handle, matching
        the reference's contract — reference api/app.py:209-315 addresses
        everything by doc id)."""
        with self._lock:
            live = np.flatnonzero(self._alive)
            dead = len(self._rowmeta) - len(live)
            if dead == 0:
                return 0
            new_arena = VectorArena(self.dim, backing=self._arena.policy,
                                    dir=self._arena._dir,
                                    spill_bytes=self._arena.spill_bytes)
            new_rows = RowSeq(backing=self._rowmeta.backing,
                              dir=self._arena._dir)
            new_map = RowIdMap(new_rows)
            CH = 8192
            src = self._vectors
            for i in range(0, len(live), CH):
                part = live[i:i + CH]
                new_arena.append(src[part])
                rows = self._rowmeta.rows(part.tolist())
                start = new_rows.extend_rows(
                    [t[0] for t in rows], [t[1] for t in rows],
                    [t[2] for t in rows])
                new_map.set_many(
                    (t[0], start + off) for off, t in enumerate(rows))
            # No explicit close of the old arena/row store: in-flight
            # searches may still read them through the snapshot they hold
            # (snapshots carry *_ref generation pointers — device_snapshot);
            # the backing files are deleted by GC finalizers once the last
            # snapshot referencing them is dropped.
            self._arena = new_arena
            self._rowmeta = new_rows
            self._id_to_row = new_map
            self._replace_tag_rows(self._ns[live], self._canon[live],
                                   np.ones(len(live), bool))
            self._dirty = True           # next search rebuilds the snapshot
            self._pending_add.clear()
            self._pending_dead.clear()
            self._dead_since_compact = 0
            self._on_vacuum()            # subclasses drop stale row-number state
            return dead

    def _on_vacuum(self) -> None:
        """Hook: host row NUMBERS changed — subclasses must drop any derived
        state keyed by old row numbers (IVF list membership etc.)."""

    def get(self, id_: str) -> dict | None:
        # under the lock: a concurrent vacuum renumbers rows between the
        # id->row lookup and the row-store read
        with self._lock:
            row = self._id_to_row.get(id_)
            if row is None:
                return None
            _rid, doc, meta = self._rowmeta.row(row)
            return {
                "id": id_,
                "document": doc,
                "metadata": meta,
                "vector": self._vectors[row],
            }

    # ------------------------------------------------------------- device

    def _encode_rows(self, xf: torch.Tensor, g: int, dtype: str):
        """Device form of f32 rows (first g real, the rest zero padding):
        (values, scales, reconstruction f32 for the residual).  int8 padding
        rows keep scale 0; bf16/f32 scales are all ones (the scan ignores
        them).  As in the JAX index, int8 values come from the device
        quantizer and the reconstruction from the host mirror's arithmetic
        (the two differ in a few rounding-boundary values)."""
        if dtype == "int8":
            vals, scales = quantize_int8_rows(xf)
            scales[g:] = 0.0
            q8, s8 = quantize_int8_rows(xf, true_division=True)
            return vals, scales, q8.to(torch.float32) * s8[:, None]
        vals = xf.to(_TORCH_DTYPES[dtype])
        scales = torch.ones((xf.shape[0],), dtype=torch.float32, device=xf.device)
        return vals, scales, vals.to(torch.float32)

    def _compact(self) -> dict[str, Any]:
        """Build the device snapshot from live rows only, padded to the
        pad_rows granule with PAD_TAG tags."""
        live = np.flatnonzero(self._alive)
        n = len(live)
        bn = pad_rows(self.block_n)
        n_pad = max(bn, -(-n // bn) * bn)

        ns = np.full((n_pad,), PAD_TAG, np.int32)
        canon = np.full((n_pad,), PAD_TAG, np.int32)
        ns[:n] = self._ns[live]
        canon[:n] = self._canon[live]

        snap: dict[str, Any] = {
            "rows": live,                      # device row -> host row (ascending)
            "ns": torch.from_numpy(ns).to(self.device),
            "canon": torch.from_numpy(canon).to(self.device),
            "n": n,
            "n_pad": n_pad,
            "bn": bn,
        }
        if (not self._use_device_refine(n_pad)
                and n_pad * self.dim * 4 > self.stream_upload_bytes):
            self._upload_vectors_streamed(snap, live, n, n_pad)
        else:
            vecs = np.zeros((n_pad, self.dim), np.float32)
            vecs[:n] = self._vectors[live]
            xf = torch.from_numpy(vecs).to(self.device)
            del vecs
            snap["vectors"], snap["scales"], recon = self._encode_rows(xf, n, self.dtype)
            if self.dtype != "float32" and self._use_device_refine(n_pad):
                self._attach_residual(snap, xf - recon)
        if self.incremental:
            self._alloc_append_block(snap)
        return snap

    def _upload_vectors_streamed(self, snap: dict[str, Any], live: np.ndarray,
                                 n: int, n_pad: int) -> None:
        """Chunked host->device upload of the master rows: peak extra host
        RAM is one (stream_upload_chunk, dim) f32 staging buffer.  The
        destination tensors are fresh, so writing them in place is safe."""
        vals = torch.zeros((n_pad, self.dim), dtype=_TORCH_DTYPES[self.dtype],
                           device=self.device)
        scales = (torch.zeros if self.dtype == "int8" else torch.ones)(
            (n_pad,), dtype=torch.float32, device=self.device)
        c = self.stream_upload_chunk
        for i in range(0, n, c):
            rows = live[i:i + c]
            chunk = torch.from_numpy(
                np.ascontiguousarray(self._vectors[rows], np.float32)).to(self.device)
            v, s, _ = self._encode_rows(chunk, len(rows), self.dtype)
            vals[i:i + len(rows)] = v
            scales[i:i + len(rows)] = s
        snap["vectors"] = vals
        snap["scales"] = scales
        self.snapshot_stats["streamed_uploads"] = (
            self.snapshot_stats.get("streamed_uploads", 0) + 1)

    def _use_device_refine(self, n_pad: int) -> bool:
        return (self.device_refine and self.refine_factor > 0
                and n_pad <= self.device_refine_max_rows)

    def _attach_residual(self, snap: dict[str, Any], res: torch.Tensor) -> None:
        """int8-quantize the storage residual (x_f32 - dequant(stored)) and
        keep it on the device: the refine re-scores candidates as
        stored + residual ~ f32."""
        snap["r_vectors"], snap["r_scales"] = _quantize_residual(res)

    def _alloc_append_block(self, snap: dict[str, Any]) -> None:
        """Attach an empty fixed-capacity append block to a fresh snapshot."""
        cap, dev = self.append_capacity, self.device
        snap["a_vectors"] = torch.zeros((cap, self.dim), dtype=_TORCH_DTYPES[self.dtype],
                                        device=dev)
        snap["a_scales"] = torch.zeros((cap,), dtype=torch.float32, device=dev)
        snap["a_ns"] = torch.full((cap,), PAD_TAG, dtype=torch.int32, device=dev)
        snap["a_canon"] = torch.full((cap,), PAD_TAG, dtype=torch.int32, device=dev)
        snap["a_fill"] = 0
        if "r_vectors" in snap:
            snap["a_r_vectors"] = torch.zeros((cap, self.dim), dtype=torch.int8, device=dev)
            snap["a_r_scales"] = torch.zeros((cap,), dtype=torch.float32, device=dev)
        self._append_rows = np.full((cap,), -1, np.int64)
        self._append_slot = {}
        # generation-pin the slot->host-row map on the snapshot: a rebuild
        # allocates a fresh map, and readers resolve append hits through the
        # map of the generation they hold
        snap["a_rows_map"] = self._append_rows

    def device_snapshot(self) -> dict[str, Any]:
        with self._lock:
            if (self._device is not None and not self._dirty
                    and self._device.get("dtype", self.dtype) != self.dtype):
                self._dirty = True  # auto dtype crossed its row threshold
            if self._dirty or self._device is None:
                # a full rebuild is the natural moment to also reclaim the
                # HOST copies of tombstoned rows
                if self.auto_vacuum:
                    dead = len(self._rowmeta) - self.count()
                    if dead > self.max_dead_fraction * max(len(self._rowmeta), 1):
                        self.vacuum()
                self._device = self._compact()
                # generation pointers: a vacuum renumbers host rows and swaps
                # in fresh stores — readers resolve rows through the stores
                # their snapshot was built from
                self._device["rowmeta_ref"] = self._rowmeta
                self._device["arena_ref"] = self._arena
                self._device["dtype"] = self.dtype
                self._dirty = False
                self._pending_add.clear()
                self._pending_dead.clear()
                self._dead_since_compact = 0
                self.snapshot_stats["full_rebuilds"] += 1
                self.snapshot_stats["rows_uploaded_last"] = self._device["n"]
            elif self._pending_dead or self._pending_add:
                # copy-on-write: in-flight searches keep the previous dict
                # and its tensors, which the flushes below never modify
                snap = dict(self._device)
                if self._pending_dead:
                    self._flush_kills(snap)
                if self._pending_add:
                    self._flush_appends(snap)
                self._device = snap
            return self._device

    def _flush_kills(self, snap: dict[str, Any]) -> None:
        """Flip tombstoned rows' tags to PAD_TAG — out of place, into fresh
        tag tensors (no vector movement)."""
        base_rows, append_rows = [], []
        for hr in self._pending_dead:
            slot = self._append_slot.get(hr)
            if slot is not None:
                append_rows.append(slot)
                continue
            pos = int(np.searchsorted(snap["rows"], hr))
            if pos < len(snap["rows"]) and snap["rows"][pos] == hr:
                base_rows.append(pos)
        self._pending_dead.clear()
        self._kill_rows(snap, "", base_rows)
        self._kill_rows(snap, "a_", append_rows)
        self.snapshot_stats["incremental_kills"] += len(base_rows) + len(append_rows)

    def _kill_rows(self, snap: dict[str, Any], prefix: str, rows: list[int]) -> None:
        """Set snap[prefix + "ns"/"canon"] to PAD_TAG at `rows`, into fresh
        tensors (in-flight searches keep the old ones)."""
        if not rows:
            return
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        for name in ("ns", "canon"):
            snap[prefix + name] = snap[prefix + name].index_fill(0, idx, PAD_TAG)

    def _flush_appends(self, snap: dict[str, Any]) -> None:
        """Write pending host rows into the append block — transfer O(new
        rows); each touched tensor is cloned first (copy-on-write)."""
        rows = [r for r in self._pending_add if self._alive[r]]
        self._pending_add.clear()
        if not rows:
            return
        fill, g = int(snap["a_fill"]), len(rows)
        # host-side encode of the few new rows, then upload (JAX index parity:
        # int8 through the host mirror quantizer)
        vecs = np.ascontiguousarray(self._vectors[rows], np.float32)
        if snap.get("dtype", self.dtype) == "int8":
            vals, scales = quantize_int8_np(vecs)
            recon = vals.astype(np.float32) * scales[:, None]
            vals, scales = torch.from_numpy(vals), torch.from_numpy(scales)
        else:
            vals = torch.from_numpy(vecs).to(_TORCH_DTYPES[snap.get("dtype", self.dtype)])
            scales = torch.ones((g,), dtype=torch.float32)
            recon = vals.to(torch.float32).numpy()
        updates = {
            "a_vectors": vals, "a_scales": scales,
            "a_ns": torch.from_numpy(self._ns[rows]),
            "a_canon": torch.from_numpy(self._canon[rows]),
        }
        if "a_r_vectors" in snap:
            updates["a_r_vectors"], updates["a_r_scales"] = _quantize_residual(
                torch.from_numpy(vecs - recon))
        for key, val in updates.items():
            new = snap[key].clone()
            new[fill:fill + g] = val.to(self.device)
            snap[key] = new
        for off, hr in enumerate(rows):
            self._append_rows[fill + off] = hr
            self._append_slot[hr] = fill + off
        snap["a_fill"] = fill + g
        self.snapshot_stats["incremental_appends"] += 1
        self.snapshot_stats["rows_uploaded_last"] = g

    # ------------------------------------------------------------- search

    def effective_search_mode(self, n: int) -> str:
        """Resolve "auto" per corpus size: below auto_bucketed_min_rows the
        exact kernel (recall 1.0 by construction); at and above it the
        one-pass bucketed kernel.  "packed" (kernel #2, 18-bit score
        resolution with ties to the lowest row) is never auto-selected: its
        tie census grows with corpus density, so it is an explicit opt-in
        that oversamples by packed_k_scan and refines (on the device from
        the residual where the snapshot has one, else on the host from the
        f32 master)."""
        if self.search_mode != "auto":
            return self.search_mode
        if n >= self.auto_bucketed_min_rows:
            return "bucketed"
        return "exact"

    def _scan_refine_core(self, q: torch.Tensor, snap: dict[str, Any], *,
                          mode: str, k_scan: int, k: int, k_out: int,
                          want_ns: int, want_canon: int, have_append: bool,
                          dev_refine: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """Scan -> append-block scan -> device residual refine -> top k.

        The one body behind both serving entry points: search_fused (encoder
        forward in front) and search() (pre-embedded queries).  Returns
        device tensors (sc, ii): top-k_out scores and device ids (append
        rows at n_pad + slot)."""
        n_pad = snap["n_pad"]
        x, s = snap["vectors"], snap["scales"]
        sc, ii = fused_matmul_topk(
            q, x, k_scan, db_scales=s, ns_tags=snap["ns"],
            canon_tags=snap["canon"], wants=(want_ns, want_canon), mode=mode)
        cap = snap["a_vectors"].shape[0] if have_append else 0
        if have_append:
            # the small, mostly-PAD append block: plain torch, as the JAX
            # index scans it with XLA in the same executable
            sc_a, ii_a = topk_reference(
                q, snap["a_vectors"], min(k_scan, cap), db_scales=snap["a_scales"],
                ns_tags=snap["a_ns"], canon_tags=snap["a_canon"],
                want_ns=want_ns, want_canon=want_canon)
            ii_a = torch.where(ii_a >= 0, ii_a + n_pad, torch.full_like(ii_a, -1))
            sc = torch.cat([sc, sc_a], dim=1)
            ii = torch.cat([ii, ii_a], dim=1)
        if not dev_refine:
            return select_topk(sc, ii, min(k_out, sc.shape[1]))
        # residual refine: stored + int8 residual ~ f32; re-score every
        # candidate with the f32 query and keep the top k
        safe = ii.clamp(0, n_pad - 1).long()
        cand = (x[safe].to(torch.float32) * s[safe][..., None]
                + snap["r_vectors"][safe].to(torch.float32) * snap["r_scales"][safe][..., None])
        if have_append:
            slot = (ii - n_pad).clamp(0, cap - 1).long()
            cand_a = (snap["a_vectors"][slot].to(torch.float32) * snap["a_scales"][slot][..., None]
                      + snap["a_r_vectors"][slot].to(torch.float32)
                      * snap["a_r_scales"][slot][..., None])
            cand = torch.where((ii >= n_pad)[..., None], cand_a, cand)
        exact = torch.einsum("qd,qkd->qk", q.to(torch.float32), cand)
        exact = torch.where((ii >= 0) & torch.isfinite(sc), exact,
                            torch.full_like(exact, -float("inf")))
        return select_topk(exact, ii, k)

    def _search_plan(self, snap: dict[str, Any], k: int) -> dict[str, Any]:
        """Mode, scan depth and refine route of one search on `snap`."""
        mode = self.effective_search_mode(snap["n"])
        k_scan = refine_k_scan(snap.get("dtype", self.dtype), self.refine_factor,
                               k, snap["n"], mode=mode)
        dev_refine = "r_vectors" in snap and k_scan > k
        return {"mode": mode, "k_scan": k_scan, "k": k,
                "k_out": k if dev_refine else k_scan,
                "have_append": "a_vectors" in snap, "dev_refine": dev_refine}

    def _decode_rows(self, sc: np.ndarray, idx: np.ndarray,
                     snap: dict[str, Any]) -> np.ndarray:
        """Device ids -> host rows: base rows via the snapshot map, append
        rows (>= n_pad) via the snapshot's append-slot map."""
        n_pad = snap["n_pad"]
        in_append = idx >= n_pad
        hrows = self._device_to_host_rows(sc, np.where(in_append, -1, idx),
                                          snap["rows"], snap["n"])
        if "a_vectors" in snap and in_append.any():
            rows_map = snap.get("a_rows_map", self._append_rows)
            slots = np.clip(idx - n_pad, 0, len(rows_map) - 1)
            hrows = np.where(in_append & np.isfinite(sc), rows_map[slots], hrows)
        return hrows

    def _merge_append_block(self, q: torch.Tensor, sc: np.ndarray, hrows: np.ndarray,
                            snap: dict[str, Any], k_scan: int, want_ns: int,
                            want_canon: int) -> tuple[np.ndarray, np.ndarray]:
        """Scan the append block (plain torch, as the JAX index scans it with
        XLA) and merge its hits with the base results in host-row space
        (score desc, stable: base hits first among equals)."""
        sc_a, idx_a = topk_reference(
            q, snap["a_vectors"], min(k_scan, snap["a_fill"]), db_scales=snap["a_scales"],
            ns_tags=snap["a_ns"], canon_tags=snap["a_canon"], want_ns=want_ns,
            want_canon=want_canon)
        sc_a, idx_a = sc_a.cpu().numpy(), idx_a.cpu().numpy()
        # resolve through the snapshot's own slot->row map generation
        rows_map = snap.get("a_rows_map", self._append_rows)
        hrows_a = np.where((idx_a >= 0) & np.isfinite(sc_a),
                           rows_map[np.clip(idx_a, 0, len(rows_map) - 1)], -1)
        all_sc = np.concatenate([sc, sc_a], axis=1)
        all_hr = np.concatenate([hrows, hrows_a], axis=1)
        all_sc = np.where(all_hr >= 0, all_sc, -np.inf)
        order = np.argsort(-all_sc, kind="stable", axis=1)[:, :k_scan]
        return (np.take_along_axis(all_sc, order, axis=1),
                np.take_along_axis(all_hr, order, axis=1))

    def _empty_result(self, nq: int) -> SearchResult:
        return SearchResult(ids=[[] for _ in range(nq)],
                            similarities=[[] for _ in range(nq)],
                            distances=[[] for _ in range(nq)],
                            rows=[[] for _ in range(nq)],
                            metadatas=[[] for _ in range(nq)],
                            documents=[[] for _ in range(nq)])

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        namespace: str | None = None,
        canonicality: str | None = None,
    ) -> SearchResult:
        t_enter = time.perf_counter()
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == "cosine":
            queries = _normalize(queries)
        nq = queries.shape[0]

        want_ns = self.ns_vocab.lookup(namespace)
        want_canon = self.canon_vocab.lookup(canonicality)
        if want_ns == -2 or want_canon == -2 or self.count() == 0:
            # filter tag never seen, or empty index -> no hits
            return self._empty_result(nq)

        snap = self.device_snapshot()
        plan = self._search_plan(snap, k)
        t_disp = time.perf_counter()
        sc_t, ii_t = self._scan_refine_core(
            torch.from_numpy(queries).to(self.device), snap,
            want_ns=want_ns, want_canon=want_canon, **plan)
        sc, idx = sc_t.cpu().numpy(), ii_t.cpu().numpy()
        t_done = time.perf_counter()
        hrows = self._decode_rows(sc, idx, snap)
        if plan["k_scan"] > k and not plan["dev_refine"]:
            sc, hrows = self._refine_exact(queries, sc, hrows, k, snap=snap)
        out = self._to_result(sc, hrows, snap=snap)
        t_end = time.perf_counter()
        self.last_search_stats = {
            "prep_s": t_disp - t_enter,          # snapshot + glue
            "device_s": t_done - t_disp,         # launches + device + readback
            "decode_s": t_end - t_done,          # id decode + result build
        }
        return out

    def search_fused(self, forward, ids, nq: int, k: int, *,
                     namespace: str | None = None,
                     canonicality: str | None = None,
                     return_qv: bool = True):
        """Embed + search in one call: `forward(ids) -> (B, dim) f32,
        L2-normalized` on this index's device (BiEncoder.forward_ids) runs
        in front of the scan, and only k scores + ids per query come back
        to the host.  `nq` is the number of real (non-padding) rows of ids.

        Returns (SearchResult, qvecs (nq, dim) np.float32 | None), or None
        when the caller must take the two-step path (empty index or a
        filter tag this index has never seen)."""
        t_enter = time.perf_counter()
        want_ns = self.ns_vocab.lookup(namespace)
        want_canon = self.canon_vocab.lookup(canonicality)
        if want_ns == -2 or want_canon == -2 or self.count() == 0:
            return None
        snap = self.device_snapshot()
        plan = self._search_plan(snap, k)
        host_refine = plan["k_scan"] > k and not plan["dev_refine"]
        t_disp = time.perf_counter()
        q = forward(ids)
        sc_t, ii_t = self._scan_refine_core(q, snap, want_ns=want_ns,
                                            want_canon=want_canon, **plan)
        sc, idx = sc_t[:nq].cpu().numpy(), ii_t[:nq].cpu().numpy()
        qv_np = q[:nq].cpu().numpy() if (return_qv or host_refine) else None
        t_done = time.perf_counter()
        hrows = self._decode_rows(sc, idx, snap)
        if host_refine:
            sc, hrows = self._refine_exact(qv_np, sc, hrows, k, snap=snap)
        out = self._to_result(sc, hrows, snap=snap)
        self.last_search_stats = {
            "prep_s": t_disp - t_enter,          # snapshot + glue
            "device_s": t_done - t_disp,         # forward + scan + readback
            "decode_s": time.perf_counter() - t_done,
        }
        return out, (qv_np if return_qv else None)

    @staticmethod
    def _device_to_host_rows(sc: np.ndarray, idx: np.ndarray,
                             rows_map: np.ndarray, n: int) -> np.ndarray:
        if n == 0 or len(rows_map) == 0:  # base snapshot empty (append-only)
            return np.full(idx.shape, -1, np.int64)
        valid = (idx >= 0) & (idx < n) & np.isfinite(sc)
        safe = np.clip(idx, 0, max(n - 1, 0))
        return np.where(valid, rows_map[safe], -1)

    def _refine_exact(self, queries: np.ndarray, sc: np.ndarray,
                      hrows: np.ndarray, k: int,
                      snap: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Re-score the (few) scanned candidates with the exact f32 master
        copy and keep the top k (int8 two-stage refine).  Rows resolve
        through the snapshot's arena generation: a concurrent vacuum swaps
        in renumbered stores, but this snapshot's row numbers belong to the
        stores it was built from."""
        arena = (snap or {}).get("arena_ref", self._arena)
        vecs = arena.view
        out_sc = np.full((sc.shape[0], k), -np.inf, np.float32)
        out_hr = np.full((sc.shape[0], k), -1, np.int64)
        for qi in range(sc.shape[0]):
            cand = hrows[qi][(hrows[qi] >= 0) & np.isfinite(sc[qi])]
            if len(cand) == 0:
                continue
            exact = vecs[cand] @ queries[qi]
            order = np.argsort(-exact, kind="stable")[:k]
            out_sc[qi, : len(order)] = exact[order]
            out_hr[qi, : len(order)] = cand[order]
        return out_sc, out_hr

    def _to_result(self, sc: np.ndarray, hrows: np.ndarray,
                   snap: dict | None = None) -> SearchResult:
        # collect all valid hit rows first and fetch them in ONE batch from
        # the row store (a single SQL query per ~512 rows on disk backing);
        # resolve through the snapshot's row-store generation (see
        # _refine_exact on why — vacuum renumbers)
        rowmeta = (snap or {}).get("rowmeta_ref", self._rowmeta)
        valid: list[tuple[int, int, float]] = []
        for qi in range(sc.shape[0]):
            for j in range(sc.shape[1]):
                host_row = int(hrows[qi, j])
                s = float(sc[qi, j])
                if host_row >= 0 and np.isfinite(s):
                    valid.append((qi, host_row, s))
        fetched = rowmeta.rows([v[1] for v in valid])
        res = SearchResult(ids=[], similarities=[], distances=[], rows=[], metadatas=[], documents=[])
        for qi in range(sc.shape[0]):
            res.ids.append([])
            res.similarities.append([])
            res.distances.append([])
            res.rows.append([])
            res.metadatas.append([])
            res.documents.append([])
        for (qi, host_row, s), (rid, doc, meta) in zip(valid, fetched):
            res.ids[qi].append(rid)
            res.similarities[qi].append(s)
            res.distances[qi].append(1.0 - s)
            res.rows[qi].append(host_row)
            res.metadatas[qi].append(meta)
            res.documents[qi].append(doc)
        return res

    # ------------------------------------------------------------- state (for persistence)

    def state(self, *, include_vectors: bool = True) -> dict[str, Any]:
        with self._lock:
            return self._state_locked(include_vectors=include_vectors)

    def _state_locked(self, include_vectors: bool = True) -> dict[str, Any]:
        live = np.flatnonzero(self._alive)
        rows = self._rowmeta.rows(live.tolist())  # one batch fetch
        st = {
            "kind": self.kind,
            "dim": self.dim,
            "dtype": self._dtype_cfg,  # "auto" stays unresolved in state
            "metric": self.metric,
            "ids": [t[0] for t in rows],
            "metadatas": [t[2] for t in rows],
            "documents": [t[1] for t in rows],
        }
        if include_vectors:
            st["vectors"] = self._vectors[live]
        return st

    def iter_live_rows(self, batch: int = 4096):
        """Yield (id, doc, meta) for live rows in row order, RAM bounded by
        one batch — the streaming save path (store.save_index) for
        disk-backed masters.  Call with the index lock held."""
        for row, rid, doc, meta in self._rowmeta.iter_rows(batch=batch):
            if self._alive[row]:
                yield rid, doc, meta

    @classmethod
    def from_state(cls, state: dict[str, Any], **kw) -> "FlatIndex":
        idx = cls(state["dim"], dtype=state.get("dtype", "bfloat16"),
                  metric=state.get("metric", "cosine"), **kw)
        if len(state["ids"]):
            if isinstance(state["vectors"], np.memmap):
                # saved stores are opened as read-only memmaps: adopt the
                # rows zero-copy (the vector file is not read until rows are
                # touched); the first mutation migrates to a writable backing
                idx._bulk_adopt(state)
            else:
                # vectors are already normalized; bypass re-normalization by direct add
                idx.add(state["ids"], state["vectors"], state["documents"], state["metadatas"])
        return idx

    def _bulk_adopt(self, state: dict[str, Any]) -> None:
        """Populate a fresh index from a saved state without copying the
        vector rows (load path for disk-backed / beyond-RAM masters).  Rows
        are unique and already normalized — save_index writes live rows only."""
        self._bulk_adopt_rows(
            state["vectors"], state["ids"],
            zip(state["documents"], state["metadatas"]),
            count=len(state["ids"]))

    def _bulk_adopt_rows(self, vectors, ids, doc_meta_iter, *, count: int,
                         batch: int = 8192) -> None:
        """Streaming bulk load: `doc_meta_iter` yields (doc, meta) per row —
        rows flow straight into the row store in batches, so a disk-backed
        load never materializes the full doc/meta lists in RAM."""
        with self._lock:
            if len(self._rowmeta):
                raise RuntimeError("bulk adopt requires an empty index")
            self._arena.adopt(vectors)
            ns = np.empty(count, np.int32)
            canon = np.empty(count, np.int32)
            b_ids: list[str] = []
            b_docs: list[str] = []
            b_metas: list[dict] = []
            row = 0

            def _flush():
                start = len(self._rowmeta)
                self._rowmeta.extend_rows(b_ids, b_docs, b_metas)
                self._id_to_row.set_many(
                    (i, start + off) for off, i in enumerate(b_ids))
                b_ids.clear(); b_docs.clear(); b_metas.clear()

            for rid, (doc, meta) in zip(ids, doc_meta_iter):
                meta = dict(meta or {})
                ns[row] = self.ns_vocab.intern(str(meta.get("namespace", "")))
                canon[row] = self.canon_vocab.intern(
                    str(meta.get("canonicality", "")))
                b_ids.append(rid); b_docs.append(doc or ""); b_metas.append(meta)
                row += 1
                if len(b_ids) >= batch:
                    _flush()
            _flush()
            if row != count:
                raise ValueError(f"bulk adopt: expected {count} rows, got {row}")
            self._replace_tag_rows(ns, canon, np.ones(count, bool))
            self._dirty = True
