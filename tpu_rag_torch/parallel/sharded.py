"""Index/shard parallelism: the corpus sharded over a device mesh (port of
tpu_rag/parallel/sharded.py).

The corpus is row-sharded over the mesh's "data" axis in contiguous blocks.
Each shard lives on its own device and runs the fused scan (#1 exact, #3
bucketed, #2 packed) or probes its own IVF lists (#6); the per-shard top-k
lists then merge into the exact global top-k (the union of per-shard exact
top-k's contains the global top-k).  Every shard's kernels are launched
before any result is read back, so shards on different cards overlap.

Determinism: shards are contiguous row ranges and the merge lays the
candidates out shard by shard and selects with a stable sort
(ops/topk.select_topk), so score ties resolve to the smallest global row
regardless of the shard count, as lax.top_k gives them in tpu_rag.

Differences from the JAX module: no shard_map and no all_gather inside one
process (the shards are tensors on their devices, merged on the first one;
parallel/distributed.py gathers across processes); a shard is held once,
on the first device of its row of the mesh, where tpu_rag replicates it
over the other axes; the flat build uploads each shard in chunks of
`stream_upload_chunk` rows and quantizes on the shard's device, so host
temporaries are one chunk rather than one shard.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpu_rag_torch.index.flat import (_TORCH_DTYPES, FlatIndex, SearchResult,
                                      _normalize, refine_k_scan)
from tpu_rag_torch.index.ivf import IVFIndex, _probe_impl
from tpu_rag_torch.ops import ivf_probe
from tpu_rag_torch.ops.ivf_build import group_lists
from tpu_rag_torch.ops.kmeans import assign_clusters, kmeans
from tpu_rag_torch.ops.quant import quantize_int8_rows
from tpu_rag_torch.ops.topk import (PAD_TAG, fused_matmul_topk, select_topk,
                                    topk_reference)
from tpu_rag_torch.parallel.mesh import Mesh, mesh_from_spec

SHARD_UNIT = 256   # rows: a flat shard is a multiple of two 128-row buckets


def merge_shard_topk(parts: list[tuple[torch.Tensor, torch.Tensor]], k: int,
                     device: torch.device):
    """Global top-k of per-shard (scores, global ids) lists laid out shard
    by shard in ascending row order: a stable sort keeps ties at the
    smallest global row.  -inf slots get id -1."""
    sc = torch.cat([s.to(device) for s, _ in parts], dim=1)
    ids = torch.cat([i.to(device) for _, i in parts], dim=1)
    return select_topk(sc, ids, min(k, sc.shape[1]))


def _kill_positions(tensors: list[torch.Tensor], positions, per_shard: int) -> list[torch.Tensor]:
    """Tag-kill flat positions of shard-major tensors: each position is
    flipped to PAD_TAG only on the shard that owns it, out of place (fresh
    tensors for the touched shards; in-flight searches keep the old ones).
    Moves O(killed rows) to the devices."""
    pos = np.asarray(positions, np.int64)
    out = list(tensors)
    for s in np.unique(pos // per_shard):
        local = pos[pos // per_shard == s] - s * per_shard
        t = out[s]
        idx = torch.as_tensor(local, device=t.device)
        out[s] = t.reshape(-1).index_fill(0, idx, PAD_TAG).reshape(t.shape)
    return out


class ShardedFlatIndex(FlatIndex):
    """FlatIndex whose device snapshot is row-sharded over a mesh axis.

    Adds go to the unsharded append block on the mesh's first device (it
    holds at most `append_capacity` rows, is scanned exactly and merged on
    the host); deletes flip tags in place on the shard that owns the row.
    A /docs/save against a sharded corpus therefore moves O(doc), not
    O(corpus).  The int8 and bf16 refine re-scores from the host f32
    master, as tpu_rag's sharded search does (no device residual)."""

    kind = "sharded_flat"

    def __init__(self, dim: int, *, mesh: Mesh | None = None, axis: str = "data",
                 **kw) -> None:
        self.mesh = mesh if mesh is not None else mesh_from_spec("")
        self.axis = axis
        if "device" in kw:
            raise TypeError("a sharded index takes its devices from `mesh`")
        super().__init__(dim, device=self.shard_devices()[0], **kw)
        self.incremental = True

    def shard_devices(self) -> list[torch.device]:
        return self.mesh.axis_devices(self.axis)

    # ------------------------------------------------------------- build

    def _upload_shard(self, live: np.ndarray, lo: int, g: int, m: int,
                      dev: torch.device, dtype: str):
        """One shard's device arrays: rows live[lo:lo+g] (then m-g padding
        rows), uploaded in chunks and encoded on `dev`.  int8 uses the
        host mirror's true division by 127 (tpu_rag's sharded build
        quantizes on the host); padding rows keep scale 0 and PAD tags."""
        vals = torch.zeros((m, self.dim), dtype=_TORCH_DTYPES[dtype], device=dev)
        scales = (torch.zeros if dtype == "int8" else torch.ones)(
            (m,), dtype=torch.float32, device=dev)
        src, c = self._vectors, self.stream_upload_chunk
        for i in range(0, g, c):
            rows = live[lo + i:lo + min(g, i + c)]
            xf = torch.from_numpy(np.ascontiguousarray(src[rows], np.float32)).to(dev)
            if dtype == "int8":
                v, s = quantize_int8_rows(xf, true_division=True)
                scales[i:i + len(rows)] = s
            else:
                v = xf.to(_TORCH_DTYPES[dtype])
            vals[i:i + len(rows)] = v
            del xf, v
        tags = []
        for arr in (self._ns, self._canon):
            t = np.full((m,), PAD_TAG, np.int32)
            t[:g] = arr[live[lo:lo + g]]
            tags.append(torch.from_numpy(t).to(dev))
        return vals, scales, tags[0], tags[1]

    def _compact(self) -> dict[str, Any]:
        """Streamed per-shard build: shard s holds live rows [s*m, (s+1)*m)
        of a layout padded to a multiple of (shards * 256) rows.  Each
        shard is uploaded and encoded in chunks before the next starts, so
        host temporaries stay O(stream_upload_chunk) rows."""
        devices = self.shard_devices()
        live = np.flatnonzero(self._alive)
        n = len(live)
        unit = len(devices) * SHARD_UNIT
        n_pad = max(unit, -(-n // unit) * unit)
        snap = self._shard_snapshot(live, n, n_pad, devices, row0=0)
        if self.incremental:
            self._alloc_append_block(snap)
        return snap

    def _shard_snapshot(self, live: np.ndarray, n: int, n_pad: int,
                        devices: list[torch.device], *, row0: int,
                        per_shard: int | None = None) -> dict[str, Any]:
        """Snapshot of the shards holding global rows [row0, row0 +
        len(devices) * per_shard) of an n_pad-row layout (per_shard
        defaults to n_pad / len(devices): this process holds them all)."""
        m = per_shard or n_pad // len(devices)
        snap: dict[str, Any] = {"rows": live, "n": n, "n_pad": n_pad, "shard_rows": m,
                                "row0": row0, "vectors": [], "scales": [], "ns": [],
                                "canon": []}
        dtype = self.dtype
        for s, dev in enumerate(devices):
            lo = row0 + s * m
            g = max(0, min(n, lo + m) - lo)
            vals, scales, ns, canon = self._upload_shard(live, lo, g, m, dev, dtype)
            snap["vectors"].append(vals)
            snap["scales"].append(scales)
            snap["ns"].append(ns)
            snap["canon"].append(canon)
        return snap

    def _kill_rows(self, snap: dict[str, Any], prefix: str, rows: list[int]) -> None:
        """Base-snapshot kills flip tags on the owning shard only (global
        device rows -> shard, local row); append-block kills take the
        inherited path."""
        if prefix or not rows:
            return super()._kill_rows(snap, prefix, rows)
        pos = np.asarray(rows, np.int64) - snap["row0"]
        for name in ("ns", "canon"):
            snap[name] = _kill_positions(snap[name], pos, snap["shard_rows"])

    # ------------------------------------------------------------- search

    def _exchange(self, sc: torch.Tensor, gid: torch.Tensor, k: int):
        """Hook for the merge across processes (parallel/distributed.py);
        one process holds every shard here."""
        return sc, gid

    def _scan_shards(self, queries: np.ndarray, snap: dict[str, Any], k: int, mode: str,
                     want_ns: int, want_canon: int):
        """Every shard's scan at depth k (launched shard after shard, none
        read back in between), then the merge on the first device."""
        parts, on = [], {}
        m, row0 = snap["shard_rows"], snap["row0"]
        for s, x in enumerate(snap["vectors"]):
            dev = x.device
            if dev not in on:
                on[dev] = torch.from_numpy(queries).to(dev)
            sc, ii = fused_matmul_topk(
                on[dev], x, k, db_scales=snap["scales"][s], ns_tags=snap["ns"][s],
                canon_tags=snap["canon"][s], want_ns=want_ns, want_canon=want_canon,
                mode=mode)
            gid = torch.where(ii >= 0, ii.to(torch.int64) + (row0 + s * m),
                              torch.full_like(ii, -1, dtype=torch.int64))
            parts.append((sc, gid))
        sc, gid = merge_shard_topk(parts, k, self.device)
        return self._exchange(sc, gid, k)

    def search_fused(self, forward, ids, nq: int, k: int, **kw):
        """The fused embed + scan path holds one flat snapshot: a sharded
        index takes the two-step path (embed, then search)."""
        return None

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        namespace: str | None = None,
        canonicality: str | None = None,
    ) -> SearchResult:
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == "cosine":
            queries = _normalize(queries)
        nq = queries.shape[0]

        want_ns = self.ns_vocab.lookup(namespace)
        want_canon = self.canon_vocab.lookup(canonicality)
        if want_ns == -2 or want_canon == -2 or self.count() == 0:
            return self._empty_result(nq)

        snap = self.device_snapshot()
        # "auto" resolves per SHARD size: n over the shards of the layout
        # (the data axis only, not the mesh's whole device count; every
        # process's shards under torch.distributed)
        mode = self.effective_search_mode(snap["n"] // (snap["n_pad"] // snap["shard_rows"]))
        k_scan = refine_k_scan(snap.get("dtype", self.dtype), self.refine_factor, k,
                               snap["n"], mode=mode)
        sc_t, gid_t = self._scan_shards(queries, snap, k_scan, mode, want_ns, want_canon)
        sc, gid = sc_t.cpu().numpy(), gid_t.cpu().numpy()
        # padding rows sit at the end of the padded layout, so a global row
        # < n is the live-row position directly
        hrows = self._device_to_host_rows(sc, gid, snap["rows"], snap["n"])
        if snap.get("a_fill", 0) > 0:
            sc, hrows = self._merge_append_block(
                torch.from_numpy(queries).to(self.device), sc, hrows, snap, k_scan,
                want_ns, want_canon)
        if k_scan > k:
            sc, hrows = self._refine_exact(queries, sc, hrows, k, snap=snap)
        return self._to_result(sc, hrows, snap=snap)


class ShardedIVFIndex(IVFIndex):
    """IVF lists sharded over the mesh "data" axis: each shard owns the
    inverted lists of its contiguous row range (replicated centroids),
    probes them on its device, and the global top-k merges on the first
    device.  int8 lists and the in-kernel metadata filters work as in the
    single-device IVFIndex.

    Adds go to the unsharded append block; deletes tag-kill in place inside
    the sharded lists or overflow blocks through the host slot maps built
    at compaction.  A full rebuild happens when the append block fills or
    tombstones pass max_dead_fraction."""

    kind = "sharded_ivf"

    def __init__(self, dim: int, *, mesh: Mesh | None = None, axis: str = "data",
                 kmeans_sample: int = 262_144, assign_chunk: int = 65_536, **kw) -> None:
        self.mesh = mesh if mesh is not None else mesh_from_spec("")
        self.axis = axis
        if "device" in kw:
            raise TypeError("a sharded index takes its devices from `mesh`")
        super().__init__(dim, device=self.shard_devices()[0], **kw)
        self.kmeans_sample = kmeans_sample
        # rows per host->device slab of the centroid assignment: bounds
        # the build's host temporaries at assign_chunk * dim * 4 bytes
        self.assign_chunk = assign_chunk
        self.incremental = True
        # int32 maps (4 bytes a row): host row -> s*nlist*cap + list*cap +
        # slot in the sharded lists, or s*ov_cap + pos in the sharded
        # overflow blocks (-1: elsewhere)
        self._s_slot_of = np.zeros((0,), np.int32)
        self._s_ov_of = np.zeros((0,), np.int32)

    def shard_devices(self) -> list[torch.device]:
        return self.mesh.axis_devices(self.axis)

    def _on_vacuum(self) -> None:
        # host rows renumbered: the shard slot maps carry OLD row numbers
        self._s_slot_of = np.zeros((0,), np.int32)
        self._s_ov_of = np.zeros((0,), np.int32)

    # ------------------------------------------------------------- build

    def _compact(self) -> dict[str, Any]:
        """Sharded build on the devices: each shard's rows cross host ->
        device once (f32, one shard at a time); grouping into padded lists
        (ops/ivf_build.group_lists), the final cast or quantization and the
        overflow gather run on the shard's device.  Host temporaries stay
        O(n / shards)."""
        devices = self.shard_devices()
        d_ax = len(devices)
        live = np.flatnonzero(self._alive)
        n = len(live)
        snap: dict[str, Any] = {"rows": live, "n": n, "nlist": 0}
        self._s_slot_of = np.full(len(self._ids), -1, np.int32)
        self._s_ov_of = np.full(len(self._ids), -1, np.int32)
        if n == 0:
            if self.incremental:
                self._alloc_append_block(snap)
            return snap

        # centroids: trained on a subsample (device k-means), reused while
        # the corpus stays within 2x the rows they were trained on
        reuse = (self._cached_centroids is not None
                 and self._cached_centroids.shape[1] == self.dim
                 and n <= 2 * max(1, self._centroids_trained_n))
        if not reuse:
            rng = np.random.default_rng(self.seed)
            pick = (np.arange(n) if n <= self.kmeans_sample
                    else rng.choice(n, self.kmeans_sample, replace=False))
            sub = torch.from_numpy(np.ascontiguousarray(
                self._vectors[live[pick]], np.float32)).to(self.device)
            centroids, _ = kmeans(sub, self._auto_nlist(n), iters=self.kmeans_iters,
                                  seed=self.seed)
            del sub
            self._cached_centroids = np.asarray(centroids)
            self._centroids_trained_n = n
        centroids = np.array(self._cached_centroids, np.float32)     # writable copy
        nlist = centroids.shape[0]

        # every row's nearest centroid, on the device in chunks: the host
        # holds one chunk of vectors and the int32 assignments
        assign = np.empty(n, np.int32)
        c0 = torch.from_numpy(centroids).to(self.device)
        ch = self.assign_chunk
        for i in range(0, n, ch):
            xc = torch.from_numpy(np.ascontiguousarray(
                self._vectors[live[i:i + ch]], np.float32)).to(self.device)
            assign[i:i + ch] = assign_clusters(xc, c0).cpu().numpy()

        # contiguous row shards; one (cap, ov_cap) for every shard
        bounds = np.linspace(0, n, d_ax + 1).astype(np.int64)
        shard_slices = [slice(bounds[i], bounds[i + 1]) for i in range(d_ax)]
        mean_count = max(1.0, (n / d_ax) / nlist)
        cap = int(max(8, self.list_cap_factor * mean_count))
        cap = max(8, -(-cap // 8) * 8)
        spill = [int(np.maximum(np.bincount(assign[sl], minlength=nlist) - cap, 0).sum())
                 for sl in shard_slices]
        max_spill = max(spill) if spill else 0
        ov_cap = max(8, -(-max_spill // 8) * 8)

        keys = ("vec_lists", "scale_lists", "ns_lists", "canon_lists", "row_lists",
                "ov_vectors", "ov_scales", "ov_ns", "ov_canon", "ov_rows_dev", "centroids")
        for key in keys:
            snap[key] = []
        for s, (sl, dev) in enumerate(zip(shard_slices, devices)):
            blocks = self._build_shard(live[sl], assign[sl], nlist, cap, ov_cap, s, dev)
            blocks["centroids"] = torch.from_numpy(centroids).to(dev)
            for key in keys:
                snap[key].append(blocks[key])
        snap["nlist"] = nlist
        snap["cap"] = cap
        snap["ov_cap"] = ov_cap
        snap["have_ov"] = max_spill > 0
        if self.incremental:
            self._alloc_append_block(snap)
        return snap

    def _build_shard(self, rows_s: np.ndarray, a: np.ndarray, nlist: int, cap: int,
                     ov_cap: int, s: int, dev: torch.device) -> dict[str, torch.Tensor]:
        """ONE shard's inverted lists and overflow block on `dev`; also
        records the host slot maps the in-place sharded kills use."""
        x_s = torch.from_numpy(np.ascontiguousarray(self._vectors[rows_s], np.float32)).to(dev)
        vec_l, ns_l, canon_l, row_l, _, _ = group_lists(
            x_s, torch.from_numpy(self._ns[rows_s]).to(dev),
            torch.from_numpy(self._canon[rows_s]).to(dev),
            torch.from_numpy(rows_s.astype(np.int32)).to(dev),
            torch.from_numpy(a).to(dev), nlist=nlist, cap=cap)

        # host bookkeeping mirrors group_lists' slot math (ints only)
        order = np.argsort(a, kind="stable")
        sa = a[order]
        starts = np.searchsorted(sa, np.arange(nlist))
        slots = np.arange(len(a)) - starts[sa]
        fits = slots < cap
        in_rows = rows_s[order[fits]]
        assert (s + 1) * nlist * cap < 2**31  # flattened slots must fit int32
        self._s_slot_of[in_rows] = (s * nlist * cap + (sa * cap + slots)[fits]).astype(np.int32)
        sp_pos = order[~fits]
        sp_rows = rows_s[sp_pos]
        assert (s + 1) * ov_cap < 2**31
        self._s_ov_of[sp_rows] = (s * ov_cap + np.arange(len(sp_rows))).astype(np.int32)

        if self.dtype == "int8":
            vals, scales = quantize_int8_rows(vec_l.reshape(-1, self.dim))
            vec_fin = vals.reshape(nlist, cap, self.dim)
            sc_fin = scales.reshape(nlist, cap)
        else:
            vec_fin = vec_l.to(_TORCH_DTYPES[self.dtype])
            sc_fin = torch.ones((nlist, cap), dtype=torch.float32, device=dev)
        del vec_l

        take = np.zeros(ov_cap, np.int64)
        take[:len(sp_pos)] = sp_pos
        ov_v = x_s[torch.from_numpy(take).to(dev)]      # device gather of spilled rows
        del x_s
        if self.dtype == "int8":
            ov_vals, ov_sc = quantize_int8_rows(ov_v)
        else:
            ov_vals = ov_v.to(_TORCH_DTYPES[self.dtype])
            ov_sc = torch.ones((ov_cap,), dtype=torch.float32, device=dev)
        ov_n = np.full(ov_cap, PAD_TAG, np.int32)
        ov_c = np.full(ov_cap, PAD_TAG, np.int32)
        ov_r = np.full(ov_cap, -1, np.int32)
        ov_n[:len(sp_rows)] = self._ns[sp_rows]
        ov_c[:len(sp_rows)] = self._canon[sp_rows]
        ov_r[:len(sp_rows)] = sp_rows
        return {"vec_lists": vec_fin, "scale_lists": sc_fin, "ns_lists": ns_l,
                "canon_lists": canon_l, "row_lists": row_l,
                "ov_vectors": ov_vals, "ov_scales": ov_sc,
                "ov_ns": torch.from_numpy(ov_n).to(dev),
                "ov_canon": torch.from_numpy(ov_c).to(dev),
                "ov_rows_dev": torch.from_numpy(ov_r).to(dev)}

    def _flush_kills(self, snap: dict[str, Any]) -> None:
        """Deletions tag-kill in place wherever the row lives: the append
        block, a shard's inverted lists (host slot map -> shard, flat list
        position) or a shard's overflow block.  Moves O(deleted rows)."""
        append_slots, main_flat, ov_flat = [], [], []
        for hr in self._pending_dead:
            slot = self._append_slot.get(hr)
            if slot is not None:
                append_slots.append(slot)
                continue
            if hr < len(self._s_slot_of) and self._s_slot_of[hr] >= 0:
                main_flat.append(int(self._s_slot_of[hr]))
                continue
            if hr < len(self._s_ov_of) and self._s_ov_of[hr] >= 0:
                ov_flat.append(int(self._s_ov_of[hr]))
        self._pending_dead.clear()
        self._kill_rows(snap, "a_", append_slots)
        if main_flat:
            per = snap["nlist"] * snap["cap"]
            for name in ("ns_lists", "canon_lists"):
                snap[name] = _kill_positions(snap[name], main_flat, per)
        if ov_flat:
            for name in ("ov_ns", "ov_canon"):
                snap[name] = _kill_positions(snap[name], ov_flat, snap["ov_cap"])
        self.snapshot_stats["incremental_kills"] += (
            len(append_slots) + len(main_flat) + len(ov_flat))

    # ------------------------------------------------------------- search

    def _probe_shard(self, q: torch.Tensor, snap: dict[str, Any], s: int, k: int,
                     nprobe: int, wants: tuple[int, int]):
        """One shard's candidates: the per-list probe (#6; the plain probe
        where min(k, cap) exceeds K_EFF_MAX, tpu_rag's routing: the sharded
        path never takes the batch-shared #7) plus the exact overflow
        block, then the shard's own top k."""
        cap = snap["cap"]
        args = (q, snap["centroids"][s], snap["vec_lists"][s], snap["scale_lists"][s],
                snap["ns_lists"][s], snap["canon_lists"][s], snap["row_lists"][s], wants)
        k_main = min(k, nprobe * cap)
        if min(k_main, cap) <= ivf_probe.K_EFF_MAX:
            self.last_probe_route = "per_list"
            sc1, rows1 = ivf_probe.ivf_probe_pallas(*args, nprobe=nprobe, k=k_main)
        else:
            self.last_probe_route = "reference"
            sc1, rows1 = _probe_impl(*args, nprobe=nprobe, k=k_main)
        parts_sc, parts_rows = [sc1], [rows1.to(torch.int32)]
        if snap["have_ov"]:
            ov_v = snap["ov_vectors"][s]
            sc2, idx2 = topk_reference(
                q, ov_v, min(k, ov_v.shape[0]), db_scales=snap["ov_scales"][s],
                ns_tags=snap["ov_ns"][s], canon_tags=snap["ov_canon"][s],
                want_ns=wants[0], want_canon=wants[1])
            rows2 = torch.where(idx2 >= 0, snap["ov_rows_dev"][s][idx2.clamp(min=0).long()],
                                torch.full_like(idx2, -1))
            parts_sc.append(sc2)
            parts_rows.append(rows2.to(torch.int32))
        local_sc = torch.cat(parts_sc, dim=1)
        local_rows = torch.cat(parts_rows, dim=1)
        return select_topk(local_sc, local_rows, min(k, local_sc.shape[1]))

    def search(self, queries: np.ndarray, k: int, *, namespace: str | None = None,
               canonicality: str | None = None) -> SearchResult:
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == "cosine":
            queries = _normalize(queries)
        nq = queries.shape[0]

        want_ns = self.ns_vocab.lookup(namespace)
        want_canon = self.canon_vocab.lookup(canonicality)
        if want_ns == -2 or want_canon == -2 or self.count() == 0:
            return self._empty_result(nq)

        snap = self.device_snapshot()
        k_scan = refine_k_scan(snap.get("dtype", self.dtype), self.refine_factor, k, snap["n"])
        q0 = torch.from_numpy(queries).to(self.device)
        self.last_probe_route = None
        if snap["nlist"] == 0:
            # base snapshot empty: every live row is in the append block
            sc = np.full((nq, k_scan), -np.inf, np.float32)
            hrows = np.full((nq, k_scan), -1, np.int64)
        else:
            nprobe = min(self.nprobe, snap["nlist"])
            parts, on = [], {}
            for s, vl in enumerate(snap["vec_lists"]):
                dev = vl.device
                if dev not in on:
                    on[dev] = q0.to(dev)
                parts.append(self._probe_shard(on[dev], snap, s, k_scan, nprobe,
                                               (want_ns, want_canon)))
            # rows are host rows already (row_lists carry them): the merge
            # needs no offsets; ties keep the shard order
            sc_t, rows_t = merge_shard_topk(parts, k_scan, self.device)
            sc, hrows = sc_t.cpu().numpy(), rows_t.cpu().numpy().astype(np.int64)
            hrows = np.where(np.isfinite(sc), hrows, -1)
        if snap.get("a_fill", 0) > 0:
            sc, hrows = self._merge_append_block(q0, sc, hrows, snap, k_scan,
                                                 want_ns, want_canon)
        if k_scan > k:
            sc, hrows = self._refine_exact(queries, sc, hrows, k, snap=snap)
        return self._to_result(sc, hrows, snap=snap)
