"""IVF (inverted-file) approximate index with k-means on the device (port of
tpu_rag/index/ivf.py).

The corpus is coarsely clustered (spherical k-means, ops/kmeans.py); a query
scans only its `nprobe` nearest lists.  Lists are stored padded to a uniform
capacity, so a probe is a dense scan of (cap, d) blocks: kernel #6 (per-list
exact top-k) for small batches and kernel #7 (batch-shared, per-bucket top-m)
for batches of 4 and more — the routing of the JAX index's _build_search_fn,
kept exactly.

Streaming ingestion without a full rebuild: new rows go to the FlatIndex
append block and are searched exactly beside the IVF candidates.  At
compaction, overflow rows are merged into spare slots of the resident lists
on the device (_merge_overflow_device); rows that find no spare slot stay in
the exact overflow partition.  A full re-cluster happens only when that
spill exceeds `rebuild_ratio` of the main partition or the corpus outgrows
the trained centroids (2x).  Deletions tag-kill wherever the row lives
(append block, inverted lists via the host slot map, or overflow), out of
place, so a search keeps the snapshot it started with.

Differences from the JAX index: no jit caches and no use_pallas switch (on
a CUDA device the probes run the CUDA kernels), the overflow merge is one
out-of-place index_put instead of MERGE_GRANULE chunks with buffer donation
(PyTorch needs neither fixed shapes nor donation), and a reuse of the
resident lists also requires that their dtype still matches the index's
(with dtype="auto" crossing 2M rows the JAX index would scatter int8 rows
into bf16 lists).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from tpu_rag_torch.index.flat import (_TORCH_DTYPES, FlatIndex, SearchResult,
                                      _kill_tags_2d, _normalize, refine_k_scan)
from tpu_rag_torch.ops import ivf_probe
from tpu_rag_torch.ops.ivf_build import group_lists
from tpu_rag_torch.ops.kmeans import assign_clusters, kmeans
from tpu_rag_torch.ops.quant import quantize_int8_rows
from tpu_rag_torch.ops.topk import BUCKET, _tag_mask, select_topk, topk_reference

_QUANT_LISTS = 256    # lists quantized per step at a rebuild (bounds memory)


def _probe_impl(q, centroids, vec_lists, scale_lists, ns_lists, canon_lists,
                row_lists, wants, *, nprobe: int, k: int):
    """Plain probe (the JAX index's XLA path): gather every probed list,
    score it with the f32 queries, take an exact top k over all candidates.
    q: (Q, d) f32.  Returns (scores (Q, k'), rows (Q, k') int32 host rows),
    k' = min(k, nprobe * cap)."""
    want_ns, want_canon = wants
    lists = ivf_probe._top_lists(q, centroids, nprobe)           # (Q, nprobe)
    scores = torch.einsum("qd,qpcd->qpc", q.to(torch.float32),
                          vec_lists[lists].to(torch.float32))
    scores = scores * scale_lists[lists]
    ok = _tag_mask(ns_lists[lists], canon_lists[lists], want_ns, want_canon)
    scores = torch.where(ok, scores, torch.full_like(scores, -float("inf")))
    qn = q.shape[0]
    flat_scores = scores.reshape(qn, -1)
    return select_topk(flat_scores, row_lists[lists].reshape(qn, -1),
                       min(k, flat_scores.shape[1]))


class IVFIndex(FlatIndex):
    kind = "ivf"

    def __init__(
        self,
        dim: int,
        *,
        dtype: str = "bfloat16",
        metric: str = "cosine",
        block_n: int = 2048,
        search_mode: str = "exact",
        nlist: int = 0,
        nprobe: int = 8,
        kmeans_iters: int = 15,
        rebuild_ratio: float = 0.2,
        list_cap_factor: float = 1.5,
        seed: int = 0,
        master_backing: str | None = None,
        master_dir: str | None = None,
        docmeta_backing: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """list_cap_factor bounds the padded-list memory: each list holds at
        most cap = factor * (n/nlist) rows; rows beyond the cap spill into
        the exact overflow buffer."""
        super().__init__(dim, dtype=dtype, metric=metric, block_n=block_n,
                         search_mode=search_mode, master_backing=master_backing,
                         master_dir=master_dir, docmeta_backing=docmeta_backing,
                         device=device)
        self.nlist = nlist
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.rebuild_ratio = rebuild_ratio
        self.list_cap_factor = list_cap_factor
        self.seed = seed
        # host row -> flattened list*cap+slot position in the device lists
        # (-1 = not in the main partition); membership of the main partition
        # is derived as flatnonzero(_main_slot_of >= 0)
        self._main_slot_of: np.ndarray = np.zeros((0,), np.int32)
        self._cached_centroids: np.ndarray | None = None  # persisted / last build
        self._centroids_trained_n = 0
        self._list_fill: np.ndarray | None = None  # per-list occupied slots
        # probe the last search took: "batched" (#7), "per_list" (#6),
        # "reference" (_probe_impl) or None (no main partition)
        self.last_probe_route: str | None = None

    # ------------------------------------------------------------- build

    def _auto_nlist(self, n: int) -> int:
        if self.nlist > 0:
            return min(self.nlist, n)
        return max(1, min(int(np.sqrt(n) * 2), n // 8 or 1))

    def _on_vacuum(self) -> None:
        # host rows renumbered: the list-membership maps carry OLD row
        # numbers — drop them so the next _compact rebuilds from scratch
        self._main_slot_of = np.zeros((0,), np.int32)
        self._list_fill = None

    def _compact(self) -> dict[str, Any]:
        live = np.flatnonzero(self._alive)
        n = len(live)
        snap: dict[str, Any] = {"rows": live, "n": n}
        overflow_mask = np.ones(n, bool)

        # a host row is "main" iff it has a list slot; dead main rows keep
        # theirs until the next rebuild, so intersect with the live set
        in_main = np.flatnonzero(self._main_slot_of >= 0)
        main_rows = in_main[self._alive[in_main]] if len(in_main) else np.zeros((0,), np.int64)
        overflow = n - len(main_rows)
        need_rebuild = (
            len(main_rows) == 0
            or overflow > max(64, int(self.rebuild_ratio * max(1, len(main_rows))))
        )
        if need_rebuild and n > 0:
            main_rows = live

        prev = self._device
        reuse_centroids = (
            self._cached_centroids is not None
            and self._cached_centroids.shape[1] == self.dim
            # retrain when the corpus has grown well past what the
            # centroids were trained on
            and len(main_rows) <= 2 * max(1, self._centroids_trained_n)
        )
        # keep the resident lists when the clustering does not change: no
        # row of the main partition crosses host->device
        can_reuse_device = (
            not need_rebuild and reuse_centroids and prev is not None
            and prev.get("nlist", 0) > 0 and prev.get("dtype") == self.dtype
        )
        if can_reuse_device:
            for key in ("vec_lists", "scale_lists", "centroids", "ns_lists",
                        "canon_lists", "row_lists", "nlist"):
                snap[key] = prev[key]
            # dead rows still occupy reused slots, and their incremental kills
            # may have been skipped (_note_dead stages nothing once _dirty is
            # set): kill every dead-but-slotted row here and drop it from the
            # slot map, so each is swept once
            dead_main = in_main[~self._alive[in_main]] if len(in_main) else in_main
            if len(dead_main):
                self._kill_main_slots(snap, self._main_slot_of[dead_main])
                self._main_slot_of[dead_main] = -1
            overflow_mask[np.isin(live, main_rows)] = False
            # streaming build: absorb overflow rows into spare list slots on
            # the device (transfer O(overflow)); the rest stay exact overflow
            remaining = self._merge_overflow_device(snap, live[overflow_mask])
            overflow_mask = np.isin(live, remaining)
        elif len(main_rows) > 0:
            # single corpus upload: k-means and grouping share this tensor
            x_dev = torch.from_numpy(
                np.ascontiguousarray(self._vectors[main_rows], np.float32)).to(self.device)
            if reuse_centroids:
                # persisted / previous centroids: skip k-means, re-assign only
                centroids = self._cached_centroids
                assign_dev = assign_clusters(x_dev, centroids)
            else:
                nlist = self._auto_nlist(len(main_rows))
                centroids, assign_np = kmeans(x_dev, nlist, iters=self.kmeans_iters,
                                              seed=self.seed)
                assign_dev = torch.from_numpy(assign_np).to(self.device)
                self._centroids_trained_n = len(main_rows)
            self._cached_centroids = centroids
            assign = assign_dev.cpu().numpy()
            nlist = centroids.shape[0]
            counts = np.bincount(assign, minlength=nlist)
            mean_count = max(1.0, len(main_rows) / nlist)
            cap = int(min(counts.max(), max(8, self.list_cap_factor * mean_count)))
            # the JAX index rounds cap to whole TPU tiles (8 rows, then 128
            # above 128); kept, so both packages build the same lists and
            # kernel #7's 128-slot buckets tile a list exactly
            cap = max(8, -(-cap // 8) * 8)
            if cap > 128:
                cap = -(-cap // BUCKET) * BUCKET

            vec_lists, ns_lists, canon_lists, row_lists, order, fits = group_lists(
                x_dev,
                torch.from_numpy(self._ns[main_rows]).to(self.device),
                torch.from_numpy(self._canon[main_rows]).to(self.device),
                torch.from_numpy(main_rows.astype(np.int32)).to(self.device),
                assign_dev, nlist=nlist, cap=cap)
            del x_dev
            fits_np = fits.cpu().numpy()
            order_np = order.cpu().numpy()

            # host map: main host row -> flattened (list, slot) position, so
            # later deletions can tag-kill main rows in place on the device
            # (mirrors the slot math of ops/ivf_build.group_lists)
            in_lists_rows = main_rows[order_np[fits_np]]
            assert nlist * cap < 2**31  # flattened slots must fit int32
            sorted_assign = assign[order_np]
            starts = np.searchsorted(sorted_assign, np.arange(nlist))
            slots = np.arange(len(sorted_assign)) - starts[sorted_assign]
            slot_map = np.full(len(self._ids), -1, np.int32)
            slot_map[in_lists_rows] = (sorted_assign * cap + slots)[fits_np].astype(np.int32)
            self._main_slot_of = slot_map
            # per-list occupancy, the device-merge path's free-slot ledger
            self._list_fill = np.bincount(sorted_assign[fits_np],
                                          minlength=nlist).astype(np.int64)

            if self.dtype == "int8":
                vals = torch.empty((nlist, cap, self.dim), dtype=torch.int8, device=self.device)
                scales = torch.empty((nlist, cap), dtype=torch.float32, device=self.device)
                for i in range(0, nlist, _QUANT_LISTS):   # row-wise: same values
                    v, s = quantize_int8_rows(vec_lists[i:i + _QUANT_LISTS].reshape(-1, self.dim))
                    vals[i:i + _QUANT_LISTS] = v.view(-1, cap, self.dim)
                    scales[i:i + _QUANT_LISTS] = s.view(-1, cap)
                snap["vec_lists"], snap["scale_lists"] = vals, scales
            else:
                snap["vec_lists"] = vec_lists.to(_TORCH_DTYPES[self.dtype])
                snap["scale_lists"] = torch.ones((nlist, cap), dtype=torch.float32,
                                                 device=self.device)
            del vec_lists
            snap["centroids"] = torch.from_numpy(np.asarray(centroids, np.float32)).to(self.device)
            snap["ns_lists"] = ns_lists
            snap["canon_lists"] = canon_lists
            snap["row_lists"] = row_lists
            snap["nlist"] = nlist
            # only rows actually placed in lists leave the overflow set
            overflow_mask[np.isin(live, in_lists_rows)] = False
        else:
            snap["nlist"] = 0

        # Overflow (cap-spilled / pre-recluster) rows searched exactly.
        ov_rows = live[overflow_mask]
        snap["ov_rows"] = ov_rows
        if len(ov_rows):
            snap["ov_vectors"] = torch.from_numpy(
                np.ascontiguousarray(self._vectors[ov_rows], np.float32)).to(self.device)
            snap["ov_ns"] = torch.from_numpy(self._ns[ov_rows]).to(self.device)
            snap["ov_canon"] = torch.from_numpy(self._canon[ov_rows]).to(self.device)
            # overflow-local index -> host row, resident on the device
            snap["ov_live"] = torch.from_numpy(ov_rows.astype(np.int32)).to(self.device)
        if self.incremental:
            self._alloc_append_block(snap)
        return snap

    def _merge_overflow_device(self, snap: dict[str, Any],
                               ov_rows: np.ndarray) -> np.ndarray:
        """Merge overflow rows into the resident device lists: assign each to
        its nearest centroid on the device, then write rows into lists with
        spare capacity — one out-of-place index_put per tensor (the JAX
        index scatters MERGE_GRANULE chunks and donates buffers after the
        first, which PyTorch's eager index_put needs neither of).  Returns
        the rows that found no slot (they stay in the exact overflow
        buffer)."""
        nlist = snap.get("nlist", 0)
        if nlist == 0 or len(ov_rows) == 0 or self._list_fill is None:
            return ov_rows
        cap = snap["vec_lists"].shape[1]
        fill = self._list_fill
        if int(np.sum(cap - np.minimum(fill, cap))) <= 0:
            return ov_rows

        x_ov = torch.from_numpy(
            np.ascontiguousarray(self._vectors[ov_rows], np.float32)).to(self.device)
        assign = assign_clusters(x_ov, snap["centroids"]).cpu().numpy().astype(np.int64)

        # rank each row within its target list; rows past the cap spill
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        within = np.arange(len(sa)) - np.searchsorted(sa, sa)
        cand_slot = fill[sa] + within
        ok = cand_slot < cap
        slots = np.full(len(ov_rows), -1, np.int64)
        slots[order[ok]] = cand_slot[ok]
        sel = slots >= 0
        if not sel.any():
            return ov_rows

        x_sel = x_ov[torch.from_numpy(np.flatnonzero(sel)).to(self.device)]
        if snap["vec_lists"].dtype == torch.int8:
            vals, scales = quantize_int8_rows(x_sel)
        else:
            vals = x_sel.to(snap["vec_lists"].dtype)
            scales = torch.ones((len(x_sel),), dtype=torch.float32, device=self.device)
        at = (torch.from_numpy(assign[sel]).to(self.device),
              torch.from_numpy(slots[sel]).to(self.device))
        sel_rows = ov_rows[sel]
        for key, val in (("vec_lists", vals), ("scale_lists", scales),
                         ("ns_lists", self._ns[sel_rows]),
                         ("canon_lists", self._canon[sel_rows]),
                         ("row_lists", sel_rows.astype(np.int32))):
            val = torch.as_tensor(val).to(self.device)
            snap[key] = snap[key].index_put(at, val)

        # host bookkeeping: merged rows are main now (membership IS the
        # slot map — see _compact)
        self._list_fill = fill + np.bincount(assign[sel], minlength=nlist)
        if len(self._main_slot_of) < len(self._ids):
            self._main_slot_of = np.concatenate(
                [self._main_slot_of,
                 np.full(len(self._ids) - len(self._main_slot_of), -1, np.int32)])
        self._main_slot_of[sel_rows] = (assign[sel] * cap + slots[sel]).astype(np.int32)
        self.snapshot_stats["ivf_device_merges"] = (
            self.snapshot_stats.get("ivf_device_merges", 0) + int(sel.sum()))
        return ov_rows[~sel]

    def _kill_main_slots(self, snap: dict[str, Any], slots) -> None:
        """Tag-kill main-partition rows on the device, addressed by flattened
        list*cap+slot positions (out of place)."""
        snap["ns_lists"], snap["canon_lists"] = _kill_tags_2d(
            snap["ns_lists"], snap["canon_lists"], slots)

    def _flush_kills(self, snap: dict[str, Any]) -> None:
        """IVF deletions tag-kill on the device, wherever the row lives: the
        append block, the main inverted lists (via the host slot map), or the
        exact-overflow buffer.  Transfer is O(deleted rows)."""
        append_slots, main_slots, ov_pos = [], [], []
        ov_rows = snap.get("ov_rows", np.zeros((0,), np.int64))
        for hr in self._pending_dead:
            slot = self._append_slot.get(hr)
            if slot is not None:
                append_slots.append(slot)
                continue
            if hr < len(self._main_slot_of) and self._main_slot_of[hr] >= 0:
                main_slots.append(int(self._main_slot_of[hr]))
                # the slot is PAD on the device now; dropping it from the map
                # keeps the reuse-path dead sweep from re-killing this row
                self._main_slot_of[hr] = -1
                continue
            pos = int(np.searchsorted(ov_rows, hr))
            if pos < len(ov_rows) and ov_rows[pos] == hr:
                ov_pos.append(pos)
        self._pending_dead.clear()
        self._kill_rows(snap, "a_", append_slots)
        self._kill_rows(snap, "ov_", ov_pos)
        if main_slots:
            self._kill_main_slots(snap, main_slots)
        self.snapshot_stats["incremental_kills"] += (
            len(append_slots) + len(main_slots) + len(ov_pos))

    # ------------------------------------------------------------- search

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
            return self._empty_result(nq)

        snap = self.device_snapshot()
        nprobe = min(self.nprobe, snap["nlist"]) if snap["nlist"] > 0 else 0
        # int8 two-stage refine (same as FlatIndex)
        k_scan = refine_k_scan(snap.get("dtype", self.dtype), self.refine_factor, k, snap["n"])
        t_disp = time.perf_counter()
        q = torch.from_numpy(queries).to(self.device)
        sc_t, rows_t = self._search_device(q, snap, k_scan, nprobe, (want_ns, want_canon))
        # rows are HOST rows (row_lists/ov_live carry host row ids)
        sc, hrows = sc_t.cpu().numpy(), rows_t.cpu().numpy().astype(np.int64)
        hrows = np.where(np.isfinite(sc), hrows, -1)
        if snap.get("a_fill", 0) > 0:
            sc, hrows = self._merge_append_block(q, sc, hrows, snap, k_scan,
                                                 want_ns, want_canon)
        t_done = time.perf_counter()
        if k_scan > k:
            sc, hrows = self._refine_exact(queries, sc, hrows, k, snap=snap)
        out = self._to_result(sc, hrows, snap=snap)
        self.last_search_stats = {
            "prep_s": t_disp - t_enter,          # snapshot + glue
            "device_s": t_done - t_disp,         # probes + readback + append merge
            "decode_s": time.perf_counter() - t_done,   # refine + result build
        }
        return out

    def _search_device(self, q: torch.Tensor, snap: dict[str, Any], k: int, nprobe: int,
                       wants: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe + exact overflow scan + merge (the JAX index's jitted
        _build_search_fn, with its routing kept exactly)."""
        parts_sc, parts_rows = [], []
        self.last_probe_route = None
        if snap["nlist"] > 0:
            args = (q, snap["centroids"], snap["vec_lists"], snap["scale_lists"],
                    snap["ns_lists"], snap["canon_lists"], snap["row_lists"], wants)
            cap = snap["vec_lists"].shape[1]
            k_main = min(k, nprobe * cap)
            if (q.shape[0] >= 4 and cap % BUCKET == 0
                    and k_main <= nprobe * 2 * (cap // BUCKET)):
                # batch-shared probe: the union of the batch's probed lists is
                # read once and scored against every query (#7)
                self.last_probe_route = "batched"
                sc1, rows1 = ivf_probe.ivf_probe_batched(*args, nprobe=nprobe, k=k_main)
            elif min(k_main, cap) <= ivf_probe.K_EFF_MAX:
                self.last_probe_route = "per_list"
                sc1, rows1 = ivf_probe.ivf_probe_pallas(*args, nprobe=nprobe, k=k_main)
            else:
                self.last_probe_route = "reference"
                sc1, rows1 = _probe_impl(*args, nprobe=nprobe, k=k_main)
            parts_sc.append(sc1)
            parts_rows.append(rows1)
        if len(snap["ov_rows"]):
            ov_vec = snap["ov_vectors"]
            sc2, idx2 = topk_reference(
                q, ov_vec, min(k, ov_vec.shape[0]), ns_tags=snap["ov_ns"],
                canon_tags=snap["ov_canon"], want_ns=wants[0], want_canon=wants[1])
            rows2 = torch.where(idx2 >= 0, snap["ov_live"][idx2.clamp(min=0).long()], -1)
            parts_sc.append(sc2)
            parts_rows.append(rows2)
        if not parts_sc:        # every live row is still in the append block
            return (torch.full((q.shape[0], 0), -float("inf"), device=q.device),
                    torch.full((q.shape[0], 0), -1, dtype=torch.int32, device=q.device))
        all_sc = torch.cat(parts_sc, dim=1)
        all_rows = torch.cat(parts_rows, dim=1)
        return select_topk(all_sc, all_rows, min(k, all_sc.shape[1]))
