"""Host-arena IVF: the tier for corpora larger than device memory (port of
tpu_rag/index/host_ivf.py).

The int8 inverted lists, their scales, tags and row ids live in host RAM as
numpy arrays, cap-padded per list so that gathering a list is one
contiguous copy.  The k-means centroids and a small exact overflow partition
(rows spilled past a list's cap) live on the device.  A search:

  1. centroid top-nprobe: an f32 product on the device, ties to the lowest
     list (stable sort), the (Q, nprobe) list ids back to the host;
  2. the union of the batch's probed lists (np.unique) is gathered into a
     pinned staging buffer, so every list crosses the bus once per batch,
     and uploaded once with non_blocking copies;
  3. one fused_matmul_topk over the gathered block in the caller's mode
     (kernel #1 exact by default, #2 for mode="packed"), plus the exact scan
     of the overflow partition; the candidates merge on the host with a
     stable sort.

Differences from the JAX tier: the gathered block is not padded to a
granule of 256 lists (that bounded jit shapes; the port runs eagerly),
k-means draws from a torch.Generator (so centroids differ from the JAX
package's for the same seed; stores carry them), and two faults of the JAX
`load` are not copied: meta.json also keeps cap_factor, max_overflow and
expected_rows, which `load` restores (the JAX defaults where a store lacks
them), and the lists of an mmap load are mapped copy-on-write, so `add`
works after it and leaves the files unchanged (the JAX tier maps them
read-only, and `add` raises).  Stores are the JAX layout and cross both ways.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from tpu_rag_torch.device import resolve
from tpu_rag_torch.ops.ivf_probe import _top_lists
from tpu_rag_torch.ops.kmeans import assign_clusters, kmeans
from tpu_rag_torch.ops.quant import quantize_int8_rows
from tpu_rag_torch.ops.topk import PAD_TAG, fused_matmul_topk

_LIST_FILES = ("vec", "scale", "ns", "canon", "row")


def _save_npy(path: str, arr) -> None:
    """np.save through a temporary file and a rename: a store that an index
    maps keeps its old inode until the index lets go of it."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


class HostArenaIVF:
    """IVF index with host-RAM int8 lists and device-side probe + scan.

    Lifecycle: train(sample) -> add(chunk) x N -> search(...).  add() takes
    f32/bf16 chunks (device tensors or numpy); rows are quantized and
    assigned on the device, then scattered into the host lists, so the f32
    corpus never exists in full anywhere.
    """

    def __init__(self, dim: int, *, nlist: int = 4096, nprobe: int = 32,
                 cap: int = 0, cap_factor: float = 2.0,
                 expected_rows: int = 0, seed: int = 0,
                 max_overflow: int = 1 << 20,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve(device)
        self.dim = dim
        self.nlist = nlist
        self.nprobe = nprobe
        self.seed = seed
        self.cap_factor = cap_factor
        self.expected_rows = expected_rows
        self._cap = cap  # 0 = derive from expected_rows at train()
        self.max_overflow = max_overflow
        self.centroids: torch.Tensor | None = None  # device (nlist, d) f32
        self._vec: np.ndarray | None = None    # (nlist, cap, d) int8
        self._scale: np.ndarray | None = None  # (nlist, cap) f32
        self._ns: np.ndarray | None = None     # (nlist, cap) int32
        self._canon: np.ndarray | None = None
        self._row: np.ndarray | None = None    # (nlist, cap) int32 global row
        self._fill: np.ndarray | None = None   # (nlist,) int64
        # exact overflow (cap-spilled rows), on the device once searched
        self._ov_vec: list[np.ndarray] = []
        self._ov_scale: list[np.ndarray] = []
        self._ov_ns: list[np.ndarray] = []
        self._ov_canon: list[np.ndarray] = []
        self._ov_row: list[np.ndarray] = []
        self._ov_dev: dict[str, Any] | None = None
        self.n_rows = 0
        self.spilled_rows = 0
        # pinned staging buffers of the gathered union, reused across searches
        self._stage: dict[str, torch.Tensor] = {}
        self._stage_lock = threading.Lock()
        # wall-time split (ms) of the most recent search()
        self.last_search_stats: dict[str, float] | None = None

    # ------------------------------------------------------------- build

    @property
    def cap(self) -> int:
        return self._cap

    def train(self, sample) -> None:
        """Spherical k-means on a device-sized sample (f32)."""
        sample = torch.as_tensor(sample, dtype=torch.float32).to(self.device)
        cents, _ = kmeans(sample, self.nlist, iters=10, seed=self.seed)
        self.centroids = torch.from_numpy(cents).to(self.device)
        if self._cap <= 0:
            mean = max(1.0, (self.expected_rows or sample.shape[0] * 40)
                       / self.nlist)
            self._cap = int(-(-int(self.cap_factor * mean) // 128) * 128)
        self._alloc()

    def _alloc(self) -> None:
        nl, cap, d = self.nlist, self._cap, self.dim
        self._vec = np.zeros((nl, cap, d), np.int8)
        self._scale = np.zeros((nl, cap), np.float32)
        self._ns = np.full((nl, cap), PAD_TAG, np.int32)
        self._canon = np.full((nl, cap), PAD_TAG, np.int32)
        self._row = np.full((nl, cap), -1, np.int32)
        self._fill = np.zeros((nl,), np.int64)

    def add(self, vectors, ns=None, canon=None) -> None:
        """Add a chunk: quantize + assign on the device, scatter into the
        host lists.  vectors: (m, d) f32/bf16, numpy or a tensor
        (L2-normalized by the caller).  Transfers: the chunk up (if it is
        on the host), int8 rows + assignments down — O(chunk)."""
        if self.centroids is None:
            raise RuntimeError("train() before add()")
        xd = torch.as_tensor(vectors).to(self.device, torch.float32)
        m = int(xd.shape[0])
        if m == 0:
            return
        v8, s8 = quantize_int8_rows(xd)
        a = assign_clusters(xd, self.centroids)
        v8_np = v8.cpu().numpy()
        s8_np = s8.cpu().numpy()
        a_np = a.cpu().numpy().astype(np.int64)
        ns_np = (np.zeros(m, np.int32) if ns is None
                 else np.asarray(ns, np.int32))
        canon_np = (np.zeros(m, np.int32) if canon is None
                    else np.asarray(canon, np.int32))
        rows = np.arange(self.n_rows, self.n_rows + m, dtype=np.int32)

        # rank each row within its target list; past-cap rows spill
        order = np.argsort(a_np, kind="stable")
        sa = a_np[order]
        within = np.arange(m) - np.searchsorted(sa, sa)
        slot = self._fill[sa] + within
        ok = slot < self._cap
        sel = order[ok]
        l_idx = sa[ok]
        s_idx = slot[ok]
        spill = order[~ok]
        if self.spilled_rows + len(spill) > self.max_overflow:
            raise RuntimeError(
                f"overflow partition would exceed max_overflow="
                f"{self.max_overflow}; raise cap_factor or nlist")
        self._vec[l_idx, s_idx] = v8_np[sel]
        self._scale[l_idx, s_idx] = s8_np[sel]
        self._ns[l_idx, s_idx] = ns_np[sel]
        self._canon[l_idx, s_idx] = canon_np[sel]
        self._row[l_idx, s_idx] = rows[sel]
        np.add.at(self._fill, a_np, 1)
        self._fill = np.minimum(self._fill, self._cap)
        if len(spill):
            self._ov_vec.append(v8_np[spill])
            self._ov_scale.append(s8_np[spill])
            self._ov_ns.append(ns_np[spill])
            self._ov_canon.append(canon_np[spill])
            self._ov_row.append(rows[spill])
            self.spilled_rows += len(spill)
            self._ov_dev = None  # rebuilt at the next search
        self.n_rows += m

    def _overflow_device(self) -> dict[str, Any] | None:
        if not self.spilled_rows:
            return None
        if self._ov_dev is None:
            dev = self.device
            self._ov_dev = {
                "vec": torch.from_numpy(np.concatenate(self._ov_vec)).to(dev),
                "scale": torch.from_numpy(np.concatenate(self._ov_scale)).to(dev),
                "ns": torch.from_numpy(np.concatenate(self._ov_ns)).to(dev),
                "canon": torch.from_numpy(np.concatenate(self._ov_canon)).to(dev),
                "row": np.concatenate(self._ov_row),
            }
        return self._ov_dev

    # ------------------------------------------------------------- search

    def _staging(self, lists: int) -> dict[str, torch.Tensor]:
        """Staging buffers for `lists` gathered lists: pinned host memory
        when the index is on the card (so the uploads can run async), plain
        memory on the CPU.  Grown, never shrunk."""
        rows = lists * self._cap
        if not self._stage or self._stage["vec"].shape[0] < rows:
            pin = self.device.type == "cuda"
            self._stage = {
                "vec": torch.empty((rows, self.dim), dtype=torch.int8, pin_memory=pin),
                "scale": torch.empty((rows,), dtype=torch.float32, pin_memory=pin),
                "ns": torch.empty((rows,), dtype=torch.int32, pin_memory=pin),
                "canon": torch.empty((rows,), dtype=torch.int32, pin_memory=pin),
            }
        return self._stage

    def search(self, queries, k: int, *, nprobe: int = 0,
               want_ns: int = -1, want_canon: int = -1,
               mode: str = "exact"):
        """Returns (scores (Q, k) f32, rows (Q, k) int64; -1 = no hit).
        Scores are int8-quantized inner products (the tier keeps no f32
        master to refine against).  mode: "exact" (kernel #1, the default:
        neighbours pack densely in the gathered lists, where "bucketed"
        loses recall), "packed" (#2) or "bucketed" (#3)."""
        if self._vec is None:
            raise RuntimeError("index is empty (train/add first)")
        t0 = time.perf_counter()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nprobe = min(nprobe or self.nprobe, self.nlist)
        qd = torch.from_numpy(q).to(self.device)
        lists = _top_lists(qd, self.centroids, nprobe).cpu().numpy()  # (Q, nprobe)
        t1 = time.perf_counter()

        uniq = np.unique(lists.reshape(-1))
        u, cap, d = len(uniq), self._cap, self.dim
        n_g = u * cap
        on_card = self.device.type == "cuda"
        with self._stage_lock:
            st = self._staging(min(lists.size, self.nlist))
            # gather: one contiguous (cap, d) copy per unique list, straight
            # into the staging buffers (mode="clip": no buffered copy)
            for name, src in (("vec", self._vec), ("scale", self._scale),
                              ("ns", self._ns), ("canon", self._canon)):
                out = st[name][:n_g].numpy().reshape((u,) + src.shape[1:])
                np.take(src, uniq, axis=0, out=out, mode="clip")
            grow = self._row[uniq].reshape(-1)                 # host-side map
            t2 = time.perf_counter()
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            g = {name: t[:n_g].to(self.device, non_blocking=True)
                 for name, t in st.items()}
            if on_card:
                ev[1].record()
            sc_g, id_g = fused_matmul_topk(
                qd, g["vec"], k, db_scales=g["scale"], ns_tags=g["ns"],
                canon_tags=g["canon"], want_ns=want_ns, want_canon=want_canon,
                mode=mode)
            sc_o = id_o = None
            ov = self._overflow_device()
            if ov is not None:
                sc_o, id_o = fused_matmul_topk(
                    qd, ov["vec"], min(k, ov["vec"].shape[0]),
                    db_scales=ov["scale"], ns_tags=ov["ns"],
                    canon_tags=ov["canon"], want_ns=want_ns,
                    want_canon=want_canon, mode="exact")
            if on_card:
                ev[2].record()
            sc_g, id_g = sc_g.cpu().numpy(), id_g.cpu().numpy()   # syncs
        t3 = time.perf_counter()
        safe = np.clip(id_g, 0, n_g - 1)
        rows_g = np.where(id_g >= 0, grow[safe.reshape(-1)].reshape(id_g.shape),
                          -1).astype(np.int64)
        if sc_o is not None:
            sc_o, id_o = sc_o.cpu().numpy(), id_o.cpu().numpy()
            safe_o = np.clip(id_o, 0, len(ov["row"]) - 1)
            rows_o = np.where(id_o >= 0, ov["row"][safe_o.reshape(-1)]
                              .reshape(id_o.shape), -1).astype(np.int64)
            sc_g = np.concatenate([sc_g, sc_o], axis=1)
            rows_g = np.concatenate([rows_g, rows_o], axis=1)

        ordm = np.argsort(-sc_g, axis=1, kind="stable")[:, :k]
        sc = np.take_along_axis(sc_g, ordm, axis=1)
        rows = np.take_along_axis(rows_g, ordm, axis=1)
        rows = np.where(np.isfinite(sc), rows, -1)
        t4 = time.perf_counter()
        self.last_search_stats = {
            "probe_ms": (t1 - t0) * 1e3,        # centroid top-nprobe + readback
            "gather_ms": (t2 - t1) * 1e3,       # unique + host gather
            "device_ms": (t3 - t2) * 1e3,       # upload + scans + readback
            "merge_ms": (t4 - t3) * 1e3,        # rows + stable merge
            "lists": u, "rows_gathered": n_g,
        }
        if on_card:
            self.last_search_stats["upload_ms"] = ev[0].elapsed_time(ev[1])
            self.last_search_stats["scan_ms"] = ev[1].elapsed_time(ev[2])
        return sc, rows

    # ------------------------------------------------------------- persist

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {"dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
                "cap": self._cap, "n_rows": self.n_rows,
                "spilled_rows": self.spilled_rows, "seed": self.seed,
                "version": 1, "cap_factor": self.cap_factor,
                "max_overflow": self.max_overflow,
                "expected_rows": self.expected_rows}
        for name in _LIST_FILES:
            _save_npy(os.path.join(path, f"lists_{name}.npy"),
                      getattr(self, f"_{name}"))
        _save_npy(os.path.join(path, "fill.npy"), self._fill)
        _save_npy(os.path.join(path, "centroids.npy"),
                  self.centroids.cpu().numpy())
        if self.spilled_rows:
            tmp = os.path.join(path, "overflow.npz.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, vec=np.concatenate(self._ov_vec),
                         scale=np.concatenate(self._ov_scale),
                         ns=np.concatenate(self._ov_ns),
                         canon=np.concatenate(self._ov_canon),
                         row=np.concatenate(self._ov_row))
            os.replace(tmp, os.path.join(path, "overflow.npz"))
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))

    @classmethod
    def load(cls, path: str, *, mmap: bool = True,
             device: str | torch.device = "cuda") -> "HostArenaIVF":
        """mmap=True maps the list arrays from disk (lazy page-in), so the
        tier can serve corpora larger than host RAM.  The mapping is
        copy-on-write: add() writes private pages and never the files."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        ix = cls(meta["dim"], nlist=meta["nlist"], nprobe=meta["nprobe"],
                 cap=meta["cap"], seed=meta.get("seed", 0),
                 cap_factor=meta.get("cap_factor", 2.0),
                 max_overflow=meta.get("max_overflow", 1 << 20),
                 expected_rows=meta.get("expected_rows", 0), device=device)
        mm = "c" if mmap else None
        for name in _LIST_FILES:
            setattr(ix, f"_{name}", np.load(os.path.join(path, f"lists_{name}.npy"),
                                            mmap_mode=mm))
        ix._fill = np.load(os.path.join(path, "fill.npy"))
        ix.centroids = torch.from_numpy(
            np.load(os.path.join(path, "centroids.npy"))).to(ix.device)
        ov_path = os.path.join(path, "overflow.npz")
        if os.path.exists(ov_path):
            with np.load(ov_path) as z:
                ix._ov_vec = [z["vec"]]
                ix._ov_scale = [z["scale"]]
                ix._ov_ns = [z["ns"]]
                ix._ov_canon = [z["canon"]]
                ix._ov_row = [z["row"]]
            ix.spilled_rows = len(ix._ov_row[0])
        ix.n_rows = meta["n_rows"]
        return ix
