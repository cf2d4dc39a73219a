"""ctypes binding for the first-party C++ HNSW (native/hnsw.cc; port of
tpu_rag/baseline/hnsw_cpu.py).

The CPU-ANN baseline of BASELINE.md config #1: the reference serves ANN
queries through Chroma -> hnswlib (C++), which is not installed here, so a
benchmark measures the engine's QPS against this implementation of the
same algorithm (cosine HNSW, ef-beam search).  The library builds with g++
at first use (native/binding.py); the same source, M, ef and seed give
tpu_rag's ids and distances.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from tpu_rag_torch.native.binding import load

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    lib = load("hnsw")
    lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint]
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_free.restype = None
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.restype = ctypes.c_int
    lib.hnsw_add.argtypes = [ctypes.c_void_p, _F32P, _I64P, ctypes.c_int]
    lib.hnsw_add.restype = ctypes.c_int
    lib.hnsw_search_batch.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _I64P, _F32P, ctypes.c_int]
    lib.hnsw_search_batch.restype = None
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    return lib


def _as_f32_c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


class CpuHnswIndex:
    """Cosine-space HNSW over float32 vectors (M/ef defaults match hnswlib's
    common configuration; Chroma 0.5 uses M=16, ef_construction=100)."""

    def __init__(self, dim: int, max_elements: int, *, m: int = 16,
                 ef_construction: int = 100, seed: int = 100) -> None:
        self._lib = _lib()
        self.dim = dim
        self._handle = self._lib.hnsw_create(dim, max_elements, m, ef_construction, seed)
        if not self._handle:
            raise RuntimeError("hnsw_create failed")

    def __len__(self) -> int:
        return self._lib.hnsw_size(self._handle)

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> int:
        vectors = _as_f32_c(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors must be (n, {self.dim}), got {vectors.shape}")
        n = vectors.shape[0]
        if ids is None:
            ids = np.arange(len(self), len(self) + n, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        if ids.shape != (n,):
            raise ValueError(f"ids must be ({n},), got {ids.shape}")
        added = self._lib.hnsw_add(self._handle, vectors.ctypes.data_as(_F32P),
                                   ids.ctypes.data_as(_I64P), n)
        if added != n:
            raise RuntimeError(f"index full: added {added}/{n}")
        return added

    def search(self, queries: np.ndarray, k: int, *, ef: int = 64,
               n_threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Batch query. Returns (ids [nq,k] int64 with -1 padding,
        distances [nq,k] float32, cosine distance = 1 - cos)."""
        queries = _as_f32_c(np.atleast_2d(queries))
        if queries.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {queries.shape}")
        nq = queries.shape[0]
        if n_threads is None:
            n_threads = min(nq, os.cpu_count() or 1)
        out_ids = np.empty((nq, k), dtype=np.int64)
        out_scores = np.empty((nq, k), dtype=np.float32)
        self._lib.hnsw_search_batch(self._handle, queries.ctypes.data_as(_F32P), nq, k,
                                    max(ef, k), out_ids.ctypes.data_as(_I64P),
                                    out_scores.ctypes.data_as(_F32P), n_threads)
        return out_ids, out_scores

    def save(self, path: str) -> None:
        """Persist graph + vectors (analogue of hnswlib's on-disk segments)."""
        if self._lib.hnsw_save(self._handle, str(path).encode()) != 0:
            raise RuntimeError(f"hnsw_save failed: {path}")

    @classmethod
    def load(cls, path: str) -> "CpuHnswIndex":
        lib = _lib()
        handle = lib.hnsw_load(str(path).encode())
        if not handle:
            raise RuntimeError(f"hnsw_load failed: {path}")
        obj = cls.__new__(cls)
        obj._lib, obj._handle = lib, handle
        with open(path, "rb") as f:               # the header: (magic, dim, ...)
            obj.dim = struct.unpack("<6i", f.read(24))[1]
        return obj

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hnsw_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
