"""RagEngine: the composition root (port of tpu_rag/engine.py).

Owns the encoder + vector index (flat, or IVF with INDEX_KIND=ivf) + SQLite
stores and implements the ingest and retrieval flows the HTTP routes call.
The port carries the /docs/save and /search paths; LLM dispatch, compose,
the summarizer, the cross-encoder and sharding come in later slices.

Errors raised by the kernels or by CUDA are not caught here: they reach the
client as a 500 instead of an empty answer.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from tpu_rag_torch.config import Config
from tpu_rag_torch.device import resolve
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.ivf import IVFIndex
from tpu_rag_torch.index.store import MANIFEST, load_index, save_index
from tpu_rag_torch.ingest.indexer import DocIndexer
from tpu_rag_torch.memory.db import ConversationDB
from tpu_rag_torch.retrieval.hybrid import (clamp_k, filter_meta_hits,
                                            mix_with_recency, result_hits,
                                            vector_hits, vector_hits_batch)
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
from tpu_rag_torch.utils.timing import StageTimings

logger = logging.getLogger(__name__)


class RagEngine:
    def __init__(self, config: Config | None = None, *,
                 encoder=None, index=None) -> None:
        self.config = config or Config()
        # before anything else: a CUDA device without a card raises here
        self.device = resolve(self.config.device)
        self.config.ensure_dirs()

        self._encoder = encoder
        self.db = ConversationDB(self.config.db_path)
        self.index = index if index is not None else self._load_or_create_index()
        self._index_lock = threading.Lock()
        # query-embedding LRU
        self._qvec_cache: "OrderedDict[str, object]" = OrderedDict()
        self._qvec_lock = threading.Lock()
        self._qvec_cache_size = 1024
        # cross-request micro-batching: concurrent query_vector calls fuse
        # into one encoder forward + one index scan (utils/microbatch.py)
        self._microbatcher = None
        if self.config.microbatch:
            from tpu_rag_torch.utils.microbatch import MicroBatcher
            self._microbatcher = MicroBatcher(
                self._run_vector_batch, max_batch=self.config.microbatch_max,
                name="vector_microbatch",
                workers=self.config.microbatch_workers,
                hold_ms=self.config.microbatch_hold_ms)
        self.indexer = DocIndexer(
            self.config.kb_db_path,
            embed_fn=self.embed,
            index=self.index,
            persist_fn=self.persist_index,
        )

    # ------------------------------------------------------------ components

    @property
    def encoder(self):
        if self._encoder is None:
            from tpu_rag_torch.models.biencoder import BiEncoder
            cfg = self.config
            self._encoder = BiEncoder(
                cfg.embedding_model,
                weights_path=cfg.embedding_weights,
                tokenizer_path=cfg.tokenizer_path,
                seq_len=cfg.embed_seq_len,
                batch=cfg.embed_batch,
                device=self.device,
            )
        return self._encoder

    def embed(self, texts: list[str]):
        return self.encoder.embed(texts)

    # ------------------------------------------------------------ index io

    def _index_path(self) -> Path:
        return Path(self.config.persist_dir) / self.config.collection_name

    def _load_or_create_index(self):
        cfg = self.config
        p = self._index_path()
        if (p / MANIFEST).is_file():
            # the configured search mode holds for a loaded store too (the JAX
            # engine drops it there, so INDEX_SEARCH_MODE did nothing on it)
            return load_index(p, block_n=cfg.block_n, search_mode=cfg.index_search_mode,
                              device=self.device)
        kw = dict(dtype=cfg.index_dtype, block_n=cfg.block_n,
                  search_mode=cfg.index_search_mode, device=self.device)
        if cfg.index_kind == "ivf":
            return IVFIndex(self.encoder.dim, nlist=cfg.ivf_nlist, nprobe=cfg.ivf_nprobe, **kw)
        if cfg.index_kind != "flat":
            raise ValueError(f"unknown INDEX_KIND={cfg.index_kind!r}: expected flat or ivf")
        return FlatIndex(self.encoder.dim, **kw)

    def persist_index(self) -> None:
        with self._index_lock:
            save_index(self.index, self._index_path())

    # ------------------------------------------------------------ retrieval

    def _qvec_cached(self, key: str):
        with self._qvec_lock:
            qv = self._qvec_cache.get(key)
            if qv is not None:
                self._qvec_cache.move_to_end(key)
            return qv

    def _qvec_store(self, key: str, qv) -> None:
        with self._qvec_lock:
            self._qvec_cache[key] = qv
            while len(self._qvec_cache) > self._qvec_cache_size:
                self._qvec_cache.popitem(last=False)

    def _fused_vector_hits_batch(self, texts: list[str], k: int,
                                 namespace: str | None,
                                 canonicality: str | None,
                                 cache_qv: bool = True,
                                 k_cap: int = 20,
                                 ) -> list[list[dict]] | None:
        """Embed + search in one call (FlatIndex.search_fused): the encoder
        forward runs in front of the scan and only k scores + ids per query
        come back.  Returns None for the two-step path (any index but a
        plain FlatIndex: an IVFIndex is one by inheritance but holds no flat
        snapshot; an encoder without forward_ids, an empty index, an unseen
        filter tag, or a window larger than one encoder batch).

        cache_qv=False (the microbatch window path) skips reading the query
        embeddings back; repeats of those queries then miss the cache."""
        enc = self.encoder
        if (type(self.index) is not FlatIndex
                or not hasattr(enc, "forward_ids") or len(texts) > enc.batch):
            return None
        with GLOBAL_METRICS.timed("search_stage_tokenize"):
            ids = enc.tokenize_query_ids(texts, batch=enc._bucket(len(texts)))
        with GLOBAL_METRICS.timed("search_stage_device"):
            out = self.index.search_fused(
                enc.forward_ids, ids, len(texts), clamp_k(k, k_cap),
                namespace=namespace or None,
                canonicality=canonicality or None,
                return_qv=cache_qv)
        if out is None:
            return None
        res, qv = out
        if qv is not None:
            for qi, text in enumerate(texts):
                self._qvec_store(hashlib.md5(text.encode("utf-8")).hexdigest(),
                                 qv[qi:qi + 1])
        return [result_hits(res, qi) for qi in range(len(texts))]

    def query_vector(self, query: str, k: int, namespace: str | None,
                     canonicality: str | None, timings: StageTimings | None = None,
                     k_cap: int = 20) -> list[dict]:
        """Embed + index search shaped like the reference's _query_chroma.
        With microbatching on, concurrent calls fuse into one device pass.
        k_cap > 20 lets RERANK_CANDIDATES retrieve deeper than the parity
        clamp (see hybrid.clamp_k)."""
        t = timings or StageTimings()
        if self._microbatcher is not None:
            with t.stage("vector_search"):
                return self._microbatcher.submit(
                    (query, k, namespace, canonicality, k_cap))
        key = hashlib.md5(query.encode("utf-8")).hexdigest()
        qv = self._qvec_cached(key)
        if qv is None:
            # cold query: one fused embed+search call when possible; the
            # embed cost sits inside vector_search by construction
            with t.stage("vector_search"):
                out = self._fused_vector_hits_batch([query], k, namespace,
                                                    canonicality, k_cap=k_cap)
                if out is not None:
                    t.stages.setdefault("embed", 0.0)
                    return out[0]
            with t.stage("embed"):
                qv = self.embed([query])
                self._qvec_store(key, qv)
        with t.stage("vector_search"):
            return vector_hits(self.index, qv, k, namespace, canonicality,
                               cap=k_cap)

    def _run_vector_batch(self, items: list[tuple]) -> list[list[dict]]:
        """MicroBatcher callback: one encoder forward for all cache-miss
        queries, then one index scan per distinct (k, namespace,
        canonicality) group (usually a single group).  A window of distinct
        cold queries sharing one (k, ns, canon, cap) takes the fused path."""
        items = [it if len(it) == 5 else (*it, 20) for it in items]

        if len({tuple(rest) for _, *rest in items}) == 1:
            keys0 = [hashlib.md5(q.encode("utf-8")).hexdigest() for q, *_ in items]
            if (len(set(keys0)) == len(keys0)
                    and all(self._qvec_cached(kk) is None for kk in keys0)):
                _, k1, ns1, canon1, cap1 = items[0]
                hits = self._fused_vector_hits_batch(
                    [q for q, *_ in items], k1, ns1, canon1, cache_qv=False,
                    k_cap=cap1)
                if hits is not None:
                    return hits

        keys = [hashlib.md5(q.encode("utf-8")).hexdigest() for q, *_ in items]
        vecs: dict[str, object] = {}
        for key in set(keys):
            qv = self._qvec_cached(key)
            if qv is not None:
                vecs[key] = qv
        missing_keys, missing_texts = [], []
        for (q, *_), key in zip(items, keys):
            if key not in vecs and key not in missing_keys:
                missing_keys.append(key)
                missing_texts.append(q)
        if missing_texts:
            emb = np.asarray(self.embed(missing_texts))
            for key, v in zip(missing_keys, emb):
                vecs[key] = v[None, :]
                self._qvec_store(key, v[None, :])

        groups: dict[tuple, list[int]] = {}
        for i, (_, k, ns, canon, cap) in enumerate(items):
            groups.setdefault((k, ns, canon, cap), []).append(i)
        results: list[list[dict]] = [[] for _ in items]
        for (k, ns, canon, cap), idxs in groups.items():
            qmat = np.concatenate([np.atleast_2d(vecs[keys[i]]) for i in idxs], axis=0)
            for i, hits in zip(idxs, vector_hits_batch(self.index, qmat, k, ns,
                                                       canon, cap=cap)):
                results[i] = hits
        return results

    def query_vector_batch(self, queries: list[str], k: int, namespace: str | None,
                           canonicality: str | None,
                           k_cap: int = 20) -> list[list[dict]]:
        """Batched embed + search for all queries, in encoder-batch chunks
        through the fused path when it applies, else embed-then-search."""
        enc = self.encoder
        out: list[list[dict]] = []
        for i in range(0, len(queries), enc.batch):
            hits = self._fused_vector_hits_batch(
                queries[i:i + enc.batch], k, namespace, canonicality,
                cache_qv=False, k_cap=k_cap)
            if hits is None:
                return vector_hits_batch(self.index, self.embed(queries), k,
                                         namespace, canonicality, cap=k_cap)
            out.extend(hits)
        return out

    def search_internal(self, query: str, k: int, namespace: str | None,
                        canonicality: str | None, rerank: bool) -> list[dict]:
        """Hybrid merge: vector top-k + FTS top-(k//2), meta-filter both
        (skipped when canonicality == 'meta'), vector hits first, truncate
        to k.  `rerank` is ignored here, as in the reference."""
        doc_hits = self.query_vector(query, k, namespace, canonicality)
        db_hits = self.db.search_kb_fts(query, limit=max(1, (k or 6) // 2))
        do_filter = self.config.filter_meta_default and not (
            (canonicality or "").strip().lower() == "meta"
        )
        doc_hits = filter_meta_hits(doc_hits or [], do_filter, self.config.meta_tags)
        db_hits = filter_meta_hits(db_hits or [], do_filter, self.config.meta_tags)
        return (doc_hits + db_hits)[: max(k, 1)]

    def rerank(self, query: str, hits: list[dict]) -> list[dict]:
        raise NotImplementedError("cross-encoder not yet ported")

    def recency_mix(self, hits: list[dict]) -> list[dict]:
        return mix_with_recency(hits, alpha=self.config.recency_alpha,
                                half_life_days=self.config.half_life_days)

    def warmup(self) -> float:
        """Build the kernels and run one query before serving; returns the
        seconds spent."""
        t0 = time.time()
        self.query_vector("warmup query", 5, None, None)
        dt = time.time() - t0
        logger.info("warmup done in %.1fs", dt)
        return dt

    def shutdown(self) -> None:
        """Stop the microbatcher worker threads so dropping the engine frees
        its device tensors."""
        if self._microbatcher is not None:
            self._microbatcher.stop()
            self._microbatcher = None
