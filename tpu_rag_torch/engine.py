"""RagEngine: the composition root (port of tpu_rag/engine.py).

Owns the encoder + cross-encoder + vector index (flat, or IVF with
INDEX_KIND=ivf) + SQLite stores + LLM dispatcher and implements the ingest,
retrieval, rerank and compose flows the HTTP routes call.  Sharding is not
ported.

Errors raised by the kernels or by CUDA are not caught here: they reach the
client as a 500 (or, for rerank, as /search's `rerank_error`) instead of an
empty answer.  So a cross-encoder that fails to build raises on every
rerank, where tpu_rag's engine remembers the failure and serves unreranked
hits from then on.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from tpu_rag_torch.compose.history import format_history_block, update_thread_summary
from tpu_rag_torch.compose.language import norm_lang
from tpu_rag_torch.compose.prompts import prepare_messages
from tpu_rag_torch.compose.summarize import Summarizer
from tpu_rag_torch.config import Config
from tpu_rag_torch.device import resolve
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.ivf import IVFIndex
from tpu_rag_torch.index.store import MANIFEST, load_index, save_index
from tpu_rag_torch.ingest.indexer import DocIndexer
from tpu_rag_torch.llm import LLMDispatcher
from tpu_rag_torch.memory.db import ConversationDB
from tpu_rag_torch.retrieval.hybrid import (clamp_k, filter_meta_hits,
                                            mix_with_recency, result_hits,
                                            vector_hits, vector_hits_batch)
from tpu_rag_torch.retrieval.rerank import rerank_hits
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
from tpu_rag_torch.utils.timing import StageTimings

logger = logging.getLogger(__name__)

# scripts/train_reranker.py labels the rerank.json row of the serving blend
# f"ensemble_bi+trained_ce(alpha={best_alpha})"
_SERVING_ROW = "ensemble_bi+trained_ce(alpha="


class RagEngine:
    def __init__(self, config: Config | None = None, *,
                 encoder=None, cross_encoder=None, index=None,
                 dispatcher=None) -> None:
        self.config = config or Config()
        # before anything else: a CUDA device without a card raises here
        self.device = resolve(self.config.device)
        self.config.ensure_dirs()

        self._encoder = encoder
        self._cross_encoder = cross_encoder
        self._ce_lock = threading.Lock()
        self._rerank_gate: str | None = None  # lazy quality-gate verdict
        self.db = ConversationDB(self.config.db_path)
        self.dispatcher = dispatcher or LLMDispatcher(self.config)
        self.summarizer = Summarizer(
            self.generate,
            default_language=self.config.default_language,
            mode=self.config.summarize_mode,
        )
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

    def get_cross_encoder(self):
        """Lazy and lock-guarded; a failure to build raises to the caller
        (and again on the next call), where tpu_rag's engine logs it and
        returns None for good."""
        if self._cross_encoder is None:
            with self._ce_lock:
                if self._cross_encoder is None:
                    from tpu_rag_torch.models.crossencoder import CrossEncoder
                    cfg = self.config
                    self._cross_encoder = CrossEncoder(
                        cfg.rerank_model,
                        weights_path=cfg.rerank_weights,
                        tokenizer_path=cfg.tokenizer_path,
                        device=self.device,
                    )
        return self._cross_encoder

    def embed(self, texts: list[str]):
        return self.encoder.embed(texts)

    def generate(self, messages, *, stream: bool = False, engine: str | None = None, **kw):
        return self.dispatcher.generate(messages, stream=stream, engine=engine, **kw)

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
        return rerank_hits(self.get_cross_encoder(), query, hits,
                           mode=self._gated_rerank_mode(),
                           alpha=self.config.rerank_ensemble_alpha)

    def _gated_rerank_mode(self) -> str:
        """Quality gate: a reranker that LOWERS recall must not reorder
        results.  The trainer writes its held-out eval next to the
        checkpoint (scripts/train_reranker.py rerank.json); if the row of
        the blend that serving uses, `ensemble_bi+trained_ce(alpha=X)` with
        X == RERANK_ENSEMBLE_ALPHA, has recall@10 below the bi-encoder's,
        ensemble mode demotes to "annotate" (CE scores attached, retriever
        order kept) with a one-time warning.  No manifest -> trust the
        operator; no row for the serving alpha -> pass, with a warning
        naming the missing label.  Divergence: tpu_rag reads the
        equal-weight row `ensemble_bi+trained_ce`, a blend serving never
        uses."""
        mode = self.config.rerank_mode
        if mode != "ensemble" or not self.config.rerank_weights:
            return mode
        if self._rerank_gate is None:
            self._rerank_gate = self._rerank_gate_verdict()
        return "annotate" if self._rerank_gate == "demote" else mode

    def _rerank_gate_verdict(self) -> str:
        alpha = float(self.config.rerank_ensemble_alpha)
        mpath = os.path.join(os.path.dirname(os.path.abspath(self.config.rerank_weights)),
                             "rerank.json")
        if not os.path.exists(mpath):
            return "pass"
        try:
            with open(mpath) as f:
                rows = json.load(f).get("results", [])
            by = {r.get("label"): r for r in rows}
            serving = None
            for label, row in by.items():
                if (isinstance(label, str) and label.startswith(_SERVING_ROW)
                        and label.endswith(")")
                        and float(label[len(_SERVING_ROW):-1]) == alpha):
                    serving = row
        except (OSError, ValueError, AttributeError) as e:
            logger.warning("rerank quality gate check failed: %s", e)
            return "pass"
        if serving is None:
            logger.warning("rerank quality gate: %s has no row %s%s) for the "
                           "serving RERANK_ENSEMBLE_ALPHA; passing", mpath,
                           _SERVING_ROW, alpha)
            return "pass"
        bi = (by.get("biencoder_top20_no_rerank") or {}).get("recall@10")
        ens = serving.get("recall@10")
        if bi is not None and ens is not None and ens < bi:
            logger.warning(
                "rerank quality gate: checkpoint manifest %s shows the serving "
                "ensemble (alpha=%s) recall@10 %.4f < biencoder %.4f — demoting "
                "RERANK_MODE=ensemble to annotate (scores attached, retriever "
                "order kept)", mpath, alpha, ens, bi)
            return "demote"
        return "pass"

    def recency_mix(self, hits: list[dict]) -> list[dict]:
        return mix_with_recency(hits, alpha=self.config.recency_alpha,
                                half_life_days=self.config.half_life_days)

    # ------------------------------------------------------------ compose

    def build_compose_context(self, hits: list[dict], thread_id: str,
                              lang: str | None) -> tuple[str, int]:
        """history block + summarized RAG context (reference
        api/routes/chat.py:135-141 combined_ctx assembly)."""
        history_block = format_history_block(self.db, self.summarizer, thread_id, lang)
        rag_context, used_hits = self.summarizer.build_context(
            hits, language=lang, max_chars=self.config.max_context_chars,
            max_chars_per_chunk=600,
        )
        combined = (
            f"<<<HISTORY_START>>>\n{history_block}\n<<<HISTORY_END>>>\n\n"
            if history_block else ""
        ) + rag_context
        return combined, used_hits

    def prepare_messages(self, query: str, context: str, mode: str,
                         language: str | None, target_length: str | None = None,
                         style: dict | None = None):
        return prepare_messages(query, context, mode, language,
                                target_length=target_length, style=style,
                                default_language=self.config.default_language)

    def norm_lang(self, lang: str | None) -> str:
        return norm_lang(lang, self.config.default_language)

    def update_summary(self, thread_id: str, query: str, draft: str, lang: str | None) -> None:
        update_thread_summary(self.db, self.summarizer, thread_id, query, draft, lang)

    def new_thread_id(self) -> str:
        return f"auto-{int(time.time() * 1000)}"

    def warmup(self, *, rerank: bool = False) -> float:
        """Build the kernels and run one query (and, with rerank, one
        cross-encoder forward) before serving; returns the seconds spent."""
        t0 = time.time()
        self.query_vector("warmup query", 5, None, None)
        if rerank:
            self.rerank("warmup", [{"id": "w", "text": "warmup text"}])
        dt = time.time() - t0
        logger.info("warmup done in %.1fs", dt)
        return dt

    def shutdown(self) -> None:
        """Stop the microbatcher worker threads so dropping the engine frees
        its device tensors."""
        if self._microbatcher is not None:
            self._microbatcher.stop()
            self._microbatcher = None
