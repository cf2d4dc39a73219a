"""Typed configuration.

Parity with the reference's env-driven constants (reference api/config.py:11-36)
but as an explicit dataclass constructed on demand instead of import-time module
globals — the reference's import-time side effects (mkdir at api/config.py:35,
Chroma client construction at api/app.py:86-91) made it untestable without
monkeypatching module internals (reference tests/test_kb_crud.py:58-73).

Also fixes a reference bug: READONLY_MODE was loaded (api/config.py:17) but
never enforced; here the API layer actually rejects writes when it is set.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from tpu_rag_torch.utils.env import env_bool, env_float, env_int, env_str, load_dotenv


@dataclass
class Config:
    # --- storage paths (parity: reference api/config.py:12-20) ---
    persist_dir: str = "vector_store"
    collection_name: str = "gamefantasy"
    kb_db_path: str = "db/kb.sqlite3"
    db_path: str = "db/app.sqlite3"
    docs_dir: str = "docs"

    # --- auth / modes (reference api/config.py:16-18) ---
    api_key: str = "changeme"          # auth disabled when unset or "changeme"
    readonly_mode: bool = False         # enforced here (dead flag in reference)

    # --- retrieval behavior (reference api/config.py:21-33) ---
    default_language: str = "zh-tw"
    filter_meta_default: bool = True
    meta_tags: tuple[str, ...] = ("meta", "schema", "index", "curation")
    max_context_chars: int = 6000
    half_life_days: float = 45.0
    recency_alpha: float = 0.7

    # --- models ---
    embedding_model: str = "sentence-transformers/all-MiniLM-L6-v2"
    rerank_model: str = "cross-encoder/ms-marco-MiniLM-L-6-v2"
    rerank_mode: str = "replace"        # replace (reference parity) | ensemble
                                        # (z-score blend of retriever + CE —
                                        # measured better, docs/QUALITY.md)
    rerank_ensemble_alpha: float = 0.5  # CE weight in the ensemble blend
                                        # (tuned on a val split by
                                        # scripts/train_reranker.py)
    rerank_candidates: int = 0          # extension: when > response k and a
                                        # /search asks to rerank, retrieve
                                        # this many vector candidates for the
                                        # cross-encoder, then truncate to k
                                        # (recall@k after rerank is ceilinged
                                        # by retrieval recall@depth); 0 = off
                                        # (parity: rerank exactly what /search
                                        # would return)
    # Local weight/tokenizer paths; when absent the framework falls back to
    # deterministic seeded weights + the first-party hashing tokenizer.
    embedding_weights: str = ""         # dir with HF checkpoint or orbax ckpt
    rerank_weights: str = ""
    tokenizer_path: str = ""            # vocab.txt / tokenizer.json

    # --- LLM backends (reference api/config.py:22-28) ---
    openai_api_key: str = ""
    openai_base_url: str = "https://api.openai.com/v1"
    openai_model: str = "gpt-4o-mini"
    ollama_host: str = "http://localhost:11434"
    ollama_model: str = "llama3-8b-8k"
    ollama_use_chat: bool = True
    model_priority: tuple[str, ...] = ("ollama", "openai")

    # --- TPU index engine ---
    index_dtype: str = "auto"           # auto | bfloat16 | float32 | int8
                                        # ("auto" = bf16 below 2M rows, int8
                                        # at/above — the scan is HBM-bound at
                                        # scale, int8 halves the bytes, and
                                        # the f32 refine keeps recall >= 0.99;
                                        # see FlatIndex.dtype)
    index_kind: str = "flat"            # flat | ivf
    index_search_mode: str = "auto"     # auto = exact below 2M rows, bucketed
                                        # above; "packed" (kernel #2, 18-bit
                                        # scores, oversampled and refined) is
                                        # explicit opt-in only (quasi-exact) —
                                        # see FlatIndex.effective_search_mode
    block_n: int = 8192                 # db rows per Pallas tile (cap; VMEM budget may lower it)
    ivf_nlist: int = 0                  # 0 = auto (~sqrt(N))
    ivf_nprobe: int = 8
    embed_batch: int = 64               # encoder batch (padded, fixed shape)
    embed_seq_len: int = 256            # encoder sequence length (fixed shape)
    mesh_shape: str = ""                # e.g. "data:4" or "data:4,model:2"; "" = all devices on data
    device: str = "cuda"                # torch device the encoder and index
                                        # run on; "cuda" raises without a
                                        # card (nothing falls back to "cpu")

    # --- retrieval extensions ---
    fts_docs: bool = False              # also merge keyword hits from the docs
                                        # FTS table the indexer populates.  The
                                        # reference writes that table but never
                                        # searches it (likely unintended); off
                                        # by default for ranking parity.

    # --- compose ---
    summarize_mode: str = "llm"         # "llm" (reference parity) | "off" (skip per-chunk LLM calls)

    # --- serving ---
    host: str = "0.0.0.0"
    port: int = 8000
    debug_prompts: bool = False
    warmup: bool = False                # compile encoder+search at startup
    microbatch: bool = True             # aggregate concurrent /search embeds+scans
    microbatch_max: int = 64            # max queries fused into one device pass
    microbatch_workers: int = 2         # in-flight windows: worker B tokenizes/
                                        # dispatches while A waits on its readback
    microbatch_hold_ms: float = 25.0    # adaptive coalescing CAP: a worker
                                        # that would dispatch a sub-full batch
                                        # WHILE another window is in flight
                                        # accumulates arrivals until the device
                                        # frees (early dispatch) or this cap
                                        # expires; an idle server never holds
    http_executor_workers: int = 128    # handler thread pool.  The asyncio
                                        # default (min(32, cpus+4)) caps
                                        # concurrent in-flight requests — and
                                        # with them the microbatch window fill
                                        # — at ~5 on a 1-vCPU host.  Handler
                                        # threads mostly BLOCK on the device
                                        # RTT, so a large pool is cheap.

    @property
    def auth_enabled(self) -> bool:
        return bool(self.api_key) and self.api_key != "changeme"

    def ensure_dirs(self) -> None:
        for p in (self.db_path, self.kb_db_path):
            Path(p).parent.mkdir(parents=True, exist_ok=True)
        Path(self.docs_dir).mkdir(parents=True, exist_ok=True)
        Path(self.persist_dir).mkdir(parents=True, exist_ok=True)


def _split_csv(raw: str) -> tuple[str, ...]:
    return tuple(s.strip() for s in raw.split(",") if s.strip())


def config_from_env(dotenv: str | None = None) -> Config:
    """Build a Config from environment (and optional .env file).

    Env var names match the reference's (PERSIST_DIR, EMBEDDING_MODEL, ... —
    reference api/config.py:11-33) so a reference .env keeps working.
    """
    load_dotenv(dotenv if dotenv is not None else os.getenv("TPU_RAG_ENV_FILE", ".env"))
    d = Config()  # defaults
    return Config(
        persist_dir=env_str("PERSIST_DIR", d.persist_dir),
        collection_name=env_str("COLLECTION_NAME", d.collection_name),
        kb_db_path=env_str("KB_DB_PATH", d.kb_db_path),
        db_path=env_str("DB_PATH", d.db_path),
        docs_dir=env_str("DOCS_DIR", d.docs_dir),
        api_key=env_str("API_KEY", d.api_key),
        readonly_mode=env_bool("READONLY_MODE", d.readonly_mode),
        default_language=env_str("DEFAULT_LANGUAGE", d.default_language),
        filter_meta_default=env_bool("FILTER_META_DEFAULT", d.filter_meta_default),
        meta_tags=_split_csv(env_str("META_TAGS", ",".join(d.meta_tags))) or d.meta_tags,
        max_context_chars=env_int("MAX_CONTEXT_CHARS", d.max_context_chars),
        half_life_days=env_float("HALF_LIFE_DAYS", d.half_life_days),
        recency_alpha=env_float("RECENCY_ALPHA", d.recency_alpha),
        embedding_model=env_str("EMBEDDING_MODEL", d.embedding_model),
        rerank_model=env_str("RERANK_MODEL", d.rerank_model),
        rerank_mode=env_str("RERANK_MODE", d.rerank_mode),
        rerank_ensemble_alpha=env_float("RERANK_ENSEMBLE_ALPHA",
                                        d.rerank_ensemble_alpha),
        rerank_candidates=max(0, min(env_int("RERANK_CANDIDATES",
                                             d.rerank_candidates), 256)),
        embedding_weights=env_str("EMBEDDING_WEIGHTS", d.embedding_weights),
        rerank_weights=env_str("RERANK_WEIGHTS", d.rerank_weights),
        tokenizer_path=env_str("TOKENIZER_PATH", d.tokenizer_path),
        openai_api_key=env_str("OPENAI_API_KEY", d.openai_api_key),
        openai_base_url=env_str("OPENAI_BASE_URL", d.openai_base_url),
        openai_model=env_str("OPENAI_MODEL", d.openai_model),
        ollama_host=env_str("OLLAMA_HOST", d.ollama_host),
        ollama_model=env_str("OLLAMA_MODEL", d.ollama_model),
        ollama_use_chat=env_bool("OLLAMA_USE_CHAT", d.ollama_use_chat),
        model_priority=_split_csv(env_str("MODEL_PRIORITY", ",".join(d.model_priority))) or d.model_priority,
        index_dtype=env_str("INDEX_DTYPE", d.index_dtype),
        index_kind=env_str("INDEX_KIND", d.index_kind),
        index_search_mode=env_str("INDEX_SEARCH_MODE", d.index_search_mode),
        block_n=env_int("INDEX_BLOCK_N", d.block_n),
        ivf_nlist=env_int("IVF_NLIST", d.ivf_nlist),
        ivf_nprobe=env_int("IVF_NPROBE", d.ivf_nprobe),
        embed_batch=env_int("EMBED_BATCH", d.embed_batch),
        embed_seq_len=env_int("EMBED_SEQ_LEN", d.embed_seq_len),
        mesh_shape=env_str("MESH_SHAPE", d.mesh_shape),
        device=env_str("DEVICE", d.device),
        fts_docs=env_bool("FTS_DOCS", d.fts_docs),
        summarize_mode=env_str("SUMMARIZE_MODE", d.summarize_mode),
        host=env_str("HOST", d.host),
        port=env_int("PORT", d.port),
        debug_prompts=env_bool("DEBUG_PROMPTS", d.debug_prompts),
        warmup=env_bool("WARMUP", d.warmup),
        microbatch=env_bool("MICROBATCH", d.microbatch),
        microbatch_max=env_int("MICROBATCH_MAX", d.microbatch_max),
        microbatch_workers=env_int("MICROBATCH_WORKERS", d.microbatch_workers),
        microbatch_hold_ms=env_float("MICROBATCH_HOLD_MS", d.microbatch_hold_ms),
        http_executor_workers=env_int("HTTP_EXECUTOR_WORKERS",
                                      d.http_executor_workers),
    )
