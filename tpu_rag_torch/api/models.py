"""Request models — field-for-field parity with reference api/models.py:8-58."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel


class SearchRequest(BaseModel):
    query: str = ""
    k: int = 5
    namespace: Optional[str] = None
    canonicality: Optional[str] = None
    rerank: bool = False
    highlight: bool = False
    recency: bool = False  # extension: wire in the recency mix (off = parity)
    # extension: batched retrieval — one encoder/kernel pass for all queries
    # (the TPU-friendly serving mode); response carries `results`, one entry
    # per query, each shaped like a single-query response
    queries: Optional[List[str]] = None


class StyleSpec(BaseModel):
    tone: Optional[str] = None
    directness: Optional[float] = None
    empathy: Optional[float] = None
    hedging: Optional[float] = None
    formality: Optional[float] = None


class ComposeRequest(BaseModel):
    query: str
    mode: str = "strict"  # "strict" | "creative"
    k: int = 6
    namespace: Optional[str] = None
    canonicality: Optional[str] = None
    rerank: bool = True
    engine: Optional[str] = None  # "openai" | "ollama" | "extractive"
    language: Optional[str] = None
    selected_ids: Optional[List[str]] = None
    debug: Optional[bool] = False
    target_length: Optional[str] = None
    max_tokens: Optional[int] = None
    num_predict: Optional[int] = None
    thread_id: Optional[str] = None
    style: Optional[StyleSpec] = None
    # extension: extra system guard supplied by the client (the web UI sends
    # a multilingual prompt-injection defense — the reference injected this
    # via a fetch monkey-patch, reference web/main.js:489-531)
    client_guard: Optional[str] = None
    # extension: client-supplied context appended to the RAG context (the
    # web UI's snippet-injection mode — reference web/main.js:340-352
    # appended selected snippets to the outgoing message client-side)
    extra_context: Optional[str] = None


class ChatRequest(BaseModel):
    """Declared for contract parity (unused by routes in the reference too)."""

    query: str
    thread_id: Optional[str] = None
    k: int = 5
    namespace: Optional[str] = None
    canonicality: Optional[str] = None
    rerank: bool = False
    engine: Optional[str] = None
    language: Optional[str] = None
    style: Optional[StyleSpec] = None


class SaveDocItem(BaseModel):
    title: str
    content: str
    metadata: Dict[str, Any] = {}


class KbUpsertItem(BaseModel):
    source: str
    ref_id: str
    title: str
    content: str
