"""Context normalization: per-chunk LLM re-summarization into the target
language, with an in-process cache, plus context packing under a char budget.

Parity with reference api/app.py:467-507 (md5-keyed _LANG_SUM_CACHE,
temperature 0.2, ~600-char chunks, <<<CHUNK id=...>>> blocks, budget break),
with two deliberate fixes flagged in SURVEY.md §5/§7:
- the cache has a lock + LRU bound (the reference's dict was shared across
  requests unguarded and grew forever),
- chunk summarization can be batched/disabled (`mode`): "llm" preserves
  reference behavior, "off" skips the per-chunk LLM round-trips (the
  dominant latency in /compose) and uses budget-truncated raw text.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable

from tpu_rag_torch.compose.language import norm_lang


class Summarizer:
    def __init__(self, generate_fn: Callable, *, default_language: str = "zh-tw",
                 mode: str = "llm", cache_size: int = 4096) -> None:
        self.generate_fn = generate_fn
        self.default_language = default_language
        self.mode = mode
        self._cache: OrderedDict[str, str] = OrderedDict()
        self._cache_size = cache_size
        self._lock = threading.Lock()

    @staticmethod
    def _cache_key(text: str, lang: str, max_chars: int) -> str:
        return hashlib.md5(f"{text}|{lang}|{max_chars}".encode("utf-8")).hexdigest()

    def _guard(self, lang: str, max_chars: int) -> str:
        guards = {
            "zh-tw": f"只用繁體中文轉述重點，不新增資訊，不逐字抄原文。約 {max_chars} 字。",
            "zh-cn": f"只用简体中文转述要点，不新增信息，不逐字抄原文。约 {max_chars} 字。",
            "ja": f"日本語のみで要点を要約。新情報を追加せず、逐語的な複写をしない。約{max_chars}文字以内。",
            "ko": f"한국어로 핵심을 요약. 새로운 정보 추가 금지, 원문 베껴쓰기 금지. 약 {max_chars}자.",
        }
        # NAME the target language for everything else: "the requested
        # language" gave the model nothing to go on and summaries came back
        # in the source text's language
        return guards.get(lang, f"Summarize in the language with tag "
                                f"'{lang}' only. ~{max_chars} chars.")

    def summarize_to_lang(self, text: str, lang: str, max_chars: int = 600) -> str | None:
        try:
            l = norm_lang(lang, self.default_language)
            prompt = f"{self._guard(l, max_chars)}\n<<<CONTEXT>>>\n{text}\n<<<END>>>"
            resp, _ = self.generate_fn([{"role": "user", "content": prompt}], temperature=0.2)
            return (resp or "").strip()
        except Exception:
            return None

    def summarize_chunk(self, text: str, lang: str | None, max_chars_per_chunk: int = 600) -> str:
        l = norm_lang(lang, self.default_language)
        if self.mode == "off":
            return text[:max_chars_per_chunk]
        key = self._cache_key(text, l, max_chars_per_chunk)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        out = self.summarize_to_lang(text, l, max_chars=max_chars_per_chunk)
        if not (out and isinstance(out, str)):
            # LLM failed (transient outage): serve the raw text but do NOT
            # cache it — caching the fallback poisoned the entry until
            # eviction, long after the backend recovered
            return text
        with self._lock:
            self._cache[key] = out
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return out

    def build_context(self, hits: list[dict], language: str | None,
                      max_chars: int = 4000, max_chars_per_chunk: int = 600,
                      parallel: int = 4) -> tuple[str, int]:
        """Pack summarized <<<CHUNK id=...>>> blocks under the budget; returns
        (context, number of hits used) — reference api/app.py:497-507.

        Unlike the reference (which issued one blocking LLM call per chunk in
        sequence — the dominant /compose latency, SURVEY.md §3.1), cache-miss
        summarizations run concurrently (LLM calls are IO-bound).  Packing
        order and the char-budget cutoff are unchanged."""
        texts = [(h.get("text") or h.get("summary") or h.get("content") or "")
                 for h in hits]
        todo = [t for t in texts if t]
        if self.mode != "off" and len(todo) > 1 and parallel > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(parallel, len(todo))) as pool:
                summaries = list(pool.map(
                    lambda t: self.summarize_chunk(t, language, max_chars_per_chunk), todo))
            summarized_by_text = dict(zip(todo, summaries))
        else:
            summarized_by_text = {}

        pieces: list[str] = []
        total = 0
        used = 0
        for h, raw in zip(hits, texts):
            if not raw:
                continue
            summarized = summarized_by_text.get(raw) or self.summarize_chunk(
                raw, language, max_chars_per_chunk)
            block = f"<<<CHUNK id={h.get('id', '?')}>>>\n{summarized}\n<<<END_CHUNK>>>"
            if total + len(block) > max_chars:
                break
            pieces.append(block)
            total += len(block)
            used += 1
        return "\n\n".join(pieces), used
