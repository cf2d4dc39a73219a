"""Extractive offline backend: deterministic grounded answers, no network.

Not in the reference (its LLMs are always external processes — Ollama or
OpenAI).  This backend lets the full /compose + /compose_stream paths run
self-contained (tests, benchmarks, air-gapped deployments): it extracts the
<<<CHUNK id=...>>> blocks and the task line from the prepared messages and
stitches a cited extractive answer.
"""

from __future__ import annotations

import re
from typing import Iterator

from tpu_rag_torch.llm.base import LLMBackend

_CHUNK_RE = re.compile(r"<<<CHUNK id=(.*?)>>>\n(.*?)\n<<<END_CHUNK>>>", re.S)
_CONTEXT_RE = re.compile(r"<<<CONTEXT>>>\n(.*?)\n<<<END>>>", re.S)


class ExtractiveBackend(LLMBackend):
    name = "extractive"

    def __init__(self, max_chars: int = 1200) -> None:
        self.max_chars = max_chars

    def _render(self, messages: list[dict]) -> str:
        user = ""
        for m in messages:
            if m.get("role") == "user":
                user = m.get("content", "")
        chunks = _CHUNK_RE.findall(user)
        if chunks:
            parts = []
            total = 0
            for cid, text in chunks:
                line = f"[{cid}] {text.strip()}"
                if total + len(line) > self.max_chars:
                    break
                parts.append(line)
                total += len(line)
            return "\n\n".join(parts)
        ctx = _CONTEXT_RE.search(user)
        if ctx:
            # summarization-style request: return a truncated extract
            return ctx.group(1).strip()[: self.max_chars]
        return user.strip()[: self.max_chars]

    def complete(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> str:
        out = self._render(messages)
        limit = max_tokens or num_predict
        if isinstance(limit, int) and limit > 0:
            out = out[: limit * 4]  # ~4 chars per token heuristic
        return out

    def stream(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> Iterator[str]:
        text = self.complete(messages, temperature=temperature,
                             max_tokens=max_tokens, num_predict=num_predict)
        step = 24
        for i in range(0, len(text), step):
            yield text[i : i + step]
