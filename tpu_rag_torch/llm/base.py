"""LLM backend interface.

Unlike the reference (api/llm.py), stream and non-stream generation are
separate methods: the reference's single generator-function `generate` always
returned a generator object even when stream=False (a `yield` anywhere makes
the whole function a generator), which silently broke its non-stream path.
"""

from __future__ import annotations

from typing import Iterator


class LLMBackend:
    name = "base"

    def complete(self, messages: list[dict], *, temperature: float = 0.7,
                 max_tokens: int | None = None, num_predict: int | None = None) -> str:
        raise NotImplementedError

    def stream(self, messages: list[dict], *, temperature: float = 0.7,
               max_tokens: int | None = None, num_predict: int | None = None) -> Iterator[str]:
        raise NotImplementedError
