"""Backend priority dispatcher.

Parity with reference api/llm.py:148-186: try [engine] or MODEL_PRIORITY in
order, skip backends that fail to init or to answer, return (result,
backend_name), raise RuntimeError("All backends failed") when exhausted.
"""

from __future__ import annotations

import logging
from typing import Iterator

from tpu_rag_torch.config import Config
from tpu_rag_torch.llm.base import LLMBackend
from tpu_rag_torch.llm.extractive import ExtractiveBackend
from tpu_rag_torch.llm.ollama import OllamaBackend
from tpu_rag_torch.llm.openai_backend import OpenAIBackend

logger = logging.getLogger(__name__)


class LLMDispatcher:
    def __init__(self, config: Config) -> None:
        self.config = config
        self._cache: dict[str, LLMBackend] = {}

    def _make(self, name: str) -> LLMBackend | None:
        if name in self._cache:
            return self._cache[name]
        cfg = self.config
        backend: LLMBackend | None = None
        try:
            if name == "ollama":
                backend = OllamaBackend(cfg.ollama_host, cfg.ollama_model, cfg.ollama_use_chat)
            elif name == "openai":
                backend = OpenAIBackend(cfg.openai_api_key, cfg.openai_model, cfg.openai_base_url)
            elif name == "extractive":
                backend = ExtractiveBackend()
        except Exception as e:
            logger.warning("Backend %s unavailable: %s", name, e)
            return None
        if backend is not None:
            self._cache[name] = backend
        return backend

    def generate(self, messages: list[dict], *, stream: bool = False,
                 engine: str | None = None, **kw) -> tuple[str | Iterator[str], str]:
        priorities = [engine] if engine else list(self.config.model_priority)
        last_err: Exception | None = None
        for name in priorities:
            backend = self._make(name)
            if backend is None:
                continue
            try:
                if stream:
                    # backend.stream() is a generator FUNCTION: nothing runs
                    # until iteration, so connection failures would escape
                    # this try and break the fallback contract for streams.
                    # Prime the first chunk here to force stream-start
                    # errors into the fallback path.
                    import itertools

                    gen = backend.stream(messages, **kw)
                    try:
                        first = next(gen)
                    except StopIteration:
                        return iter(()), name  # empty but successful stream
                    return itertools.chain([first], gen), name
                return backend.complete(messages, **kw), name
            except Exception as e:
                last_err = e
                logger.warning("Backend %s failed: %s", name, e)
                continue
        raise RuntimeError("All backends failed") from last_err
