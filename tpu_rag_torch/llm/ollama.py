"""Ollama HTTP backend.

Behavior parity with reference api/llm.py:71-145: /api/chat with messages,
auto-fallback to /api/generate (joined prompt) on HTTP 404, NDJSON line
streaming, options={temperature, num_predict}, 300 s timeout.

`requests` is imported when a backend is built, not with the module: where
it is missing, the dispatcher finds this backend failing to init and skips
it, and the rest of the package still imports.
"""

from __future__ import annotations

import json
import logging
from typing import Iterator

from tpu_rag_torch.llm.base import LLMBackend

logger = logging.getLogger(__name__)

TIMEOUT = 300


class OllamaBackend(LLMBackend):
    name = "ollama"

    def __init__(self, host: str, model: str, use_chat: bool = True) -> None:
        if not model:
            raise RuntimeError("OLLAMA_MODEL not set")
        import requests

        self._requests = requests
        self.host = host.rstrip("/")
        self.model = model
        self.use_chat = use_chat

    def _options(self, temperature: float, num_predict: int | None) -> dict:
        options: dict = {"temperature": temperature}
        if isinstance(num_predict, int) and num_predict > 0:
            options["num_predict"] = num_predict
        return options

    def _payload(self, messages, stream, options) -> tuple[str, dict]:
        """Build (url, body) for the endpoint currently in use.

        Chat mode sends the message list to /api/chat; legacy mode joins the
        message contents into a single prompt for /api/generate.
        """
        if self.use_chat:
            return (f"{self.host}/api/chat",
                    {"model": self.model, "messages": messages,
                     "stream": stream, "options": options})
        prompt = "\n".join(m.get("content", "") for m in messages)
        return (f"{self.host}/api/generate",
                {"model": self.model, "prompt": prompt,
                 "stream": stream, "options": options})

    def _downgrade_on_404(self, err) -> None:
        """Old Ollama servers predate the chat endpoint and answer 404.

        Flip this backend into legacy prompt mode permanently and let the
        caller retry; any other HTTP error propagates.
        """
        if getattr(err.response, "status_code", None) != 404:
            raise err
        logger.info("ollama: chat endpoint unavailable (404); retrying via legacy generate API")
        self.use_chat = False

    @staticmethod
    def _extract(data: dict) -> str:
        """Pull the text out of either response shape (chat vs generate)."""
        return (data.get("message") or {}).get("content") or data.get("response") or ""

    def complete(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> str:
        options = self._options(temperature, num_predict or max_tokens)
        for _ in range(2):  # at most one retry, after a chat->generate downgrade
            url, body = self._payload(messages, False, options)
            try:
                r = self._requests.post(url, json=body, timeout=TIMEOUT)
                r.raise_for_status()
                return self._extract(r.json())
            except self._requests.HTTPError as e:
                self._downgrade_on_404(e)
        raise RuntimeError("ollama: generate endpoint also failed")  # unreachable in practice

    def stream(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> Iterator[str]:
        options = self._options(temperature, num_predict or max_tokens)
        for _ in range(2):
            url, body = self._payload(messages, True, options)
            try:
                with self._requests.post(url, json=body, stream=True, timeout=TIMEOUT) as r:
                    r.raise_for_status()
                    # Ollama streams one JSON object per line (NDJSON).
                    for line in r.iter_lines():
                        if not line:
                            continue
                        obj = json.loads(line.decode("utf-8"))
                        if isinstance(obj, dict) and obj.get("error"):
                            # mid-stream NDJSON errors arrive on a 200
                            # response; swallowing them ended the stream as
                            # if it had completed
                            raise RuntimeError(f"ollama: {obj['error']}")
                        piece = self._extract(obj)
                        if piece:
                            yield piece
                    return
            except self._requests.HTTPError as e:
                self._downgrade_on_404(e)
        raise RuntimeError("ollama: generate endpoint also failed")
