"""OpenAI chat-completions backend over plain HTTP.

Functional parity with reference api/llm.py:25-68, but implemented with
`requests` against the REST API (the `openai` SDK is not part of this image,
and a ~60-line REST client avoids the dependency).  Streaming parses the SSE
`data:` lines of stream=True chat completions.

`requests` is imported when a backend is built, not with the module (see
llm/ollama.py).
"""

from __future__ import annotations

import json
from typing import Iterator

from tpu_rag_torch.llm.base import LLMBackend

TIMEOUT = 300


class OpenAIBackend(LLMBackend):
    name = "openai"

    def __init__(self, api_key: str, model: str,
                 base_url: str = "https://api.openai.com/v1") -> None:
        if not api_key:
            raise RuntimeError("OPENAI_API_KEY not set")
        import requests

        self._requests = requests
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")

    def _payload(self, messages, stream, temperature, max_tokens) -> dict:
        payload: dict = {"model": self.model, "messages": messages,
                         "stream": stream, "temperature": temperature}
        if isinstance(max_tokens, int) and max_tokens > 0:
            payload["max_tokens"] = max_tokens
        return payload

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.api_key}",
                "Content-Type": "application/json"}

    def complete(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> str:
        r = self._requests.post(f"{self.base_url}/chat/completions",
                                json=self._payload(messages, False, temperature, max_tokens),
                                headers=self._headers(), timeout=TIMEOUT)
        r.raise_for_status()
        data = r.json()
        return (data["choices"][0]["message"].get("content") or "")

    def stream(self, messages, *, temperature=0.7, max_tokens=None, num_predict=None) -> Iterator[str]:
        with self._requests.post(f"{self.base_url}/chat/completions",
                                 json=self._payload(messages, True, temperature, max_tokens),
                                 headers=self._headers(), stream=True,
                                 timeout=TIMEOUT) as r:
            r.raise_for_status()
            for line in r.iter_lines():
                if not line:
                    continue
                text = line.decode("utf-8")
                if not text.startswith("data:"):
                    continue
                body = text[5:].strip()
                if body == "[DONE]":
                    return
                try:
                    data = json.loads(body)
                except ValueError:
                    continue
                delta = ((data.get("choices") or [{}])[0].get("delta") or {}).get("content")
                if delta:
                    yield delta
