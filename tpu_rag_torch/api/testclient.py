"""In-process test client for tpu_rag ASGI apps.

Fills the role fastapi.testclient.TestClient plays in the reference's tests
(reference tests/test_kb_crud.py:90-91): synchronous request/response against
the app without sockets.  Background tasks run after the response, matching
server behavior.  Streaming responses expose .iter_stream().
"""

from __future__ import annotations

import json as _json
from typing import Any, Iterable
from urllib.parse import parse_qsl, unquote, urlsplit

from tpu_rag_torch.api.asgi import App, Request, Response


class ClientResponse:
    def __init__(self, response: Response, background=None) -> None:
        self._response = response
        self.status_code = response.status_code
        self.headers = response.headers
        self._background = list(background or [])

    @property
    def text(self) -> str:
        return self._response.body.decode("utf-8")

    def json(self) -> Any:
        return _json.loads(self.text)

    def iter_stream(self) -> Iterable[str]:
        if self._response.stream is None:
            yield self.text
        else:
            for chunk in self._response.stream:
                yield chunk if isinstance(chunk, str) else chunk.decode("utf-8")
        # background tasks run after the stream drains — matching the real
        # server (asgi.__call__ runs them after _send_stream completes)
        background, self._background = self._background, []
        for fn, args in background:
            fn(*args)


class TestClient:
    __test__ = False  # not a pytest collectable

    def __init__(self, app: App, headers: dict[str, str] | None = None) -> None:
        self.app = app
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}

    def request(self, method: str, url: str, *, json: Any = None,
                headers: dict[str, str] | None = None) -> ClientResponse:
        split = urlsplit(url)
        query = dict(parse_qsl(split.query))
        body = b""
        hdrs = dict(self.headers)
        if headers:
            hdrs.update({k.lower(): v for k, v in headers.items()})
        if json is not None:
            body = _json.dumps(json, ensure_ascii=False).encode("utf-8")
            hdrs.setdefault("content-type", "application/json")
        # decode like server.py does (ASGI scope paths are percent-decoded)
        request = Request(method.upper(), unquote(split.path), query, hdrs, body)
        response = self.app.handle(request)
        is_stream = response.stream is not None
        result = ClientResponse(response,
                                background=request.background if is_stream else None)
        if not is_stream:
            for fn, args in request.background:
                fn(*args)
        return result

    def get(self, url: str, **kw) -> ClientResponse:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> ClientResponse:
        return self.request("POST", url, **kw)

    def put(self, url: str, **kw) -> ClientResponse:
        return self.request("PUT", url, **kw)

    def delete(self, url: str, **kw) -> ClientResponse:
        return self.request("DELETE", url, **kw)
