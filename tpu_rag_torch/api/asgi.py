"""First-party ASGI micro-framework.

Replaces FastAPI/Starlette in the reference stack (reference
api/app.py:106-121) — neither is part of this image, and the framework's
runtime is first-party by design.  Provides: path-pattern routing, JSON
bodies, pydantic request validation, HTTPException -> JSON error responses,
CORS, API-key auth hook, static file mounts, streaming (SSE) responses with
sync generators executed off the event loop, and post-response background
tasks (the reference's BackgroundTasks pattern, api/routes/kb.py:102-149).

Implements the ASGI 3 interface, so it is testable in-process via
httpx.ASGITransport and servable by tpu_rag.api.server.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
import mimetypes
import queue as thread_queue
import threading
import traceback
from pathlib import Path
from typing import Any, Callable, Iterable
from urllib.parse import parse_qsl

logger = logging.getLogger(__name__)


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = "") -> None:
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class Request:
    def __init__(self, method: str, path: str, query: dict[str, str],
                 headers: dict[str, str], body: bytes) -> None:
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params: dict[str, str] = {}
        self.background: list[tuple[Callable, tuple]] = []

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body.decode("utf-8"))
        except ValueError:
            raise HTTPException(400, "invalid JSON body")

    def add_background(self, fn: Callable, *args) -> None:
        """Run fn(*args) after the response is sent (reference
        BackgroundTasks semantics)."""
        self.background.append((fn, args))


class Response:
    def __init__(self, content: Any = None, status_code: int = 200,
                 headers: dict[str, str] | None = None,
                 media_type: str | None = None,
                 stream: Iterable[str | bytes] | None = None) -> None:
        self.status_code = status_code
        self.headers = dict(headers or {})
        self.stream = stream
        if stream is not None:
            self.body = b""
            self.media_type = media_type or "text/event-stream"
        elif isinstance(content, (bytes, bytearray)):
            self.body = bytes(content)
            self.media_type = media_type or "application/octet-stream"
        elif isinstance(content, str):
            self.body = content.encode("utf-8")
            self.media_type = media_type or "text/plain; charset=utf-8"
        else:
            self.body = json.dumps(content, ensure_ascii=False).encode("utf-8")
            self.media_type = media_type or "application/json"


class RedirectResponse(Response):
    def __init__(self, url: str, status_code: int = 307) -> None:
        super().__init__(b"", status_code=status_code, headers={"location": url})


_CORS_HEADERS = {
    "access-control-allow-origin": "*",
    # no allow-credentials: browsers REJECT credentialed responses that
    # combine it with a wildcard origin, and the x-api-key auth flow sends
    # no cookies — the pair was either dead or broken for every caller
    "access-control-allow-methods": "GET, POST, PUT, DELETE, OPTIONS",
    "access-control-allow-headers": "*",
}


class _Route:
    def __init__(self, method: str, path: str, handler: Callable, public: bool) -> None:
        self.method = method
        self.segments = [s for s in path.split("/") if s != ""]
        self.handler = handler
        self.public = public
        self.body_model = None
        # pydantic model annotation on a parameter named `body`; resolve via
        # get_type_hints so `from __future__ import annotations` (string
        # annotations) in route modules still works
        sig = inspect.signature(handler)
        try:
            import typing
            hints = typing.get_type_hints(handler)
        except Exception:
            hints = {}
        ann = hints.get("body")
        if ann is not None and hasattr(ann, "model_validate"):
            self.body_model = ann
        self._params = set(sig.parameters)
        self.metric_name = "http_" + method.lower() + "_" + (
            "_".join(s.strip("{}") for s in self.segments) or "root")

    def match(self, method: str, path: str) -> dict[str, str] | None:
        if method != self.method:
            return None
        parts = [s for s in path.split("/") if s != ""]
        if len(parts) != len(self.segments):
            return None
        params: dict[str, str] = {}
        for seg, part in zip(self.segments, parts):
            if seg.startswith("{") and seg.endswith("}"):
                # scope paths arrive ALREADY percent-decoded (server.py and
                # testclient both unquote) — decoding again here corrupted
                # any param value containing literal %XX sequences
                params[seg[1:-1]] = part
            elif seg != part:
                return None
        return params


class App:
    """Minimal ASGI application with routing + static mounts."""

    def __init__(self, auth: Callable[[Request], None] | None = None) -> None:
        self.routes: list[_Route] = []
        # O(1) dispatch for parameterless paths — the linear match() scan is
        # measurable per-request CPU at production request rates
        self._exact: dict[tuple[str, str], _Route] = {}
        self.static_mounts: list[tuple[str, Path]] = []
        self.auth = auth
        from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
        self.metrics = GLOBAL_METRICS

    # ----------------------------------------------------------- registry

    def route(self, path: str, *, methods: list[str] = ("GET",), public: bool = False):
        def deco(fn):
            for m in methods:
                r = _Route(m.upper(), path, fn, public)
                self.routes.append(r)
                if "{" not in path:
                    norm = "/" + "/".join(r.segments)
                    self._exact[(r.method, norm)] = r
            return fn
        return deco

    def get(self, path: str, **kw):
        return self.route(path, methods=["GET"], **kw)

    def post(self, path: str, **kw):
        return self.route(path, methods=["POST"], **kw)

    def put(self, path: str, **kw):
        return self.route(path, methods=["PUT"], **kw)

    def delete(self, path: str, **kw):
        return self.route(path, methods=["DELETE"], **kw)

    def mount_static(self, prefix: str, directory: str | Path) -> None:
        self.static_mounts.append((prefix.rstrip("/"), Path(directory)))

    # ----------------------------------------------------------- dispatch

    def _static_response(self, path: str) -> Response | None:
        for prefix, directory in self.static_mounts:
            if path == prefix:
                return RedirectResponse(prefix + "/")
            if not path.startswith(prefix + "/"):
                continue
            rel = path[len(prefix) + 1:] or "index.html"
            target = (directory / rel).resolve()
            try:
                target.relative_to(directory.resolve())
            except ValueError:
                return Response({"detail": "not found"}, 404)
            if target.is_dir():
                target = target / "index.html"
            if not target.is_file():
                return Response({"detail": "not found"}, 404)
            ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
            return Response(target.read_bytes(), media_type=ctype)
        return None

    def _run_handler(self, route: _Route, request: Request) -> Response:
        if not route.public and self.auth is not None:
            self.auth(request)
        kwargs: dict[str, Any] = {}
        if "request" in route._params:
            kwargs["request"] = request
        for k, v in request.path_params.items():
            if k in route._params:
                kwargs[k] = v
        if route.body_model is not None:
            raw = request.json()
            try:
                kwargs["body"] = route.body_model.model_validate(raw or {})
            except Exception as e:
                raise HTTPException(422, f"validation error: {e}")
        elif "body" in route._params:
            kwargs["body"] = request.json()
        for name in route._params:
            if name in ("request", "body") or name in kwargs:
                continue
            if name in request.query:
                kwargs[name] = request.query[name]
        result = route.handler(**kwargs)
        if isinstance(result, Response):
            return result
        return Response(result)

    def _dispatch(self, route: _Route, request: Request) -> Response:
        name = route.metric_name
        self.metrics.inc(name + "_total")
        with self.metrics.timed(name):
            response = self._run_handler(route, request)
        if response.status_code >= 500:
            self.metrics.inc("http_errors_5xx_total")
        elif response.status_code >= 400:
            self.metrics.inc("http_errors_4xx_total")
        return response

    def handle(self, request: Request) -> Response:
        """Synchronous dispatch (used by the ASGI glue and directly by tests)."""
        try:
            if request.method == "OPTIONS":
                return Response(b"", 200)
            # exact-path fast lane (every hot API route is parameterless)
            norm = "/" + "/".join(
                s for s in request.path.split("/") if s != "")
            route = self._exact.get((request.method, norm))
            if route is not None:
                request.path_params = {}
                return self._dispatch(route, request)
            static = self._static_response(request.path)
            if static is not None:
                return static
            for route in self.routes:
                params = route.match(request.method, request.path)
                if params is None:
                    continue
                request.path_params = params
                return self._dispatch(route, request)
            return Response({"detail": "not found"}, 404)
        except HTTPException as e:
            self.metrics.inc("http_errors_4xx_total" if e.status_code < 500
                             else "http_errors_5xx_total")
            return Response({"detail": e.detail}, e.status_code)
        except Exception as e:
            logger.error("handler error: %s\n%s", e, traceback.format_exc())
            self.metrics.inc("http_errors_5xx_total")
            return Response({"detail": f"internal error: {e}"}, 500)

    # ----------------------------------------------------------- ASGI

    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            return
        body = b""
        while True:
            message = await receive()
            if message["type"] == "http.request":
                body += message.get("body", b"")
                if not message.get("more_body"):
                    break
            elif message["type"] == "http.disconnect":
                return
        headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                   for k, v in scope.get("headers", [])}
        query = dict(parse_qsl(scope.get("query_string", b"").decode("latin-1")))
        request = Request(scope["method"], scope["path"], query, headers, body)

        loop = asyncio.get_running_loop()
        response = await loop.run_in_executor(None, self.handle, request)

        out_headers = {**_CORS_HEADERS, **response.headers,
                       "content-type": response.media_type}
        await send({
            "type": "http.response.start",
            "status": response.status_code,
            "headers": [(k.encode("latin-1"), str(v).encode("latin-1"))
                        for k, v in out_headers.items()],
        })
        if response.stream is not None:
            await self._send_stream(response.stream, receive, send, loop)
        else:
            await send({"type": "http.response.body", "body": response.body})

        for fn, args in request.background:
            try:
                await loop.run_in_executor(None, fn, *args)
            except Exception as e:
                logger.warning("background task failed: %s", e)

    async def _send_stream(self, stream: Iterable[str | bytes], receive, send, loop) -> None:
        """Bridge a sync generator onto the event loop, surviving client aborts.

        The generator runs in a pump thread and hands chunks over a bounded
        thread-safe queue.  Cancellation (client disconnect, or `send`
        raising on a closed socket) sets `cancel`, which the pump observes on
        its next put/iteration; the pump then close()s the upstream generator
        so LLM streams are torn down rather than leaked.  The pump never
        blocks indefinitely: every queue put is a short-timeout retry loop
        gated on `cancel`.
        """
        q: thread_queue.Queue = thread_queue.Queue(maxsize=64)
        cancel = threading.Event()
        _SENTINEL = None

        def put_until_cancelled(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except thread_queue.Full:
                    continue
            return False

        def pump():
            try:
                for chunk in stream:
                    if cancel.is_set():
                        break
                    data = chunk.encode("utf-8") if isinstance(chunk, str) else chunk
                    if not put_until_cancelled(data):
                        break
            finally:
                close = getattr(stream, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
                # Wake a consumer blocked on an empty queue.  If the queue is
                # full the consumer is either still draining (and will reach
                # this sentinel slot soon) or already cancelled — a blocking
                # put is never needed.
                put_until_cancelled(_SENTINEL)

        async def watch_disconnect():
            # ASGI servers signal client aborts via http.disconnect on the
            # receive channel; send() may or may not raise, so watch both.
            try:
                while True:
                    message = await receive()
                    if message["type"] == "http.disconnect":
                        return
            except Exception:
                return

        pump_thread = threading.Thread(target=pump, daemon=True)
        pump_thread.start()
        watcher = asyncio.ensure_future(watch_disconnect())
        try:
            while True:
                get = loop.run_in_executor(None, q.get)
                done, _ = await asyncio.wait({get, watcher},
                                             return_when=asyncio.FIRST_COMPLETED)
                if watcher in done and get not in done:
                    # client went away; unblock the stray q.get with data that
                    # is already en route, or the pump's sentinel
                    break
                chunk = get.result()
                if chunk is _SENTINEL:
                    break
                await send({"type": "http.response.body", "body": chunk, "more_body": True})
            if not cancel.is_set() and not watcher.done():
                await send({"type": "http.response.body", "body": b"", "more_body": False})
        except Exception:
            pass  # closed socket mid-stream — cancellation below tears down the pump
        finally:
            cancel.set()
            watcher.cancel()
            # land the cancellation NOW: the watcher awaits reader.read, and
            # leaving it un-awaited would let it race the next keep-alive
            # request's header read for the same connection's bytes
            try:
                await watcher
            except (asyncio.CancelledError, Exception):
                pass
            try:
                q.put_nowait(_SENTINEL)  # wake an abandoned q.get executor thread
            except thread_queue.Full:
                pass  # queue has data, so no getter can be blocked
