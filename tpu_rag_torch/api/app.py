"""Application factory (port of tpu_rag/api/app.py): the system, chat
(threads, /compose, /compose_stream) and kb routes.

The reference builds one FastAPI app with import-time side effects and
routers importing back from api.app (SURVEY.md §1 flags the circular-import
quirk).  Here create_app(config) wires an explicit RagEngine into route
modules — no import cycles, no module-global state, trivially testable.
"""

from __future__ import annotations

from pathlib import Path

from tpu_rag_torch.api.asgi import App, HTTPException, Request
from tpu_rag_torch.api.routes import chat, kb, system
from tpu_rag_torch.config import Config
from tpu_rag_torch.engine import RagEngine


def make_auth(config: Config):
    """x-api-key auth, enforced only when a real key is set — parity with
    reference api/app.py:116-121 (auth disabled when key is "changeme")."""

    def auth(request: Request) -> None:
        if not config.auth_enabled:
            return
        if request.headers.get("x-api-key") != config.api_key:
            raise HTTPException(401, "invalid or missing API key")

    return auth


def create_app(config: Config | None = None, engine: RagEngine | None = None,
               web_dir: str | Path | None = None) -> App:
    engine = engine or RagEngine(config)
    app = App(auth=make_auth(engine.config))
    app.state = {"engine": engine}

    system.register(app, engine)
    chat.register(app, engine)
    kb.register(app, engine)

    web = Path(web_dir) if web_dir else Path(__file__).resolve().parents[2] / "web"
    if web.is_dir():
        app.mount_static("/app", web)
    return app
