"""System routes: / redirect, /health, /config.

Response-shape parity with reference api/routes/system.py:23-87; /health adds
index kind/dtype and device info (the torch device, and the card's name and
count on CUDA).
"""

from __future__ import annotations

from tpu_rag_torch.api.asgi import App, RedirectResponse
from tpu_rag_torch.engine import RagEngine


def register(app: App, engine: RagEngine) -> None:
    cfg = engine.config

    @app.get("/", public=True)
    def root():
        return RedirectResponse("/app/")

    @app.get("/health")
    def health():
        index_ok, cnt = True, None
        try:
            cnt = engine.index.count()
        except Exception:
            index_ok = False
        ollama_alive = False
        ollama_models: list[str] = []
        try:
            import requests

            rr = requests.get(f"{cfg.ollama_host}/api/tags", timeout=3)
            if rr.ok:
                ollama_alive = True
                jd = rr.json()
                ollama_models = [t.get("name") for t in jd.get("models", [])]
        except Exception:
            pass
        import torch

        device_info = {"backend": engine.device.type,
                       "device_count": (torch.cuda.device_count()
                                        if engine.device.type == "cuda" else 1)}
        if engine.device.type == "cuda":
            device_info["name"] = torch.cuda.get_device_name(engine.device)
        return {
            "status": "ok",
            "db_path": cfg.db_path,
            "persist_dir": cfg.persist_dir,
            "embedding_model": cfg.embedding_model,
            "collection": cfg.collection_name,
            "docs_count": cnt,
            "chroma_ok": index_ok,  # field name kept for client parity
            "index": {"kind": getattr(engine.index, "kind", "flat"),
                      "dtype": getattr(engine.index, "dtype", ""),
                      "dtype_config": getattr(engine.index, "dtype_config", ""),
                      "search_mode": getattr(engine.index, "search_mode", ""),
                      # host-storage observability: where the master vectors
                      # and per-row docs/metadata live (ram vs disk spill)
                      "master_backing": getattr(
                          getattr(engine.index, "_arena", None), "backing", ""),
                      "docmeta_backing": getattr(
                          getattr(engine.index, "_rowmeta", None), "backing", ""),
                      "snapshot_stats": dict(getattr(
                          engine.index, "snapshot_stats", {})),
                      "ok": index_ok},
            "device": device_info,
            "language_default": cfg.default_language,
            "backends": {
                "priority": list(cfg.model_priority),
                "openai": {"enabled": bool(cfg.openai_api_key), "model": cfg.openai_model},
                "ollama": {
                    "enabled": bool(cfg.ollama_model),
                    "model": cfg.ollama_model,
                    "host": cfg.ollama_host,
                    "use_chat": cfg.ollama_use_chat,
                    "alive": ollama_alive,
                    "tags": ollama_models,
                },
            },
        }

    @app.get("/metrics")
    def metrics():
        from tpu_rag_torch.api.asgi import Response

        return Response(app.metrics.render(), media_type="text/plain; version=0.0.4")

    @app.get("/config")
    def config():
        return {
            "db_path": cfg.db_path,
            "persist_dir": cfg.persist_dir,
            "embedding_model": cfg.embedding_model,
            "collection": cfg.collection_name,
            "language_default": cfg.default_language,
            "model_priority": list(cfg.model_priority),
            "openai_model": cfg.openai_model,
            "openai_enabled": bool(cfg.openai_api_key),
            "ollama_model": cfg.ollama_model,
            "ollama_host": cfg.ollama_host,
            "ollama_use_chat": cfg.ollama_use_chat,
            "readonly_mode": cfg.readonly_mode,
            "index_kind": cfg.index_kind,
            "index_dtype": cfg.index_dtype,
        }
