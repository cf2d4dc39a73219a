"""Chat routes: threads listing, blocking /compose, SSE /compose_stream
(port of tpu_rag/api/routes/chat.py).

Endpoint/event parity with reference api/routes/chat.py:95-266:
- /compose: hybrid search -> history + summarized context -> LLM -> save
  message + rolling summary; 0 hits -> early note; slim citations
- /compose_stream: SSE "data: {type: text|reasoning, data}" token events via
  ThinkFolder, warm-up empty text event, optional debug prompt preview,
  tail event with FULL hit objects, terminator "event: done"; init and
  stream errors emitted as text events (degrade-don't-fail).
"""

from __future__ import annotations

import json
import logging

from tpu_rag_torch.api.asgi import App, HTTPException, Response
from tpu_rag_torch.api.models import ComposeRequest
from tpu_rag_torch.compose.prompts import preview_messages
from tpu_rag_torch.compose.think import ThinkFolder
from tpu_rag_torch.engine import RagEngine

logger = logging.getLogger(__name__)

SSE_HEADERS = {
    "cache-control": "no-cache",
    "connection": "keep-alive",
    "x-accel-buffering": "no",
}

NO_HITS_NOTE = "無檢索命中；請調整 query 或新增資料。"


def register(app: App, engine: RagEngine) -> None:
    cfg = engine.config

    def _int_param(value: str, name: str) -> int:
        try:
            return int(value)
        except (TypeError, ValueError):
            raise HTTPException(400, f"invalid {name}: {value!r}")

    @app.get("/threads")
    def list_threads(limit: str = "200"):
        return {"threads": engine.db.list_threads(_int_param(limit, "limit"))}

    @app.get("/threads/{thread_id}/messages")
    def thread_messages(thread_id: str, limit: str = "500"):
        return {
            "thread_id": thread_id,
            "messages": engine.db.thread_messages(
                thread_id, _int_param(limit, "limit")),
            "summary": engine.db.get_summary(thread_id),
        }

    @app.post("/compose")
    def compose(body: ComposeRequest):
        lang = engine.norm_lang(body.language)
        hits = engine.search_internal(body.query, body.k, body.namespace,
                                      body.canonicality, body.rerank)
        if body.selected_ids:
            # same client-side source selection the streaming endpoint honors
            idset = set(body.selected_ids)
            hits = [h for h in hits if h.get("id") in idset]
        if not hits:
            return {"draft": "", "citations": [], "note": NO_HITS_NOTE, "language": lang}
        thread_id = body.thread_id or engine.new_thread_id()
        engine.db.save_message(thread_id, "user", body.query, lang)

        combined_ctx, used_hits = engine.build_compose_context(hits, thread_id, lang)
        if body.extra_context:
            combined_ctx += f"\n\n<<<CLIENT_SNIPPETS>>>\n{body.extra_context}\n<<<END_CLIENT_SNIPPETS>>>"
        style = body.style.model_dump() if body.style else None
        messages, temperature = engine.prepare_messages(
            body.query, combined_ctx, body.mode, lang,
            target_length=body.target_length, style=style)
        if body.client_guard:
            messages.insert(1, {"role": "system", "content": body.client_guard})
        try:
            draft, used_engine = engine.generate(
                messages, engine=body.engine, temperature=temperature,
                max_tokens=body.max_tokens, num_predict=body.num_predict)
        except Exception as e:
            raise HTTPException(500, f"LLM generate failed: {e}")

        engine.db.save_message(thread_id, "assistant", draft, lang)
        engine.update_summary(thread_id, body.query, draft, lang)

        cits = []
        for h in hits:
            m = h.get("metadata", {}) or {}
            cits.append({"id": h.get("id"), "file_path": m.get("file_path"),
                         "section": m.get("section")})
        return {"draft": draft, "citations": cits, "used_hits": used_hits,
                "engine": used_engine, "language": lang, "thread_id": thread_id}

    @app.post("/compose_stream")
    def compose_stream(body: ComposeRequest):
        def sse(obj) -> str:
            return "data: " + json.dumps(obj, ensure_ascii=False) + "\n\n"

        try:
            hits = engine.search_internal(body.query, body.k, body.namespace,
                                          body.canonicality, body.rerank)
            if body.selected_ids:
                idset = set(body.selected_ids)
                hits = [h for h in hits if h.get("id") in idset]

            thread_id = body.thread_id or engine.new_thread_id()
            lang = engine.norm_lang(body.language)
            engine.db.save_message(thread_id, "user", body.query, lang)
            debug_prompts = bool(body.debug or cfg.debug_prompts)
            combined_ctx, used_hits = engine.build_compose_context(hits, thread_id, lang)
            if body.extra_context:
                combined_ctx += f"\n\n<<<CLIENT_SNIPPETS>>>\n{body.extra_context}\n<<<END_CLIENT_SNIPPETS>>>"
        except Exception as e:
            # capture the message NOW: CPython deletes the except variable
            # when the block exits, and this generator runs later in the
            # pump thread — closing over `e` raised NameError there and the
            # client got an empty stream instead of the error event
            msg = f"[compose_stream init error] {e}"

            def init_fail():
                yield sse({"type": "text", "data": msg})
            return Response(stream=init_fail(), media_type="text/event-stream",
                            headers=SSE_HEADERS)

        def event_stream():
            folder = ThinkFolder()
            visible: list[str] = []
            final_engine = None
            try:
                style = body.style.model_dump() if body.style else None
                messages, temperature = engine.prepare_messages(
                    body.query, combined_ctx, body.mode, lang,
                    target_length=body.target_length, style=style)
                if body.client_guard:
                    messages.insert(1, {"role": "system", "content": body.client_guard})
                yield sse({"type": "text", "data": ""})  # warm-up event
                stream, final_engine = engine.generate(
                    messages, engine=body.engine, stream=True,
                    temperature=temperature, max_tokens=body.max_tokens,
                    num_predict=body.num_predict)
                if debug_prompts:
                    model = cfg.openai_model if final_engine == "openai" else cfg.ollama_model
                    yield sse({"debug": preview_messages(final_engine, model, messages)})
                for token in stream:
                    for evt in folder.feed(token):
                        if evt.get("type") == "text":
                            visible.append(evt.get("data", ""))
                        yield sse(evt)
            except Exception as e:
                yield sse({"type": "text", "data": f"[compose_stream error] {e}"})
                return

            try:
                for evt in folder.flush():
                    if evt.get("type") == "text":
                        visible.append(evt.get("data", ""))
                    yield sse(evt)
                assistant_text = "".join(visible).strip()
                if assistant_text:
                    engine.db.save_message(thread_id, "assistant", assistant_text, lang)
                    engine.update_summary(thread_id, body.query, assistant_text, lang)
                yield sse({"citations": hits, "used_hits": used_hits,
                           "engine": final_engine, "thread_id": thread_id,
                           "language": lang})
                yield "event: done\n\n"
            except Exception as e:
                yield sse({"type": "text", "data": f"[compose_stream error] {e}"})

        return Response(stream=event_stream(), media_type="text/event-stream",
                        headers=SSE_HEADERS)
