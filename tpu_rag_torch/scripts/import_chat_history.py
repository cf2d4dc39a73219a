"""Import ChatGPT conversation exports into the doc schema (port of
scripts/import_chat_history.py).

Parity with reference scripts/import_chat_history.py:36-241: accepts the
official export (conversations.json, including the `mapping` graph form) or
a JSONL of {role, content} records; emits one doc per user/assistant
exchange with body={prompt, draft, thread_id}, namespace "history",
canonicality "non"; interactive y/N/all/quit preview; optionally indexes the
results via the build_index flow (on DEVICE, cuda unless set to cpu).

  python -m tpu_rag_torch.scripts.import_chat_history conversations.json --yes
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time


def _msg_text(message: dict) -> str:
    content = (message or {}).get("content") or {}
    if isinstance(content, str):
        return content
    parts = content.get("parts") or []
    return "\n".join(p for p in parts if isinstance(p, str)).strip()


def _walk_mapping(mapping: dict) -> list[tuple[str, str]]:
    """Linearize the export's message graph: follow children from the root."""
    roots = [k for k, v in mapping.items() if not v.get("parent")]
    out: list[tuple[str, str]] = []
    stack = list(roots)
    seen = set()
    while stack:
        nid = stack.pop(0)
        if nid in seen or nid not in mapping:
            continue
        seen.add(nid)
        node = mapping[nid]
        msg = node.get("message")
        if msg:
            role = ((msg.get("author") or {}).get("role") or "").lower()
            text = _msg_text(msg)
            if role in ("user", "assistant") and text:
                out.append((role, text))
        stack = list(node.get("children") or []) + stack
    return out


def conversation_to_pairs(conv: dict) -> list[tuple[str, str]]:
    if "mapping" in conv:
        messages = _walk_mapping(conv["mapping"])
    else:
        messages = [((m.get("role") or "").lower(), m.get("content") or "")
                    for m in conv.get("messages", [])]
    pairs: list[tuple[str, str]] = []
    pending_user: str | None = None
    for role, text in messages:
        if role == "user":
            pending_user = text
        elif role == "assistant" and pending_user:
            pairs.append((pending_user, text))
            pending_user = None
    return pairs


def load_conversations(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if path.endswith(".jsonl"):
        records = [json.loads(line) for line in text.splitlines() if line.strip()]
        return [{"title": "jsonl-import", "messages": records}]
    data = json.loads(text)
    if isinstance(data, dict):
        data = [data]
    return data


def pairs_to_docs(conv: dict, pairs: list[tuple[str, str]]) -> list[dict]:
    title = conv.get("title") or "conversation"
    thread_id = conv.get("id") or conv.get("conversation_id") or re.sub(r"\W+", "-", title)[:40]
    docs = []
    for i, (prompt, draft) in enumerate(pairs):
        docs.append({
            "id": f"hist-{thread_id}-{i}",
            "namespace": "history",
            "canonicality": "non",
            "title": f"{title} #{i + 1}",
            "summary": prompt[:200],
            "body": {"prompt": prompt, "draft": draft, "thread_id": thread_id},
        })
    return docs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Import ChatGPT exports as history docs")
    ap.add_argument("export", help="conversations.json or .jsonl")
    ap.add_argument("--out-dir", default=None, help="default: DOCS_DIR/history")
    ap.add_argument("--yes", action="store_true", help="non-interactive: accept all")
    ap.add_argument("--index", action="store_true", help="index accepted docs afterwards")
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env

    cfg = config_from_env()
    out_dir = args.out_dir or os.path.join(cfg.docs_dir, "history")
    os.makedirs(out_dir, exist_ok=True)

    accept_all = args.yes
    written = 0
    for conv in load_conversations(args.export):
        pairs = conversation_to_pairs(conv)
        for doc in pairs_to_docs(conv, pairs):
            if not accept_all:
                preview = doc["body"]["prompt"][:120].replace("\n", " ")
                ans = input(f"import '{doc['title']}' ({preview}…)? [y/N/all/quit] ").strip().lower()
                if ans == "quit":
                    print(f"stopped; wrote {written}")
                    return
                if ans == "all":
                    accept_all = True
                elif ans != "y":
                    continue
            fp = os.path.join(out_dir, f"{int(time.time())}_{doc['id']}.json")
            with open(fp, "w", encoding="utf-8") as f:
                json.dump(doc, f, ensure_ascii=False, indent=2)
            written += 1
    print(f"Wrote {written} history docs to {out_dir}")

    if args.index and written:
        from tpu_rag_torch.engine import RagEngine
        from tpu_rag_torch.ingest.chunker import to_chunks
        import glob as _glob

        engine = RagEngine(cfg)
        try:
            for fp in _glob.glob(os.path.join(out_dir, "*.json")):
                with open(fp, encoding="utf-8") as f:
                    doc = json.load(f)
                chunks = to_chunks(doc, fp, cfg.docs_dir)
                vecs = engine.embed([c["text"] for c in chunks])
                engine.index.add([c["id"] for c in chunks], vecs,
                                 [c["text"] for c in chunks], [c["metadata"] for c in chunks])
            engine.persist_index()
        finally:
            engine.shutdown()
        print("Indexed history docs.")


if __name__ == "__main__":
    main()
