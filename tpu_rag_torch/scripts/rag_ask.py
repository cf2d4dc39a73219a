"""HTTP RAG client, /search -> grounded answer (port of scripts/rag_ask.py):
POST /search to a running server, build a [file#section]-tagged context,
answer with a curator system prompt through the LLM dispatcher
(openai/ollama/extractive), print the answer and the source tags.

  python -m tpu_rag_torch.scripts.rag_ask "where is the moon temple?" \\
      --api http://localhost:8000 --engine extractive

The request goes through urllib.request (tpu_rag uses `requests`, which
the port does not need).
"""

from __future__ import annotations

import argparse
import json
import os
import urllib.request

CURATOR_SYS = (
    "You are a careful data curator. Answer strictly from the provided "
    "sources; cite them with their [tag]. If the sources don't contain the "
    "answer, say what is missing."
)


def search(api: str, api_key: str, body: dict, timeout: float = 120.0) -> dict:
    """POST {api}/search; raises urllib.error.HTTPError on a 4xx/5xx."""
    headers = {"content-type": "application/json"}
    if api_key:
        headers["x-api-key"] = api_key
    req = urllib.request.Request(f"{api}/search", data=json.dumps(body).encode(),
                                 headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Ask a question against a running RAG server")
    ap.add_argument("query")
    ap.add_argument("--api", default=os.getenv("RAG_API", "http://localhost:8000"))
    ap.add_argument("--api-key", default=os.getenv("API_KEY", ""))
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--engine", default=None, help="openai | ollama | extractive")
    ap.add_argument("--namespace", default=None)
    args = ap.parse_args(argv)

    hits = search(args.api, args.api_key, {"query": args.query, "k": args.k,
                                           "namespace": args.namespace}).get("hits", [])
    if not hits:
        print("(no hits)")
        return

    blocks, tags = [], []
    for h in hits:
        m = h.get("metadata") or {}
        tag = f"{m.get('file_path') or h.get('id')}#{m.get('section') or ''}"
        tags.append(tag)
        blocks.append(f"[{tag}]\n{h.get('text', '')}")
    context = "\n\n".join(blocks)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.llm import LLMDispatcher

    dispatcher = LLMDispatcher(config_from_env())
    messages = [
        {"role": "system", "content": CURATOR_SYS},
        {"role": "user", "content": f"Sources:\n{context}\n\nQuestion: {args.query}"},
    ]
    answer, engine = dispatcher.generate(messages, engine=args.engine, temperature=0.2)
    print(answer)
    print("\n--- sources ---")
    for t in tags:
        print(f"  [{t}]")
    print(f"(engine: {engine})")


if __name__ == "__main__":
    main()
