"""Query the persisted index directly, no HTTP server (port of
scripts/query_local.py): --k (clamped 1..20), --namespace, --canonicality,
--json; pretty or JSON output.

  python -m tpu_rag_torch.scripts.query_local "silver cliff" --k 3 --json
"""

from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Query the local vector index")
    ap.add_argument("query", help="query text")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--namespace", default=None)
    ap.add_argument("--canonicality", default=None)
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.engine import RagEngine

    engine = RagEngine(config_from_env())
    try:
        hits = engine.query_vector(args.query, max(1, min(args.k, 20)),
                                   args.namespace, args.canonicality)
    finally:
        engine.shutdown()
    if args.json:
        print(json.dumps({"hits": hits}, ensure_ascii=False, indent=2))
        return
    if not hits:
        print("(no hits)")
        return
    for h in hits:
        m = h.get("metadata") or {}
        print(f"#{h['rank']}  score={h['score']:.4f}  id={h['id']}")
        print(f"    ns={m.get('namespace')}  canon={m.get('canonicality')}  "
              f"section={m.get('section')}  title={m.get('title')}")
        text = (h.get("text") or "").replace("\n", " ")
        print(f"    {text[:200]}{'…' if len(text) > 200 else ''}")


if __name__ == "__main__":
    main()
