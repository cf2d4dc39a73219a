"""Whole-doc ingest, no chunking (port of scripts/ingest_docs.py): one
vector per doc from its `content|text|body` field; the doc id (or file
name) is the vector id.  build_index gives section-level retrieval.

  python -m tpu_rag_torch.scripts.ingest_docs [--docs-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Whole-doc ingest (no chunking)")
    ap.add_argument("--docs-dir", default=None)
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.ingest.schema import normalize_value

    cfg = config_from_env()
    if args.docs_dir:
        cfg.docs_dir = args.docs_dir
    engine = RagEngine(cfg)
    try:
        files = glob.glob(os.path.join(cfg.docs_dir, "**", "*.json"), recursive=True)
        count = 0
        for fp in files:
            try:
                with open(fp, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                print(f"[SKIP] {fp}: {e}")
                continue
            for d in doc if isinstance(doc, list) else [doc]:
                text = d.get("content") or d.get("text") or normalize_value(d.get("body", ""))
                if not str(text).strip():
                    continue
                doc_id = d.get("id") or os.path.splitext(os.path.basename(fp))[0]
                meta = {"namespace": d.get("namespace", ""),
                        "canonicality": d.get("canonicality", "canon"),
                        "title": d.get("title", doc_id)}
                engine.index.add([doc_id], engine.embed([str(text)]), [str(text)], [meta])
                count += 1
                print(f"[ADD] {doc_id}")
        engine.persist_index()
        print(f"Done: {count} docs.")
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
