"""Bulk import with [UPSERT] reporting (port of scripts/bulk_import.py):
the build_index chunker and engine, one upsert per document.

  python -m tpu_rag_torch.scripts.bulk_import [FILE_OR_DIR ...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Bulk-import JSON docs into the index")
    ap.add_argument("paths", nargs="*", help="files or dirs (default: DOCS_DIR)")
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.ingest.chunker import to_chunks

    cfg = config_from_env()
    engine = RagEngine(cfg)
    try:
        files: list[str] = []
        for p in args.paths or [cfg.docs_dir]:
            if os.path.isdir(p):
                files.extend(glob.glob(os.path.join(p, "**", "*.json"), recursive=True))
            else:
                files.append(p)

        total = 0
        for fp in files:
            try:
                with open(fp, "r", encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError) as e:
                print(f"[SKIP] {fp}: {e}")
                continue
            for d in data if isinstance(data, list) else [data]:
                chunks = to_chunks(d, fp, cfg.docs_dir)
                vecs = engine.embed([c["text"] for c in chunks])
                engine.index.add([c["id"] for c in chunks], vecs,
                                 [c["text"] for c in chunks],
                                 [c["metadata"] for c in chunks])
                print(f"[UPSERT] {d.get('id') or os.path.basename(fp)} ({len(chunks)} chunks)")
                total += 1
        engine.persist_index()
        print(f"Done. Upserted {total} documents.")
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
