"""Offline index builder (port of scripts/build_index.py): recursively scan
DOCS_DIR/**/*.json (one doc or a list per file), chunk (summary + body
sections, ingest/chunker.py), embed in batches of --batch across all files,
upsert into the persisted index.

  python -m tpu_rag_torch.scripts.build_index [--docs-dir DIR] [--batch 256]

Configuration from the environment (config_from_env); DEVICE=cpu runs on the
CPU, the default cuda needs a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Build the vector index from DOCS_DIR JSON docs")
    ap.add_argument("--docs-dir", default=None, help="override DOCS_DIR")
    ap.add_argument("--batch", type=int, default=256, help="embed batch size")
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.engine import RagEngine
    from tpu_rag_torch.ingest.chunker import to_chunks

    cfg = config_from_env()
    if args.docs_dir:
        cfg.docs_dir = args.docs_dir
    engine = RagEngine(cfg)
    try:
        files = glob.glob(os.path.join(cfg.docs_dir, "**", "*.json"), recursive=True)
        if not files:
            print("No JSON files under docs/. Add files (supports subfolders) and rerun.")
            return

        all_chunks: list[dict] = []
        total_docs = 0
        for fp in files:
            try:
                with open(fp, "r", encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError) as e:
                print(f"[SKIP] {fp} -> JSON parse error: {e}")
                continue
            docs = data if isinstance(data, list) else [data]
            for d in docs:
                all_chunks.extend(to_chunks(d, fp, cfg.docs_dir))
                total_docs += 1
            print(f"Scanned: {os.path.relpath(fp, cfg.docs_dir)}")

        t0 = time.time()
        for i in range(0, len(all_chunks), args.batch):
            batch = all_chunks[i: i + args.batch]
            vecs = engine.embed([c["text"] for c in batch])
            engine.index.add([c["id"] for c in batch], vecs,
                             [c["text"] for c in batch], [c["metadata"] for c in batch])
            print(f"Embedded {min(i + args.batch, len(all_chunks))}/{len(all_chunks)} chunks")
        engine.persist_index()
        dt = time.time() - t0
        rate = len(all_chunks) / dt if dt > 0 else float("inf")
        print(f"Done. Indexed logical documents: {total_docs} ({len(all_chunks)} chunks, "
              f"{dt:.1f}s, {rate:.0f} chunks/s). Persist at: {cfg.persist_dir}")
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
