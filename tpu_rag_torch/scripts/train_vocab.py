"""Build a WordPiece vocab.txt from the docs corpus (no downloads needed);
port of scripts/train_vocab.py.

Usage: python -m tpu_rag_torch.scripts.train_vocab --out vocab.txt [--vocab-size 30522]
Then set TOKENIZER_PATH=vocab.txt and rebuild the index.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs-dir", default=None)
    ap.add_argument("--out", default="vocab.txt")
    ap.add_argument("--vocab-size", type=int, default=30522)
    ap.add_argument("--min-freq", type=int, default=2)
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.ingest.chunker import to_chunks
    from tpu_rag_torch.models.vocab_train import save_vocab, train_wordpiece_vocab

    cfg = config_from_env()
    docs_dir = args.docs_dir or cfg.docs_dir
    texts: list[str] = []
    for fp in glob.glob(os.path.join(docs_dir, "**", "*.json"), recursive=True):
        try:
            with open(fp, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        for d in data if isinstance(data, list) else [data]:
            texts.extend(c["text"] for c in to_chunks(d, fp, docs_dir))

    if not texts:
        print("no corpus text found")
        return
    vocab = train_wordpiece_vocab(texts, vocab_size=args.vocab_size, min_freq=args.min_freq)
    save_vocab(vocab, args.out)
    print(f"wrote {len(vocab)} tokens to {args.out} (from {len(texts)} chunks)")


if __name__ == "__main__":
    main()
