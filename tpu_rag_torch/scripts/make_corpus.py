"""Build a real-text training corpus from Python docstrings found on disk
(port of scripts/make_corpus.py; the same JSONL, byte for byte).

An air-gapped machine has no downloadable datasets, but site-packages
carries ~200MB of human-written English: numpy/pandas/torch docstrings.
Each docstring becomes one doc; its PEP-257 first line (a one-sentence
summary) becomes the labeled QUERY and the remainder becomes the DOCUMENT —
a natural paraphrase-level retrieval task: the summary states *what* in
different words than the body's *how* (parameters, semantics, examples).

Usage:
  python -m tpu_rag_torch.scripts.make_corpus --out corpus.jsonl [--max-docs 20000]

Output: JSONL {"id", "title", "query", "body"} — consumed by
tpu_rag_torch/scripts/train_semantic.py.  AST-parsed from source files;
nothing is imported, so it runs in seconds.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import sys
import sysconfig

_WORD = re.compile(r"[A-Za-z]{2,}")


def _iter_py_files(roots: list[str], max_files: int):
    n = 0
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in
                           ("tests", "test", "__pycache__", "_vendor", "vendored")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)
                    n += 1
                    if n >= max_files:
                        return


def _docstrings(path: str):
    try:
        tree = ast.parse(open(path, encoding="utf-8", errors="ignore").read())
    except Exception:
        return
    stack = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = f"{prefix}{child.name}"
                doc = ast.get_docstring(child)
                if doc:
                    yield name, doc
                stack.append((child, name + "."))


def _good_pair(doc: str) -> tuple[str, str] | None:
    """Split a docstring into (summary-line query, body remainder).  Reject
    docstrings without a real one-line summary or enough body text."""
    lines = doc.strip().splitlines()
    if not lines:
        return None
    query = lines[0].strip()
    body = "\n".join(lines[1:]).strip()
    if not (20 <= len(query) <= 200) or len(body) < 250:
        return None
    if len(_WORD.findall(query)) < 4:     # summaries need actual words
        return None
    if len(_WORD.findall(body)) < 40:     # bodies that are all markup/math
        return None
    return query, body


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-docs", type=int, default=20000)
    ap.add_argument("--max-files", type=int, default=40000)
    ap.add_argument("--max-body-chars", type=int, default=2000)
    args = ap.parse_args(argv)

    roots = [sysconfig.get_paths()["purelib"],   # site-packages
             sysconfig.get_paths()["stdlib"]]
    seen_hashes: set[str] = set()
    docs = []
    for path in _iter_py_files(roots, args.max_files):
        for name, doc in _docstrings(path) or ():
            pair = _good_pair(doc)
            if pair is None:
                continue
            query, body = pair
            body = body[: args.max_body_chars]
            # dedup on normalized body (templated docstrings repeat a lot)
            h = hashlib.blake2b(" ".join(body.lower().split()).encode(),
                                digest_size=12).hexdigest()
            if h in seen_hashes:
                continue
            seen_hashes.add(h)
            docs.append({"id": f"doc-{len(docs):06d}", "title": name,
                         "query": query, "body": body})
            if len(docs) >= args.max_docs:
                break
        if len(docs) >= args.max_docs:
            break

    with open(args.out, "w", encoding="utf-8") as f:
        for d in docs:
            f.write(json.dumps(d, ensure_ascii=False) + "\n")
    chars = sum(len(d["body"]) for d in docs)
    print(f"wrote {len(docs)} docs ({chars/1e6:.1f}M body chars) -> {args.out}")


if __name__ == "__main__":
    sys.exit(main())
