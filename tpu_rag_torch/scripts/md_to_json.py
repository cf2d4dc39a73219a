"""Markdown -> doc-schema JSON converter (port of scripts/md_to_json.py).

Parity with reference scripts/md_to_json.py:8-63: '# ' heading -> title,
preamble before the first '## ' -> summary, each '## ' section -> a body
key; optional namespace from the parent folder name.

  python -m tpu_rag_torch.scripts.md_to_json notes/*.md --namespace-from-folder
"""

from __future__ import annotations

import argparse
import json
import os
import re


def md_to_doc(text: str, *, doc_id: str, namespace: str | None = None,
              canonicality: str = "canon") -> dict:
    lines = text.splitlines()
    title = ""
    summary_lines: list[str] = []
    body: dict[str, str] = {}
    section: str | None = None
    section_lines: list[str] = []

    def flush_section():
        nonlocal section, section_lines
        if section is not None:
            body[section] = "\n".join(section_lines).strip()
        section, section_lines = None, []

    for line in lines:
        m1 = re.match(r"^#\s+(.*)$", line)
        m2 = re.match(r"^##\s+(.*)$", line)
        if m1 and not title:
            title = m1.group(1).strip()
        elif m2:
            flush_section()
            section = m2.group(1).strip()
        elif section is not None:
            section_lines.append(line)
        else:
            summary_lines.append(line)
    flush_section()

    doc = {
        "id": doc_id,
        "title": title or doc_id,
        "summary": "\n".join(summary_lines).strip(),
        "body": body,
        "canonicality": canonicality,
    }
    if namespace:
        doc["namespace"] = namespace
    return doc


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Convert .md files to doc-schema JSON")
    ap.add_argument("files", nargs="+", help=".md files")
    ap.add_argument("--out-dir", default=None, help="output dir (default: alongside input)")
    ap.add_argument("--namespace-from-folder", action="store_true",
                    help="use parent folder name as namespace")
    ap.add_argument("--canonicality", default="canon")
    args = ap.parse_args(argv)

    for fp in args.files:
        with open(fp, encoding="utf-8") as f:
            text = f.read()
        base = os.path.splitext(os.path.basename(fp))[0]
        ns = os.path.basename(os.path.dirname(os.path.abspath(fp))) if args.namespace_from_folder else None
        doc = md_to_doc(text, doc_id=base, namespace=ns, canonicality=args.canonicality)
        out_dir = args.out_dir or os.path.dirname(os.path.abspath(fp))
        out = os.path.join(out_dir, base + ".json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False, indent=2)
        print(f"{fp} -> {out} ({len(doc['body'])} sections)")


if __name__ == "__main__":
    main()
