"""Doc -> chunk decomposition.

Parity with reference scripts/build_index.py:29-87: one "::summary" chunk
(title + summary) plus one chunk per body section (dict keys), or a single
"::body" chunk for scalar bodies.  Metadata carries
{namespace, canonicality, source_id, section, title, file_path}; namespace
defaults to the parent folder name.
"""

from __future__ import annotations

import hashlib
import json
import os


def to_chunks(doc: dict, fp: str, docs_dir: str = ".") -> list[dict]:
    default_ns = os.path.basename(os.path.dirname(fp)) or "default"
    base_id = doc.get("id") or hashlib.md5(
        (fp + json.dumps(doc, sort_keys=True)).encode("utf-8")
    ).hexdigest()
    namespace = doc.get("namespace", default_ns)
    canonicality = doc.get("canonicality", "canon")
    title = doc.get("title", os.path.splitext(os.path.basename(fp))[0])
    summary = doc.get("summary", "")
    body = doc.get("body", {})

    try:
        file_path = os.path.relpath(fp, docs_dir).replace("\\", "/")
    except ValueError:
        file_path = fp

    from tpu_rag_torch.ingest.schema import normalize_value

    def meta(section: str) -> dict:
        return {
            "namespace": namespace,
            "canonicality": canonicality,
            "source_id": base_id,
            "section": section,
            "title": title,
            "file_path": file_path,
        }

    chunks = [{
        "id": f"{base_id}::summary",
        "text": f"{title}\n\n{summary}",
        "metadata": meta("summary"),
    }]
    if isinstance(body, dict):
        for key, value in body.items():
            txt = normalize_value(value)
            if txt.strip():
                chunks.append({
                    "id": f"{base_id}::{key}",
                    "text": f"{title} — {key}\n\n{txt}",
                    "metadata": meta(key),
                })
    else:
        txt = normalize_value(body)
        if txt.strip():
            chunks.append({
                "id": f"{base_id}::body",
                "text": f"{title}\n\n{txt}",
                "metadata": meta("body"),
            })
    return chunks
