"""Fine-tune the bi-encoder with in-batch-negative contrastive training;
port of scripts/train_biencoder.py.

  python -m tpu_rag_torch.scripts.train_biencoder --pairs pairs.jsonl \
      --steps 200 --out ckpts/biencoder
  EMBEDDING_WEIGHTS=ckpts/biencoder python -m tpu_rag_torch.serve

pairs.jsonl: one {"q": "...", "d": "..."} JSON object per line (a query and
a matching document/passage).  With no --pairs, synthetic pairs are derived
from the docs corpus (query = title+summary, doc = body text) — weak
supervision, but enough to adapt the embedder to the corpus vocabulary.

--out is a HF BertModel directory (model.safetensors + config.json,
models/hf_export.py) that EMBEDDING_WEIGHTS serves.  Training runs on
--device (cuda unless told otherwise; cuda without a card raises).
--mesh data:N,model:M trains data x tensor parallel over a parallel.Mesh
(train/contrastive.py) of the devices --device names: "cuda" is every
card; one named device ("cuda:0", "cpu") fills every entry of the mesh,
whose ranks then run one after another on it; or a comma-separated list.
The gathered checkpoint serves unsharded.

  python -m tpu_rag_torch.scripts.train_biencoder --pairs pairs.jsonl \
      --out ckpt --mesh data:2,model:2 --device cuda:0
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os


def corpus_pairs(docs_dir: str) -> list[tuple[str, str]]:
    from tpu_rag_torch.ingest.chunker import to_chunks

    pairs = []
    for fp in glob.glob(os.path.join(docs_dir, "**", "*.json"), recursive=True):
        try:
            with open(fp, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        for d in data if isinstance(data, list) else [data]:
            chunks = to_chunks(d, fp, docs_dir)
            title = d.get("title", "")
            summary = d.get("summary", "")
            for c in chunks[1:]:  # body sections as docs, title+summary as query
                pairs.append((f"{title} {summary}".strip(), c["text"]))
    return pairs


def parse_mesh(text: str) -> dict[str, int]:
    """"data:4,model:2" -> {"data": 4, "model": 2}; "" -> {}."""
    mesh = {}
    for part in filter(None, (p.strip() for p in text.split(","))):
        name, _, size = part.partition(":")
        if name not in ("data", "model") or not size.isdigit():
            raise SystemExit(f"bad --mesh entry {part!r}: expected data:N[,model:M]")
        mesh[name] = int(size)
    return mesh


def mesh_devices(device: str, size: int) -> list[str] | None:
    """The device list of a mesh of `size` entries: None (every card) for
    "cuda", one named device repeated, or the comma-separated list."""
    names = [d.strip() for d in device.split(",") if d.strip()]
    if names == ["cuda"]:
        return None
    return names * size if len(names) == 1 else names


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", default=None, help="pairs.jsonl ({'q','d'} per line)")
    ap.add_argument("--out", required=True, help="checkpoint output dir (HF BertModel)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--mesh", default="", help='e.g. "data:4,model:2" ("" = one device)')
    ap.add_argument("--device", default="cuda",
                    help='cuda, cpu, cuda:N, or a comma-separated list for --mesh')
    args = ap.parse_args(argv)

    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.device import resolve
    from tpu_rag_torch.models.biencoder import spec_for_model
    from tpu_rag_torch.models.tokenizer import encode_batch, load_tokenizer
    from tpu_rag_torch.parallel.mesh import mesh_from_spec
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer

    sizes = parse_mesh(args.mesh)
    size = math.prod(sizes.values())
    if size > 1:
        mesh = mesh_from_spec(args.mesh, mesh_devices(args.device, size))
        device = mesh.devices.flat[0]
    else:
        mesh, device = None, resolve(args.device)
    cfg = config_from_env()

    if args.pairs:
        pairs = []
        with open(args.pairs, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    pairs.append((rec["q"], rec["d"]))
    else:
        pairs = corpus_pairs(cfg.docs_dir)
    if len(pairs) < 2:
        print("need at least 2 training pairs")
        return
    print(f"{len(pairs)} training pairs")

    import numpy as np

    spec = spec_for_model(cfg.embedding_model)
    tok = load_tokenizer(cfg.tokenizer_path, vocab_size=spec.vocab_size)
    # f32 compute, as tpu_rag's script trains (its trainer's default dtype)
    trainer = ContrastiveTrainer(spec, lr=args.lr, tau=args.tau, device=device, mesh=mesh)

    rng = np.random.default_rng(0)
    b = args.batch
    for step in range(args.steps):
        idx = rng.integers(0, len(pairs), b)
        qs = [pairs[i][0] for i in idx]
        ds = [pairs[i][1] for i in idx]
        q_ids, q_mask = encode_batch(tok, qs, args.seq_len, batch=b)
        d_ids, d_mask = encode_batch(tok, ds, args.seq_len, batch=b)
        loss = trainer.train_step({"q_ids": q_ids, "q_mask": q_mask,
                                   "d_ids": d_ids, "d_mask": d_mask})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {loss:.4f}", flush=True)

    out = os.path.abspath(args.out)
    trainer.save(out)
    print(f"saved checkpoint to {out}")
    print(f"use it: EMBEDDING_WEIGHTS={out} python -m tpu_rag_torch.serve")


if __name__ == "__main__":
    main()
