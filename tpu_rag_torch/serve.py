"""Start the port's HTTP server: `python -m tpu_rag_torch.serve`.

Mirrors scripts/serve.py of the JAX package.  Configuration comes from the
environment (config_from_env: PERSIST_DIR, EMBEDDING_MODEL, INDEX_DTYPE,
DEVICE=cuda|cpu, MESH_SHAPE, ...); --host/--port override HOST/PORT.  Under
torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK set) it joins the
process group first and each process serves its row shard of the store
(parallel/distributed.py).
"""

from __future__ import annotations

import argparse
import logging


def main() -> None:
    ap = argparse.ArgumentParser(description="Serve the tpu_rag_torch RAG API")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--log-level", default="info")
    args = ap.parse_args()

    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from tpu_rag_torch.api.app import create_app
    from tpu_rag_torch.api.server import run_app
    from tpu_rag_torch.config import config_from_env
    from tpu_rag_torch.parallel.distributed import maybe_init_distributed

    cfg = config_from_env()
    maybe_init_distributed(device=cfg.device)
    if args.host:
        cfg.host = args.host
    if args.port:
        cfg.port = args.port
    app = create_app(cfg)
    if cfg.warmup:
        print("warming up encoder + search kernels ...")
        app.state["engine"].warmup()
    print(f"tpu_rag_torch serving on http://{cfg.host}:{cfg.port} "
          f"(collection={cfg.collection_name}, index={cfg.index_kind}/{cfg.index_dtype}, "
          f"device={cfg.device})")
    run_app(app, cfg.host, cfg.port, executor_workers=cfg.http_executor_workers)


if __name__ == "__main__":
    main()
