"""Multi-process initialization and per-process shard loading (port of
tpu_rag/parallel/distributed.py).

`maybe_init_distributed` starts torch.distributed from torchrun's
environment:

  MASTER_ADDR, MASTER_PORT   host and port of rank 0
  WORLD_SIZE, RANK           processes in all and this one's rank
  LOCAL_RANK                 this process's card on its host (optional)

It is a no-op without them, as tpu_rag's is without JAX_COORDINATOR_ADDRESS.
The process group gets its address as tcp://MASTER_ADDR:MASTER_PORT, its
world size and its rank explicitly.  NCCL serves `cuda` and gloo `cpu`
unless the caller names a backend; NCCL takes one card a rank, so ranks
that share a card (a rehearsal on one card) name gloo.

`load_sharded_flat_distributed` has each process read only its own row
range of a saved store into its shards; the per-process top-k lists merge
through torch.distributed.all_gather (on the CPU when the backend is gloo,
which gathers no CUDA tensors).  The loaded index is read-only.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tpu_rag_torch.device import resolve

logger = logging.getLogger(__name__)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def maybe_init_distributed(backend: str | None = None, *, device: str = "cuda") -> bool:
    """Initialize torch.distributed from the environment.  Returns True when
    a process group is up (started here or before), False without the
    environment."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if not all(os.environ.get(name) for name in _ENV):
        return False
    if backend is None:
        backend = "nccl" if resolve(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    logger.info("torch.distributed initialized (%s): rank %d of %d", backend,
                dist.get_rank(), dist.get_world_size())
    return True


def _world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def device_row_bounds(n_pad: int, local_devices: int = 1) -> tuple[int, int]:
    """Row range [lo, hi) of an n_pad-row row-sharded layout owned by THIS
    process: the shards are laid out process-major (every process holds
    `local_devices` shards) and n_pad divides evenly by the global shard
    count."""
    rank, world = _world()
    rows_per_device = n_pad // (world * local_devices)
    lo = rank * local_devices * rows_per_device
    return lo, lo + local_devices * rows_per_device


def _default_local_devices(device: str) -> list[torch.device]:
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    return [dev]


def load_sharded_flat_distributed(path, *, mesh=None, axis: str = "data",
                                  dtype: str = "bfloat16", block_n: int = 8192,
                                  device: str = "cuda"):
    """Multi-process load of a saved flat store.

    Each process builds only the shards of its row range (device_row_bounds)
    from the memmapped vectors file, whose other rows it never reads; ids,
    documents and metadata are adopted on every process (every process can
    answer any hit), and the refine reads its candidates' rows from the same
    memmap.  `mesh` is this process's mesh (default: its one device).
    Every process must call `search` with the same queries: the per-process
    top-k lists are exchanged by all_gather.

    The returned index is READ-ONLY: a mutation needs a coordinated
    re-shard — rebuild the store and load it again."""
    from tpu_rag_torch.index.store import _open_snapshot, iter_store_ids
    from tpu_rag_torch.parallel.mesh import mesh_from_spec
    from tpu_rag_torch.parallel.sharded import SHARD_UNIT, ShardedFlatIndex

    # every file the manifest names, opened before any is read (a save may
    # replace the store meanwhile: store.load_index does the same)
    manifest, opened = _open_snapshot(Path(path))
    n, dim = manifest["count"], manifest["dim"]
    if dtype == "auto":
        # resolved here, by FlatIndex.dtype's rule on the whole store
        dtype = "int8" if n >= 2_000_000 else "bfloat16"
    mesh = mesh or mesh_from_spec("", _default_local_devices(device))

    class _DistributedFlatIndex(ShardedFlatIndex):
        kind = "dist_flat"
        _READONLY_MSG = ("distributed index is read-only on multi-host: "
                         "mutations need a coordinated re-shard — rebuild the "
                         "store and reload (see parallel/distributed.py)")

        def add(self, *a, **k):
            raise RuntimeError(self._READONLY_MSG)

        upsert = add

        def delete(self, *a, **k):
            raise RuntimeError(self._READONLY_MSG)

        def _compact(self) -> dict[str, Any]:
            devices = self.shard_devices()
            rank, world = _world()
            unit = world * len(devices) * SHARD_UNIT
            n_pad = max(unit, -(-n // unit) * unit)
            lo, _hi = device_row_bounds(n_pad, len(devices))
            logger.info("distributed load: rank %d owns rows [%d, %d) of %d",
                        rank, lo, _hi, n_pad)
            return self._shard_snapshot(np.arange(n), n, n_pad, devices, row0=lo,
                                        per_shard=n_pad // (world * len(devices)))

        def _exchange(self, sc: torch.Tensor, gid: torch.Tensor, k: int):
            """all_gather of every process's (scores, global ids), then the
            same merge: rank-major is ascending-row order."""
            import torch.distributed as dist

            _rank, world = _world()
            if world == 1:
                return sc, gid
            on = sc.device if dist.get_backend() == "nccl" else torch.device("cpu")
            parts = []
            for t in (sc.contiguous(), gid.contiguous()):
                bufs = [torch.empty_like(t, device=on) for _ in range(world)]
                dist.all_gather(bufs, t.to(on))
                parts.append(bufs)
            from tpu_rag_torch.parallel.sharded import merge_shard_topk

            return merge_shard_topk(list(zip(*parts)), k, self.device)

    def _doc_meta_iter():
        for mline, dline in zip(opened["meta"], opened["docs"]):
            if mline.strip():
                yield json.loads(dline), json.loads(mline)

    try:
        idx = _DistributedFlatIndex(dim, mesh=mesh, axis=axis, dtype=dtype, block_n=block_n)
        vectors = (np.memmap(opened["vectors"], dtype=np.float32, mode="r", shape=(n, dim))
                   if n else np.zeros((0, dim), np.float32))
        idx._bulk_adopt_rows(vectors, iter_store_ids(opened["ids"]), _doc_meta_iter(),
                             count=n)
    finally:
        for f in opened.values():
            f.close()
    idx.device_snapshot()                # this process's shards, built now
    return idx
