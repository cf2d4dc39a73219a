"""Per-process shard loading (tpu_rag_torch.parallel.distributed) beside
tpu_rag's, on the CPU: the counterparts of tests/test_distributed.py, a
real two-process gloo run, and the engine's sharded branches.

A store saved by the port is loaded by both packages' distributed loaders
(tpu_rag's on its 8-device virtual CPU mesh, the port's on ["cpu"] * 8):
ids must be equal, f32 scores within 1e-5 absolute.  The two-process run
starts two interpreters that each join a gloo group on localhost, load
their half of the rows and answer the same queries; both must return the
ids a single-process load gives.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpu_rag.parallel.distributed import device_row_bounds as jax_row_bounds
from tpu_rag.parallel.distributed import load_sharded_flat_distributed as jax_load_dist
from tpu_rag_torch.config import Config
from tpu_rag_torch.engine import RagEngine
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.store import load_index, save_index
from tpu_rag_torch.parallel import ShardedFlatIndex, mesh_from_spec
from tpu_rag_torch.parallel.distributed import (device_row_bounds,
                                                load_sharded_flat_distributed,
                                                maybe_init_distributed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _store(tmp_path, n=3000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = FlatIndex(d, dtype="float32", device="cpu")
    idx.add([f"v{i}" for i in range(n)], vecs, [f"doc {i}" for i in range(n)],
            [{"namespace": "even" if i % 2 == 0 else "odd"} for i in range(n)])
    save_index(idx, tmp_path / "col")
    return idx, vecs


def _same(a, b):
    assert a.ids == b.ids
    for x, y in zip(a.similarities, b.similarities):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)


def test_distributed_load_matches_direct_and_jax(tmp_path):
    direct, vecs = _store(tmp_path)
    dist_idx = load_sharded_flat_distributed(tmp_path / "col", dtype="float32",
                                             mesh=mesh_from_spec("", CPU8), device="cpu")
    jax_idx = jax_load_dist(tmp_path / "col", dtype="float32", use_pallas=False)
    qs = vecs[[5, 77, 123]]
    a = dist_idx.search(qs, 5)
    assert a.ids == direct.search(qs, 5).ids
    _same(a, jax_idx.search(qs, 5))
    # filters work through the distributed snapshot
    r = dist_idx.search(vecs[8], 4, namespace="even")
    assert r.ids[0][0] == "v8"
    assert all(m["namespace"] == "even" for m in r.metadatas[0])
    assert r.ids == jax_idx.search(vecs[8], 4, namespace="even").ids
    snap = dist_idx.device_snapshot()
    assert snap["row0"] == 0 and len(snap["vectors"]) == 8
    assert snap["n_pad"] == jax_idx.device_snapshot()["n_pad"]


def test_distributed_index_is_readonly(tmp_path):
    _store(tmp_path)
    dist_idx = load_sharded_flat_distributed(tmp_path / "col", dtype="float32",
                                             mesh=mesh_from_spec("", CPU8), device="cpu")
    with pytest.raises(RuntimeError, match="read-only"):
        dist_idx.add(["x"], np.ones((1, 32), np.float32))
    with pytest.raises(RuntimeError, match="read-only"):
        dist_idx.upsert(["x"], np.ones((1, 32), np.float32))
    with pytest.raises(RuntimeError, match="read-only"):
        dist_idx.delete(ids=["v1"])


def test_device_row_bounds_cover_everything():
    n_pad = 8 * 256
    lo, hi = device_row_bounds(n_pad, 8)
    assert (lo, hi) == (0, n_pad) == jax_row_bounds(n_pad)   # one process owns all rows
    assert device_row_bounds(n_pad) == (0, n_pad)


def test_maybe_init_is_a_no_op_without_the_environment(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    for name in ("jax", "jaxlib", "tpu_rag"):
        sys.modules[name] = None                 # the port alone
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from tpu_rag_torch.parallel.distributed import (device_row_bounds,
        load_sharded_flat_distributed, maybe_init_distributed)
    from tpu_rag_torch.parallel.mesh import mesh_from_spec

    assert maybe_init_distributed(backend={backend!r}, device="cpu")
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    idx = load_sharded_flat_distributed({store!r}, dtype="float32", device="cpu",
                                        mesh=mesh_from_spec("", ["cpu"] * 2))
    snap = idx.device_snapshot()
    vecs = np.asarray(idx._vectors)
    res = idx.search(vecs[[7, 42, 2999]], 3)
    print("RESULT", json.dumps({{"rank": dist.get_rank(), "ids": res.ids,
                                "sims": res.similarities, "row0": snap["row0"],
                                "rows": sum(int(t.shape[0]) for t in snap["vectors"]),
                                "n_pad": snap["n_pad"]}}))
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_two_process_gloo_run(tmp_path, backend):
    """Two OS processes of 2 shards each form one 4-shard layout over
    gloo; each loads only its half and both return the single-process
    load's ids (the all_gather crosses the processes).  backend None picks
    gloo for the CPU."""
    direct, vecs = _store(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = _WORKER.format(repo=REPO, store=str(tmp_path / "col"), backend=backend)
    procs = []
    for rank in (0, 1):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(rank)}
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, env=env, text=True))
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            pytest.fail("distributed worker timed out")
        assert pr.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(out)
    results = sorted((json.loads(ln[len("RESULT "):]) for out in outs
                      for ln in out.splitlines() if ln.startswith("RESULT ")),
                     key=lambda r: r["rank"])
    assert [r["rank"] for r in results] == [0, 1]
    n_pad = results[0]["n_pad"]
    assert n_pad == 4 * 256 * 3                  # 3000 rows padded to 4 x 256
    assert [(r["row0"], r["rows"]) for r in results] == [(0, n_pad // 2),
                                                         (n_pad // 2, n_pad // 2)]
    want = direct.search(vecs[[7, 42, 2999]], 3)
    for r in results:
        assert r["ids"] == want.ids
        np.testing.assert_allclose(np.asarray(r["sims"]), np.asarray(want.similarities),
                                   rtol=0, atol=1e-5)
    assert want.ids[0][0] == "v7" and want.ids[2][0] == "v2999"


def _cfg(tmp_path, **kw):
    return Config(persist_dir=str(tmp_path / "vs"), kb_db_path=str(tmp_path / "db" / "kb.sqlite3"),
                  db_path=str(tmp_path / "db" / "app.sqlite3"), docs_dir=str(tmp_path / "docs"),
                  device="cpu", embedding_model="tiny", **kw)


def test_engine_mesh_needs_two_devices(tmp_path):
    """MESH_SHAPE shards only over two or more devices: the CPU counts as
    one, so the engine keeps an unsharded FlatIndex (as tpu_rag's does on
    one device)."""
    engine = RagEngine(_cfg(tmp_path, mesh_shape="data:1"))
    try:
        assert engine._mesh() is None and type(engine.index) is FlatIndex
    finally:
        engine.shutdown()


def test_engine_takes_the_sharded_branches(tmp_path, monkeypatch):
    """With a data axis over 2+ devices: a new index is a ShardedFlatIndex,
    a saved flat store loads into one (from_state), and under a process
    group of 2+ the distributed load runs, and a failure of it raises
    (tpu_rag logs it and falls back to a replicated load)."""
    mesh = mesh_from_spec("data:4", ["cpu"] * 4)
    monkeypatch.setattr(RagEngine, "_mesh", lambda self: mesh)
    cfg = _cfg(tmp_path)
    engine = RagEngine(cfg)
    try:
        assert type(engine.index) is ShardedFlatIndex
        assert engine.index.shard_devices() == [torch.device("cpu")] * 4
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((500, engine.encoder.dim)).astype(np.float32)
        engine.index.add([f"v{i}" for i in range(500)], vecs)
        engine.persist_index()
    finally:
        engine.shutdown()
    engine = RagEngine(cfg)                     # the saved store, sharded again
    try:
        assert type(engine.index) is ShardedFlatIndex and engine.index.count() == 500
        assert engine.index.search(vecs[3], 1).ids[0][0] == "v3"
        assert load_index(engine._index_path(), device="cpu").count() == 500
    finally:
        engine.shutdown()

    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    from tpu_rag_torch.parallel import distributed as dmod

    def broken(*a, **k):
        raise OSError("shard file unreadable")
    monkeypatch.setattr(dmod, "load_sharded_flat_distributed", broken)
    with pytest.raises(OSError, match="unreadable"):
        RagEngine(cfg)
