"""Incremental mutation on the port's SHARDED indexes, beside tpu_rag's: the
counterparts of tests/test_sharded_incremental.py on the CPU.

One add against a sharded corpus moves O(doc) (the unsharded append block),
a delete tag-kills in place on the shard that owns the row, and the
streamed builds keep host temporaries far below the padded corpus.  Each
test runs the same seeded rows through tpu_rag's index (its 8-device
virtual CPU mesh) and the port's (["cpu"] * 8, or data:4,model:2): the ids
must be equal, f32 scores within 1e-5 absolute.  The sharded IVF indexes
share tpu_rag's centroids (k-means draws differ between the packages).
"""

import numpy as np
import pytest
import torch

from tpu_rag.parallel import ShardedFlatIndex as JaxShardedFlat
from tpu_rag.parallel import ShardedIVFIndex as JaxShardedIVF
from tpu_rag.parallel import mesh_from_spec as jax_mesh
from tpu_rag_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, mesh_from_spec

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(n=3000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    metas = [{"namespace": "a" if i % 2 else "b"} for i in range(n)]
    return ids, vecs, metas


def _flat_pair(spec="data:8", **kw):
    return (JaxShardedFlat(32, use_pallas=False, mesh=jax_mesh(spec), **kw),
            ShardedFlatIndex(32, mesh=mesh_from_spec(spec, CPU8), **kw))


def _ivf_pair(**kw):
    return (JaxShardedIVF(32, use_pallas=False, mesh=jax_mesh("data:8"), **kw),
            ShardedIVFIndex(32, mesh=mesh_from_spec("data:8", CPU8), **kw))


def _share_centroids(jax_idx, idx):
    jax_idx.device_snapshot()
    idx._cached_centroids = np.asarray(jax_idx._cached_centroids)
    idx._centroids_trained_n = jax_idx._centroids_trained_n


def _same(a, b):
    assert a.ids == b.ids
    for x, y in zip(a.similarities, b.similarities):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_flat_single_add_uploads_one_row(dtype):
    ids, vecs, metas = _mk()
    jax_idx, idx = _flat_pair(dtype=dtype)
    new = np.ones((1, 32), np.float32)
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
        ix.search(vecs[0], 1)                        # builds the sharded snapshot
        assert ix.snapshot_stats["full_rebuilds"] == 1
        assert ix.snapshot_stats["rows_uploaded_last"] == 3000
        ix.add(["fresh"], new, ["doc"], [{"namespace": "a"}])
        assert ix.search(new, 1).ids[0][0] == "fresh"
        assert ix.snapshot_stats["full_rebuilds"] == 1       # no corpus re-shard
        assert ix.snapshot_stats["rows_uploaded_last"] == 1  # O(doc) transfer
        assert ix.search(vecs[7], 1).ids[0][0] == "v7"
        assert ix.search(new, 1, namespace="b").ids[0][0] != "fresh"
    _same(idx.search(vecs[:6], 5), jax_idx.search(vecs[:6], 5))
    assert idx.device_snapshot()["a_fill"] == 1


def test_sharded_flat_delete_kills_in_place():
    ids, vecs, metas = _mk()
    jax_idx, idx = _flat_pair(dtype="float32")
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
        ix.search(vecs[0], 1)
    snap0 = idx.device_snapshot()
    assert idx.search(vecs[42], 1).ids[0][0] == "v42"
    for ix in (jax_idx, idx):
        ix.delete(ids=["v42"])
    res = idx.search(vecs[42], 3)
    assert "v42" not in res.ids[0]
    assert len(res.ids[0]) == 3  # neighbors fill the top-k
    _same(res, jax_idx.search(vecs[42], 3))
    assert idx.snapshot_stats["full_rebuilds"] == 1
    assert idx.snapshot_stats["incremental_kills"] == 1
    assert idx.search(vecs[41], 1).ids[0][0] == "v41"
    assert idx.search(vecs[43], 1).ids[0][0] == "v43"
    # only the owning shard got a fresh tag tensor; the old snapshot keeps
    # its own (copy on write)
    snap1 = idx.device_snapshot()
    m = snap1["shard_rows"]
    owner = 42 // m
    for s in range(8):
        assert (snap1["ns"][s] is snap0["ns"][s]) == (s != owner)
    assert int(snap0["ns"][owner][42 - owner * m]) >= 0


def test_sharded_flat_incremental_matches_fresh_rebuild():
    """The append block + the sharded tag kills give what a fresh sharded
    index over the same live rows gives, in both packages."""
    ids, vecs, metas = _mk(1600, seed=5)
    alive = [i for i in range(1600) if not (i < 100 and i % 7 == 0)]
    rng = np.random.default_rng(9)
    qs = rng.standard_normal((16, 32)).astype(np.float32)
    results = []
    for inc, fresh in (_flat_pair(dtype="float32"), _flat_pair(dtype="float32")):
        inc.add(ids[:1400], vecs[:1400], None, metas[:1400])
        inc.search(vecs[0], 1)
        inc.add(ids[1400:], vecs[1400:], None, metas[1400:])
        inc.delete(ids=[f"v{i}" for i in range(0, 100, 7)])
        fresh.add([ids[i] for i in alive], vecs[alive], None, [metas[i] for i in alive])
        a, b = inc.search(qs, 5), fresh.search(qs, 5)
        _same(a, b)
        assert inc.snapshot_stats["full_rebuilds"] == 1
        results.append(a)
    # (tpu_rag's incremental, the port's incremental)
    _same(results[1], results[0])


def test_sharded_flat_multiaxis_mesh_mutation():
    """Incremental add/delete on a data x model mesh: rows sharded over
    "data" only."""
    ids, vecs, metas = _mk(1200, seed=7)
    jax_idx, idx = _flat_pair(spec="data:4,model:2", dtype="float32")
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
        ix.search(vecs[0], 1)
        ix.add(["fresh"], np.ones((1, 32), np.float32))
        ix.delete(ids=["v10"])
        assert ix.search(np.ones((1, 32), np.float32), 1).ids[0][0] == "fresh"
        assert "v10" not in ix.search(vecs[10], 3).ids[0]
        assert ix.snapshot_stats["full_rebuilds"] == 1
    _same(idx.search(vecs[8:14], 4), jax_idx.search(vecs[8:14], 4))
    assert len(idx.device_snapshot()["vectors"]) == 4


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_ivf_add_after_snapshot_skips_reupload(dtype):
    ids, vecs, metas = _mk(2000, seed=2)
    jax_idx, idx = _ivf_pair(dtype=dtype, nlist=16, nprobe=16)
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
    _share_centroids(jax_idx, idx)
    new = np.full((1, 32), 0.7, np.float32)
    for ix in (jax_idx, idx):
        ix.search(vecs[0], 1)
        assert ix.snapshot_stats["full_rebuilds"] == 1
        ix.add(["fresh"], new, ["d"], [{"namespace": "a"}])
        assert ix.search(new, 1).ids[0][0] == "fresh"
        assert ix.snapshot_stats["full_rebuilds"] == 1
        assert ix.snapshot_stats["rows_uploaded_last"] == 1
        assert ix.search(vecs[123], 1).ids[0][0] == "v123"
    _same(idx.search(vecs[120:126], 5), jax_idx.search(vecs[120:126], 5))


def test_sharded_ivf_delete_main_row_tag_kill():
    ids, vecs, metas = _mk(1500, seed=4)
    jax_idx, idx = _ivf_pair(dtype="float32", nlist=12, nprobe=12)
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
    _share_centroids(jax_idx, idx)
    for ix in (jax_idx, idx):
        ix.search(vecs[0], 1)
        assert ix.search(vecs[99], 1).ids[0][0] == "v99"
        ix.delete(ids=["v99"])
        res = ix.search(vecs[99], 3)
        assert "v99" not in res.ids[0]
        assert len(res.ids[0]) == 3
        assert ix.snapshot_stats["full_rebuilds"] == 1
        assert ix.search(vecs[98], 1).ids[0][0] == "v98"
    _same(idx.search(vecs[95:101], 3), jax_idx.search(vecs[95:101], 3))
    assert idx._s_slot_of[99] >= 0 and idx.snapshot_stats["incremental_kills"] == 1
    for ix in (jax_idx, idx):
        ix.compact()                     # reclaims, and still excludes the row
        assert "v99" not in ix.search(vecs[99], 3).ids[0]
        assert ix.snapshot_stats["full_rebuilds"] == 2


def test_sharded_ivf_delete_overflow_row():
    """Rows in the sharded exact-overflow blocks are killable in place
    (a small list cap forces spills)."""
    ids, vecs, metas = _mk(1200, seed=11)
    jax_idx, idx = _ivf_pair(dtype="float32", nlist=8, nprobe=8, list_cap_factor=0.6)
    for ix in (jax_idx, idx):
        ix.add(ids, vecs, None, metas)
    _share_centroids(jax_idx, idx)
    idx.search(vecs[0], 1)
    jax_idx.search(vecs[0], 1)
    ov_rows = [r for r in range(1200) if idx._s_ov_of[r] >= 0]
    assert ov_rows, "expected spilled rows with cap_factor=0.6"
    assert ov_rows == [r for r in range(1200) if jax_idx._s_ov_of[r] >= 0]
    victim = ov_rows[0]
    for ix in (jax_idx, idx):
        assert ix.search(vecs[victim], 1).ids[0][0] == f"v{victim}"
        ix.delete(ids=[f"v{victim}"])
        assert f"v{victim}" not in ix.search(vecs[victim], 3).ids[0]
        assert ix.snapshot_stats["full_rebuilds"] == 1
    _same(idx.search(vecs[victim:victim + 4], 3), jax_idx.search(vecs[victim:victim + 4], 3))


def test_sharded_ivf_incremental_matches_rebuild():
    ids, vecs, metas = _mk(1000, seed=6)
    alive = [i for i in range(1000) if i not in (3, 801, 500)]
    qs = np.random.default_rng(10).standard_normal((8, 32)).astype(np.float32)
    (jinc, inc), (jfresh, fresh) = (_ivf_pair(dtype="float32", nlist=8, nprobe=8),
                                    _ivf_pair(dtype="float32", nlist=8, nprobe=8))
    for ix in (jinc, inc):
        ix.add(ids[:800], vecs[:800], None, metas[:800])
    _share_centroids(jinc, inc)
    for ix, fx in ((jinc, jfresh), (inc, fresh)):
        ix.search(vecs[0], 1)
        ix.add(ids[800:], vecs[800:], None, metas[800:])
        ix.delete(ids=["v3", "v801", "v500"])
        fx.add([ids[i] for i in alive], vecs[alive], None, [metas[i] for i in alive])
        fx._cached_centroids = ix._cached_centroids       # same centroids: probes agree
        fx._centroids_trained_n = ix._centroids_trained_n
        assert ix.search(qs, 5).ids == fx.search(qs, 5).ids
    _same(inc.search(qs, 5), jinc.search(qs, 5))


def test_sharded_ivf_build_host_ram_bounded():
    """The sharded IVF build holds no padded (shards, nlist, cap, dim) f32
    corpus in host RAM: tracemalloc sees numpy's allocations (torch's are
    invisible to it, as the device's are), and the build's peak must stay a
    few shards in size.  The build must also give tpu_rag's lists."""
    import tracemalloc

    rng = np.random.default_rng(3)
    n, d, d_ax = 40_000, 64, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    ivf = ShardedIVFIndex(d, dtype="float32", nprobe=8, kmeans_sample=2048,
                          assign_chunk=4096, mesh=mesh_from_spec("data:8", CPU8))
    ivf.add(ids, vecs)
    ivf.device_snapshot()
    ivf.compact()   # measure a rebuild (first-call allocations stay out)

    tracemalloc.start()
    tracemalloc.reset_peak()
    ivf.device_snapshot()  # the build
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    shard_bytes = (n // d_ax) * d * 4
    budget = 4 * shard_bytes + (1 << 20)
    assert peak < budget, f"host peak {peak/1e6:.1f}MB > {budget/1e6:.1f}MB"
    assert ivf.search(vecs[17], 1).ids[0][0] == "v17"


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_sharded_flat_build_host_ram_bounded(dtype):
    """The streamed flat build uploads a chunk at a time: peak host
    allocation stays far below one shard, let alone the padded corpus."""
    import tracemalloc

    rng = np.random.default_rng(5)
    n, d, d_ax = 40_000, 64, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    idx = ShardedFlatIndex(d, dtype=dtype, mesh=mesh_from_spec("data:8", CPU8))
    idx.stream_upload_chunk = 1024
    idx.add(ids, vecs)
    idx.device_snapshot()
    idx.compact()

    tracemalloc.start()
    tracemalloc.reset_peak()
    idx.device_snapshot()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    shard_bytes = (n // d_ax) * d * 4
    budget = 4 * shard_bytes + (1 << 20)
    assert peak < budget, f"host peak {peak/1e6:.1f}MB > {budget/1e6:.1f}MB"
    r = idx.search(vecs[23], 1)
    assert r.ids[0][0] == "v23"
    jax_idx = JaxShardedFlat(d, dtype=dtype, use_pallas=False, mesh=jax_mesh("data:8"))
    jax_idx.add(ids, vecs)
    _same(idx.search(vecs[20:26], 5), jax_idx.search(vecs[20:26], 5))


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_sharded_vacuum_churn_parity(kind):
    """A vacuum renumbers host rows under a sharded index: the next snapshot
    rebuilds from the renumbered store and equals a fresh index over the
    same live rows; incremental mutation still works afterwards."""
    ids, vecs, metas = _mk(2400, seed=21)
    kw = dict(dtype="float32")
    if kind == "ivf":
        kw.update(nprobe=64, kmeans_sample=1024)
    pairs = ((_ivf_pair if kind == "ivf" else _flat_pair)(**kw),
             (_ivf_pair if kind == "ivf" else _flat_pair)(**kw))
    (jidx, idx), (jfresh, fresh) = pairs
    rng = np.random.default_rng(22)
    newv = rng.standard_normal((64, 32)).astype(np.float32)
    qs = rng.standard_normal((8, 32)).astype(np.float32)
    for ix in (jidx, idx):
        ix.add(ids, vecs, None, metas)
    if kind == "ivf":
        _share_centroids(jidx, idx)
    alive = [i for i in range(2400) if not (i < 600 and i % 3 == 0)]
    keep = [i for i in range(64) if i not in (0, 63)]
    got = []
    for ix, fx in ((jidx, jfresh), (idx, fresh)):
        ix.search(vecs[0], 1)
        ix.delete(ids=[f"v{i}" for i in range(0, 600, 3)])
        ix.add([f"n{i}" for i in range(64)], newv, None, [{} for _ in range(64)])
        ix.delete(ids=["n0", "n63"])
        assert ix.vacuum() == 202
        fx.add([ids[i] for i in alive], vecs[alive], None, [metas[i] for i in alive])
        fx.add([f"n{i}" for i in keep], newv[keep], None, [{} for _ in keep])
        if kind == "ivf":
            fx._cached_centroids = ix._cached_centroids
            fx._centroids_trained_n = ix._centroids_trained_n
        a = ix.search(qs, 5)
        assert a.ids == fx.search(qs, 5).ids
        got.append(a)
        probe = np.full((1, 32), 0.9, np.float32)
        ix.add(["post"], probe, ["d"], [{}])
        assert ix.search(probe, 1).ids[0][0] == "post"
        ix.delete(ids=["post"])
        assert "post" not in ix.search(probe, 2).ids[0]
    _same(got[1], got[0])


def test_rehearse_100m_on_cpu_at_a_tiny_size(tmp_path):
    """The port's rehearse_100m (disk master, SQLite row store, streamed
    sharded build, planted self hits, an O(doc) add and kill, the RSS
    bound) passes on the CPU at a tiny size, as scripts/rehearse_100m.py
    does at the same size on tpu_rag's virtual mesh."""
    import json
    import os
    import subprocess
    import sys

    from tpu_rag_torch.scripts import rehearse_100m

    argv = ["--rows", "20000", "--dim", "32", "--chunk", "5000"]
    rep = rehearse_100m.run(rehearse_100m.build_parser().parse_args(
        argv + ["--device", "cpu", "--workdir", str(tmp_path / "port")]))
    assert rep["passed"], rep
    assert rep["self_hits"] == "8/8" and rep["incremental_ok"] and rep["shards"] == 8
    assert rep["snapshot"]["full_rebuilds"] == 1 and rep["snapshot"]["incremental_kills"] == 1
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "scripts/rehearse_100m.py", *argv, "--workdir",
                          str(tmp_path / "jax")], cwd=repo, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("rows", "dim", "self_hits", "incremental_ok", "passed"):
        assert rep[key] == ref[key], key
    assert rep["shards"] == ref["devices"]
