"""A store save does not hold up searches, and a load sees one whole
snapshot (tpu_rag_torch/index/store.py).

save_index pins the live row set and the arena and row-store generations
under the index lock, then writes the vector file and the row files from
that pin with the lock released.  The reference holds its index lock across
the whole write (tpu_rag/index/store.py:55), so there a /search that comes
during a /docs/save waits for the store rewrite; the port diverges on
purpose.  The store format is unchanged: a store the port saved while rows
came and went loads in both packages with exactly the pinned rows.

A save writes its files under fresh names and renames the manifest over
the old one last, then deletes the old files; a load opens every file its
manifest names before reading any.  The reference rewrites the row files
in place under the old manifest, so a load during a save there reads the
old count over new or half-written files.
"""

import json
import threading

import numpy as np
import pytest
import torch

from tpu_rag.index.store import load_index as jax_load
from tpu_rag_torch.index.flat import FlatIndex
from tpu_rag_torch.index.ivf import IVFIndex
from tpu_rag_torch.index.store import MANIFEST, load_index, save_index

D, N = 16, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unit(n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(kind: str) -> FlatIndex:
    idx = (FlatIndex(D, device="cpu") if kind == "flat"
           else IVFIndex(D, nlist=4, nprobe=4, device="cpu"))
    idx.add([f"d{i}" for i in range(N)], _unit(N, 0), [f"doc {i}" for i in range(N)],
            [{"namespace": f"n{i % 2}", "i": i} for i in range(N)])
    return idx


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_search_returns_while_a_save_is_held_in_its_vector_write(tmp_path, kind):
    idx = _index(kind)
    q = _unit(N, 0)[:3]
    before = idx.search(q, 5).ids                     # the snapshot exists
    entered, release = threading.Event(), threading.Event()
    write_rows = idx._arena.write_rows

    def held(*args, **kw):                            # the save, inside its vector write
        entered.set()
        assert release.wait(60)
        return write_rows(*args, **kw)

    idx._arena.write_rows = held
    store = tmp_path / "store"
    saver = threading.Thread(target=save_index, args=(idx, store))
    saver.start()
    got = {}

    def meanwhile():                                  # searches, an add and a kill
        got["search"] = idx.search(q, 5).ids
        if kind == "flat":
            res = idx.search_fused(lambda _ids: torch.from_numpy(q), None, 3, 5,
                                   return_qv=False)
            got["fused"] = res[0].ids
        idx.add(["new0", "new1"], _unit(2, 1), ["late", "late"], [{}, {}])
        idx.delete(["d5"])
        got["after_add"] = idx.search(_unit(2, 1), 1).ids

    worker = threading.Thread(target=meanwhile)
    try:
        assert entered.wait(30), "the save never reached its vector write"
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive(), "a search or an add waited for the held save"
        assert not (store / MANIFEST).exists()        # the save is still open
    finally:
        release.set()
        saver.join(timeout=60)
        worker.join(timeout=60)
    assert not saver.is_alive()
    assert got["search"] == before
    if kind == "flat":
        assert got["fused"] == before
    assert got["after_add"] == [["new0"], ["new1"]]

    # the store holds the rows pinned when the save began: d5 (killed
    # during the write) is in it, the two rows added during it are not
    manifest = json.loads((store / MANIFEST).read_text())
    assert manifest["count"] == N and manifest["kind"] == kind
    pinned = [f"d{i}" for i in range(N)]
    ids_file = store / manifest["files"]["ids"]
    assert ids_file.read_text().split() == [json.dumps(i) for i in pinned]
    for back in (load_index(store, device="cpu"), jax_load(store)):
        assert back.count() == N
        assert back.get("d5")["document"] == "doc 5" and back.get("new0") is None
        np.testing.assert_array_equal(back.get("d7")["vector"], idx.get("d7")["vector"])
    assert load_index(store, device="cpu").search(q, 5).ids == before

    # the next save takes them
    idx._arena.write_rows = write_rows
    save_index(idx, store)
    for back in (load_index(store, device="cpu"), jax_load(store)):
        assert back.count() == N + 1
        assert back.get("d5") is None and back.get("new1")["document"] == "late"


def test_saved_store_bytes_unchanged_by_the_pin(tmp_path):
    """The files are those a save under the lock writes: the manifest keys
    in their old order, rows in row order, dead rows left out."""
    idx = _index("flat")
    idx.delete(["d0", "d39"])
    save_index(idx, tmp_path)
    manifest = json.loads((tmp_path / MANIFEST).read_text())
    assert list(manifest) == ["format_version", "kind", "dim", "dtype", "metric", "count",
                              "files"]
    assert manifest["count"] == N - 2
    files = manifest["files"]
    vec = np.fromfile(tmp_path / files["vectors"], np.float32).reshape(-1, D)
    np.testing.assert_array_equal(vec, idx._vectors[1:N - 1])
    metas = [json.loads(line) for line in (tmp_path / files["meta"]).read_text().splitlines()]
    assert [m["i"] for m in metas] == list(range(1, N - 1))


def _snapshot(idx) -> dict:
    st = idx.state()
    return {"ids": st["ids"], "documents": st["documents"], "metadatas": st["metadatas"],
            "vectors": np.asarray(st["vectors"], np.float32)}


def _assert_same(got, want) -> None:
    g, w = _snapshot(got), _snapshot(want)
    assert g["ids"] == w["ids"] and g["documents"] == w["documents"]
    assert g["metadatas"] == w["metadatas"]
    np.testing.assert_array_equal(g["vectors"], w["vectors"])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_a_load_during_a_save_held_in_its_row_write_reads_the_old_snapshot_whole(
        tmp_path, kind):
    """Both packages' loaders, run while a save is stopped half way through
    its row files, read exactly the previous snapshot; after the save, exactly
    the new one."""
    idx = _index(kind)
    store = tmp_path / "store"
    save_index(idx, store)
    old = load_index(store, device="cpu")
    idx.add(["new0", "new1"], _unit(2, 1), ["late", "late"], [{"i": -1}, {"i": -2}])
    idx.delete(["d3"])
    entered, release = threading.Event(), threading.Event()
    iter_rows = idx._rowmeta.iter_rows

    def held(*args, **kw):                      # the save, half way through its rows
        for i, row in enumerate(iter_rows(*args, **kw)):
            if i == N // 2:
                entered.set()
                assert release.wait(60)
            yield row

    idx._rowmeta.iter_rows = held
    saver = threading.Thread(target=save_index, args=(idx, store))
    saver.start()
    try:
        assert entered.wait(30), "the save never reached its row write"
        for back in (load_index(store, device="cpu"), jax_load(store)):
            assert back.count() == N
            _assert_same(back, old)
    finally:
        release.set()
        saver.join(timeout=60)
    assert not saver.is_alive()
    idx._rowmeta.iter_rows = iter_rows
    for back in (load_index(store, device="cpu"), jax_load(store)):
        assert back.count() == N + 1
        _assert_same(back, idx)


def test_a_load_in_flight_keeps_its_snapshot_when_a_save_deletes_its_files(tmp_path):
    """A load that opened the old snapshot's files finishes with exactly that
    snapshot though a save in between replaced the manifest and deleted them;
    the directory then holds only the new snapshot's files."""
    idx = _index("ivf")
    idx.device_snapshot()                       # trains the centroids the store carries
    store = tmp_path / "store"
    save_index(idx, store)
    first = load_index(store, device="cpu")
    assert first._cached_centroids is not None
    entered, release = threading.Event(), threading.Event()
    adopt = IVFIndex._bulk_adopt_rows
    got = {}

    def held(self, *args, **kw):
        entered.set()
        assert release.wait(60)
        return adopt(self, *args, **kw)

    def load():
        got["index"] = load_index(store, device="cpu")

    IVFIndex._bulk_adopt_rows = held
    try:
        loader = threading.Thread(target=load)
        loader.start()
        assert entered.wait(30), "the load never reached its row reads"
        IVFIndex._bulk_adopt_rows = adopt
        idx.delete(["d0", "d1"])
        idx.add(["new0"], _unit(1, 1), ["late"], [{}])
        save_index(idx, store)
    finally:
        IVFIndex._bulk_adopt_rows = adopt
        release.set()
    loader.join(timeout=60)
    assert not loader.is_alive()
    _assert_same(got["index"], first)
    np.testing.assert_array_equal(got["index"]._cached_centroids, first._cached_centroids)
    manifest = json.loads((store / MANIFEST).read_text())
    named = set(manifest["files"].values()) | {manifest["ivf"]["centroids"], MANIFEST}
    assert {f.name for f in store.iterdir()} == named
    for back in (load_index(store, device="cpu"), jax_load(store)):
        assert back.count() == N - 1
        _assert_same(back, idx)
