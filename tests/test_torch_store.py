"""A store save does not hold up searches (tpu_rag_torch/index/store.py).

save_index pins the live row set and the arena and row-store generations
under the index lock, then writes the vector file and the row files from
that pin with the lock released.  The reference holds its index lock across
the whole write (tpu_rag/index/store.py:55), so there a /search that comes
during a /docs/save waits for the store rewrite; the port diverges on
purpose.  The store format is unchanged: a store the port saved while rows
came and went loads in both packages with exactly the pinned rows.
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
    assert (store / "ids.jsonl").read_text().split() == [json.dumps(i) for i in pinned]
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
    vec = np.fromfile(tmp_path / "vectors.f32", np.float32).reshape(-1, D)
    np.testing.assert_array_equal(vec, idx._vectors[1:N - 1])
    metas = [json.loads(line) for line in (tmp_path / "meta.jsonl").read_text().splitlines()]
    assert [m["i"] for m in metas] == list(range(1, N - 1))
