"""The port's HostArenaIVF (tpu_rag_torch/index/host_ivf.py) on the CPU: the
cases of tests/test_host_ivf.py run on the port, stores crossing between the
two packages (a JAX-saved store searched by both gives equal rows and
scores, in exact and packed mode; a port-saved store loads in tpu_rag), and
the two faults of tpu_rag's HostArenaIVF.load that the port does not copy.
The JAX side runs its Pallas scans in interpret mode.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tpu_rag.index.host_ivf import HostArenaIVF as JaxHostIVF
from tpu_rag_torch.index.host_ivf import HostArenaIVF
from tpu_rag_torch.ops.quant import quantize_int8_rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk_corpus(n=4000, d=64, n_centers=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    x = (centers[rng.integers(0, n_centers, n)]
         + 0.25 * rng.standard_normal((n, d)).astype(np.float32))
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    q = x[rng.integers(0, n, 16)] + 0.1 * rng.standard_normal((16, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    return x.astype(np.float32), q.astype(np.float32)


def _gt_int8(x, q, k):
    """Brute-force top-k over the same int8 quantization the index stores."""
    v8, s8 = quantize_int8_rows(torch.from_numpy(x))
    scores = q @ (v8.numpy().astype(np.float32) * s8.numpy()[:, None]).T
    return np.argsort(-scores, axis=1)[:, :k]


def _build(x, cls=HostArenaIVF, **kw):
    if cls is HostArenaIVF:
        kw.setdefault("device", "cpu")
    ix = cls(x.shape[1], expected_rows=len(x), **kw)
    ix.train(x[:1024])
    for off in range(0, len(x), 1500):  # several add() chunks
        ix.add(x[off:off + 1500])
    return ix


def _digest(path) -> dict:
    return {f: hashlib.sha256((path / f).read_bytes()).hexdigest()
            for f in sorted(os.listdir(path))}


# ------------------------------------------------ tests/test_host_ivf.py's cases


def test_host_ivf_recall_and_overflow_accounting():
    x, q = _mk_corpus()
    k = 10
    ix = _build(x, nlist=32, nprobe=8, cap_factor=1.25)
    # a tight cap on clustered data must spill; spilled rows stay searchable
    assert ix.spilled_rows > 0
    assert ix.n_rows == len(x)
    sc, rows = ix.search(q, k)
    assert rows.shape == (len(q), k)
    gt = _gt_int8(x, q, k)
    rec = np.mean([len(set(rows[i][rows[i] >= 0].tolist())
                       & set(gt[i].tolist())) / k for i in range(len(q))])
    assert rec >= 0.9, rec
    assert np.all(np.diff(sc, axis=1) <= 1e-5)
    assert set(ix.last_search_stats) >= {"probe_ms", "gather_ms", "device_ms", "merge_ms"}


def test_host_ivf_full_probe_is_exhaustive():
    """nprobe == nlist + overflow == the whole corpus: recall 1.0 against
    the int8-exact scan, in exact and packed mode."""
    x, q = _mk_corpus(n=2000)
    k = 5
    ix = _build(x, nlist=16, nprobe=16, cap_factor=1.25)
    gt = _gt_int8(x, q, k)
    for mode in ("exact", "packed"):
        sc, rows = ix.search(q, k, mode=mode)
        rec = np.mean([len(set(rows[i].tolist()) & set(gt[i].tolist())) / k
                       for i in range(len(q))])
        assert rec >= (1.0 if mode == "exact" else 0.95), (mode, rec)


def test_host_ivf_filters():
    x, q = _mk_corpus(n=1000)
    ix = HostArenaIVF(x.shape[1], nlist=8, nprobe=8, cap_factor=4.0,
                      expected_rows=len(x), device="cpu")
    ix.train(x[:512])
    ns = (np.arange(len(x)) % 3).astype(np.int32)
    ix.add(x, ns=ns)
    _, rows = ix.search(q, 10, want_ns=1)
    got = rows[rows >= 0]
    assert len(got) and np.all(ns[got] == 1)


def test_host_ivf_save_load_mmap(tmp_path):
    x, q = _mk_corpus(n=1200)
    ix = _build(x, nlist=16, nprobe=6, cap_factor=1.25)
    sc0, rows0 = ix.search(q, 8)
    ix.save(str(tmp_path / "hivf"))
    ix2 = HostArenaIVF.load(str(tmp_path / "hivf"), mmap=True, device="cpu")
    assert isinstance(ix2._vec, np.memmap)
    assert ix2.n_rows == ix.n_rows and ix2.spilled_rows == ix.spilled_rows
    sc1, rows1 = ix2.search(q, 8)
    np.testing.assert_array_equal(rows0, rows1)
    np.testing.assert_allclose(sc0, sc1, atol=1e-5)


def test_host_ivf_guards():
    ix = HostArenaIVF(16, nlist=4, device="cpu")
    with pytest.raises(RuntimeError):
        ix.add(np.zeros((3, 16), np.float32))
    with pytest.raises(RuntimeError):
        ix.search(np.zeros((1, 16), np.float32), 3)
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    ix2 = HostArenaIVF(16, nlist=2, cap=128, max_overflow=8, device="cpu")
    ix2.train(x[:32])
    with pytest.raises(RuntimeError):  # the overflow bound is enforced
        for _ in range(20):
            ix2.add(x)


# ------------------------------------------------ parity with tpu_rag's tier


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_jax_store_searches_the_same_in_the_port(tmp_path, mode):
    """A store built and saved by tpu_rag, loaded by the port: equal rows and
    scores, spilled rows and a tag filter included."""
    x, q = _mk_corpus(n=1500, seed=1)
    ns = (np.arange(len(x)) % 2).astype(np.int32)
    ref = JaxHostIVF(x.shape[1], nlist=16, nprobe=6, cap_factor=1.25,
                     expected_rows=len(x))
    ref.train(x[:1024])
    ref.add(x[:900], ns=ns[:900])
    ref.add(x[900:], ns=ns[900:])
    assert ref.spilled_rows > 0
    ref.save(str(tmp_path / "jax"))
    port = HostArenaIVF.load(str(tmp_path / "jax"), mmap=True, device="cpu")
    for want_ns in (-1, 1):
        j_sc, j_rows = ref.search(q, 8, want_ns=want_ns, mode=mode)
        t_sc, t_rows = port.search(q, 8, want_ns=want_ns, mode=mode)
        np.testing.assert_array_equal(t_rows, j_rows)
        np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-5)


def test_port_store_loads_in_tpu_rag(tmp_path):
    x, q = _mk_corpus(n=1500, seed=2)
    port = _build(x, nlist=16, nprobe=6, cap_factor=1.25)
    assert port.spilled_rows > 0
    port.save(str(tmp_path / "port"))
    ref = JaxHostIVF.load(str(tmp_path / "port"), mmap=True)
    assert (ref.n_rows, ref.spilled_rows, ref.cap) == (port.n_rows, port.spilled_rows, port.cap)
    j_sc, j_rows = ref.search(q, 8)
    t_sc, t_rows = port.search(q, 8)
    np.testing.assert_array_equal(t_rows, j_rows)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-5)


# ------------------------------------------------ JAX load() faults, not copied


def test_load_restores_build_settings(tmp_path):
    """Divergence from tpu_rag/index/host_ivf.py load(): it drops
    cap_factor, max_overflow and expected_rows.  The port keeps them in
    meta.json and restores them; a store without them (a JAX store) loads
    with the JAX constructor's defaults."""
    x, _ = _mk_corpus(n=1200, seed=3)
    ix = _build(x, nlist=16, nprobe=6, cap_factor=1.5, max_overflow=5000)
    ix.save(str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert (meta["cap_factor"], meta["max_overflow"], meta["expected_rows"]) == (1.5, 5000, 1200)
    back = HostArenaIVF.load(str(tmp_path / "port"), device="cpu")
    assert (back.cap_factor, back.max_overflow, back.expected_rows) == (1.5, 5000, 1200)

    ref = _build(x, cls=JaxHostIVF, nlist=16, nprobe=6, cap_factor=1.5, max_overflow=5000)
    ref.save(str(tmp_path / "jax"))
    assert "cap_factor" not in json.loads((tmp_path / "jax" / "meta.json").read_text())
    back = HostArenaIVF.load(str(tmp_path / "jax"), device="cpu")
    assert (back.cap_factor, back.max_overflow, back.expected_rows) == (2.0, 1 << 20, 0)


def test_add_after_mmap_load_leaves_files_unchanged(tmp_path):
    """Divergence from tpu_rag/index/host_ivf.py load(mmap=True): its lists
    are mapped read-only, so add() raises.  The port maps them
    copy-on-write: add() works, the new rows are found, and the store's
    files keep their bytes."""
    x, q = _mk_corpus(n=1600, seed=4)
    ix = _build(x[:1200], nlist=16, nprobe=16, cap_factor=2.0)
    ix.save(str(tmp_path / "s"))
    before = _digest(tmp_path / "s")

    jax_ix = JaxHostIVF.load(str(tmp_path / "s"), mmap=True)
    with pytest.raises(ValueError):          # the fault the port does not copy
        jax_ix.add(x[1200:])

    back = HostArenaIVF.load(str(tmp_path / "s"), mmap=True, device="cpu")
    assert isinstance(back._vec, np.memmap)
    back.add(x[1200:])
    ix.add(x[1200:])
    assert back.n_rows == ix.n_rows == 1600
    _, rows = back.search(x[1300:1304], 1)
    np.testing.assert_array_equal(rows[:, 0], np.arange(1300, 1304))
    np.testing.assert_array_equal(back.search(q, 8)[1], ix.search(q, 8)[1])
    assert _digest(tmp_path / "s") == before
