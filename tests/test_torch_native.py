"""The port's host C++ libraries (tpu_rag_torch/native/) on the CPU: the
WordPiece tokenizer against the port's Python path and tpu_rag's, and the
HNSW baseline against tpu_rag's.

tpu_rag's own C++ tokenizer receives the raw text: it neither
NFKC-normalizes nor lowercases past ASCII, treats every non-ASCII character
as a word character and stops at a NUL, so on such text (2 of the 254
documents of examples/docs hold full-width punctuation) it gives other ids
than its Python path; the port normalizes and splits in Python before the
C++ call, so its two paths agree with tpu_rag's Python path everywhere.
The HNSW copies build from the same source with the same M, ef and seed, so
ids and distances are equal.
"""

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_rag.baseline import CpuHnswIndex as JaxHnsw
from tpu_rag.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from tpu_rag_torch.baseline import CpuHnswIndex
from tpu_rag_torch.models import tokenizer as tz
from tpu_rag_torch.models.tokenizer import WordPieceTokenizer
from tpu_rag_torch.models.vocab_train import save_vocab, train_wordpiece_vocab
from tpu_rag_torch.native import binding

REPO = Path(__file__).resolve().parent.parent
VOCAB = REPO / "examples" / "vocab.txt"
DOCS = sorted((REPO / "examples" / "docs").rglob("*.json"))
EDGE_TEXTS = [
    "", "the moon temple", "THE MOON TEMPLE on the Silver Cliff", "dragon_fire 12 300ad",
    "龍在山上，月之神殿。", "かなカナ and 한국어 mixed", "Ｆｕｌｌｗｉｄｔｈ ＡＢＣ １２３",
    "café — naïve résumé; ÉCOLE", "x" * 101 + " short " + "y" * 100,
    "über" * 30, "tab\tnew\nline\rnul\x00end", "emoji 🐉 and ﬁ ligature ™",
    "İstanbul ǅ ß ΣΑΣ", "combining é and 　 ideographic space",
    "unassigned cjk 鿿䶿 end", "under_score __init__ a_b_c",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _python_of(tok):
    tok._native = None
    return tok


@pytest.fixture(scope="module")
def trained_vocab(tmp_path_factory):
    texts = [p.read_text(encoding="utf-8") for p in DOCS] + EDGE_TEXTS
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    save_vocab(train_wordpiece_vocab(texts, vocab_size=3000, min_freq=1), path)
    return path


@pytest.mark.parametrize("vocab", ["examples", "trained"])
def test_native_python_and_tpu_rag_give_equal_ids(vocab, trained_vocab):
    path = VOCAB if vocab == "examples" else trained_vocab
    native = WordPieceTokenizer(path)
    assert native.backend == "native"
    python = _python_of(WordPieceTokenizer(path))
    ref = JaxWordPiece(path)                                   # its C++ path where built
    ref_py = _python_of(JaxWordPiece(path))
    texts = [p.read_text(encoding="utf-8") for p in DOCS] + EDGE_TEXTS
    ref_paths_differ = 0
    for text in texts:
        want = ref_py.tokenize_ids(text)
        assert native.tokenize_ids(text) == want, text[:80]
        assert python.tokenize_ids(text) == want, text[:80]
        if ref.tokenize_ids(text) != want:
            ref_paths_differ += 1
            assert any(ord(c) >= 0x80 or c == "\x00" for c in text), text[:80]
    if ref._native is not None:            # tpu_rag's C++ path keeps non-ASCII punctuation
        assert ref_paths_differ >= 2
    long_text = " ".join(p.read_text(encoding="utf-8") for p in DOCS[:40])
    assert native.tokenize_ids(long_text) == ref_py.tokenize_ids(long_text)
    assert len(native.tokenize_ids(long_text)) > 4096


def test_over_long_words_are_one_unk():
    tok = WordPieceTokenizer(VOCAB)
    assert tok.tokenize_ids("a" * 101) == [tok.unk_id]
    assert tok.tokenize_ids("a" * 100) == _python_of(WordPieceTokenizer(VOCAB)).tokenize_ids(
        "a" * 100)


def test_threads_share_one_native_tokenizer():
    tok = WordPieceTokenizer(VOCAB)
    texts = [p.read_text(encoding="utf-8") for p in DOCS[:64]]
    want = [tok.tokenize_ids(t) for t in texts]
    got, errors = {}, []

    def work(i):
        try:
            got[i] = [tok.tokenize_ids(t) for t in texts[i::4] for _ in range(3)][::3]
        except Exception as e:        # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and not any(th.is_alive() for th in threads)
    for i in range(4):
        assert got[i] == want[i::4]


def test_fallback_to_python_is_logged_once(monkeypatch, caplog):
    def broken(_path):
        raise RuntimeError("g++ failed on native/wordpiece.cc (exit 1)")

    monkeypatch.setattr(binding, "NativeWordPiece", broken)
    monkeypatch.setattr(tz, "_fallbacks_logged", set())
    with caplog.at_level(logging.WARNING, logger="tpu_rag_torch"):
        toks = [WordPieceTokenizer(VOCAB) for _ in range(3)]
    assert [t.backend for t in toks] == ["python"] * 3
    logged = [r for r in caplog.records if "native WordPiece not used" in r.getMessage()]
    assert len(logged) == 1 and "g++ failed" in logged[0].getMessage()
    assert toks[0].tokenize_ids("the moon temple") == \
        _python_of(JaxWordPiece(VOCAB)).tokenize_ids("the moon temple")


def test_vocab_the_two_paths_would_read_apart_stays_in_python(tmp_path, caplog):
    dup = tmp_path / "dup.txt"
    dup.write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nmoon\nmoon\ntemple\n", encoding="utf-8")
    with caplog.at_level(logging.WARNING, logger="tpu_rag_torch"):
        tok = WordPieceTokenizer(dup)
    assert tok.backend == "python"
    assert tok.tokenize_ids("moon temple") == _python_of(JaxWordPiece(dup)).tokenize_ids(
        "moon temple") == [5, 6]
    assert WordPieceTokenizer(VOCAB, max_word_chars=50).backend == "python"


def test_library_builds_under_a_hashed_name_outside_the_package():
    for name in ("wordpiece", "hnsw"):
        binding.load(name)
        path = binding.library_path(name)
        assert path.is_file() and path.parent.name == "tpu_rag_torch"
        assert path.parent.parent.name == "build" and name in path.name
    assert not list((REPO / "tpu_rag_torch" / "native").glob("*.so"))
    # a tokenizer call keeps the interpreter lock: released, each call would
    # wait a busy thread's switch interval to get it back
    assert isinstance(binding.load("wordpiece"), ctypes.PyDLL)
    assert not isinstance(binding.load("hnsw"), ctypes.PyDLL)


def test_hnsw_matches_tpu_rag():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    q = rng.standard_normal((100, 64)).astype(np.float32)
    mine, ref = CpuHnswIndex(64, 2000, m=16, ef_construction=100, seed=100), \
        JaxHnsw(64, 2000, m=16, ef_construction=100, seed=100)
    mine.add(x)
    ref.add(x)
    assert len(mine) == len(ref) == 2000
    for ef in (16, 64):
        ids, dist = mine.search(q, 10, ef=ef, n_threads=2)
        ref_ids, ref_dist = ref.search(q, 10, ef=ef, n_threads=2)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(dist, ref_dist)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :10]
    ids, _ = mine.search(q, 10, ef=64)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)]) >= 0.9


def test_hnsw_roundtrip_and_input_checks(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    idx = CpuHnswIndex(32, 500)
    idx.add(x, ids=np.arange(1000, 1500))
    ids, dist = idx.search(x[:5], 3)
    assert ids[:, 0].tolist() == list(range(1000, 1005))
    idx.save(str(tmp_path / "g.bin"))
    back = CpuHnswIndex.load(str(tmp_path / "g.bin"))
    assert back.dim == 32 and len(back) == 500
    ids2, dist2 = back.search(x[:5], 3)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(dist, dist2)
    ref = JaxHnsw.load(str(tmp_path / "g.bin"))            # tpu_rag reads the port's file
    np.testing.assert_array_equal(ref.search(x[:5], 3)[0], ids)
    with pytest.raises(ValueError):
        idx.search(np.zeros((2, 16), np.float32), 3)
    with pytest.raises(ValueError):
        idx.add(np.zeros((2, 16), np.float32))
    with pytest.raises(RuntimeError, match="full"):
        CpuHnswIndex(32, 4).add(x[:5])
