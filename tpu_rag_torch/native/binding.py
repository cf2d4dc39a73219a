"""Build and bind the host C++ libraries of the port: the WordPiece
tokenizer (wordpiece.cc) and the HNSW baseline (hnsw.cc), both copies of
tpu_rag/native/, and the hand-written kernels' shared-memory layouts
(layout.cc over csrc/layout.h, the header the kernels include) for the
wrappers' launch plans.

Each source compiles with g++ on first use into build/tpu_rag_torch/
(beside the CUDA kernels, ignored by git), never into the package:

    g++ -O2 -std=c++17 -fPIC -Wall -shared -o lib<name>-<hash>.so <name>.cc

The file name carries a hash of the source, the headers it includes from
csrc/ and the flags, so an edited source or header is rebuilt and a stale
library never loads; a build writes a temporary name and renames it, so
concurrent processes never load a half-written file.  hnsw.cc adds -O3
and -lpthread but not tpu_rag's -march=native: the build directory
travels with copies of the tree, and a library tuned to one host's CPU may
not run on another's (the two builds give equal ids and distances).

NativeWordPiece tokenizes exactly as models/tokenizer.py's pretokenize +
WordPiece in Python: the text is NFKC-normalized and lowercased here, and
every run of characters that are neither word characters (str.isalnum()
or "_", which is re's \\w) nor in the CJK ranges becomes one space, so the
C++ splitter, which treats every non-ASCII character as a word character,
splits where the Python one does.  tpu_rag's own binding passes the raw
text, so tpu_rag's C++ path keeps full-width and other non-ASCII
punctuation inside words where its Python path drops it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import unicodedata
from pathlib import Path

from tpu_rag_torch._build import BUILD_DIR, CSRC

HERE = Path(__file__).resolve().parent
_FLAGS = {"wordpiece": ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"),
          "hnsw": ("-O2", "-std=c++17", "-fPIC", "-Wall", "-O3", "-shared"),
          "layout": ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")}
_LIBS_AFTER = {"hnsw": ("-lpthread",)}
_HEADERS = {"layout": (CSRC / "layout.h",)}
# a tokenizer call takes microseconds: it keeps the interpreter lock
# (PyDLL), since a call that releases it waits for a busy thread's switch
# interval to get it back (55x slower with one busy thread beside it);
# HNSW's builds and batched searches run long and release it (CDLL); a
# layout call takes microseconds too
_LOADER = {"wordpiece": ctypes.PyDLL, "hnsw": ctypes.CDLL, "layout": ctypes.PyDLL}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where native/<name>.cc builds: a name carrying the hash of the
    source and of the headers it includes."""
    h = hashlib.sha256(" ".join(_FLAGS[name] + _LIBS_AFTER.get(name, ())).encode())
    for f in (HERE / f"{name}.cc", *_HEADERS.get(name, ())):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of native/<name>.cc, built with g++ if missing;
    raises RuntimeError with the compiler's output if it does not build."""
    with _lock:
        if name in _libs:
            return _libs[name]
        out = library_path(name)
        if not out.is_file():
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if not cxx:
                raise RuntimeError(f"no C++ compiler (g++) to build native/{name}.cc")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [cxx, *_FLAGS[name], "-o", str(tmp), str(HERE / f"{name}.cc"),
                 *_LIBS_AFTER.get(name, ())],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on native/{name}.cc "
                                   f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        _libs[name] = _LOADER[name](str(out))
        return _libs[name]


def _wordpiece_lib() -> ctypes.CDLL:
    lib = load("wordpiece")
    lib.wp_create.argtypes = [ctypes.c_char_p]
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_free.restype = None
    lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.wp_tokenize.restype = ctypes.c_int
    return lib


# native/layout.cc's entries: name -> number of int arguments (each returns an int)
_LAYOUT_ARGS = {"tr_sm_share": 1, "tr_box_route": 1, "tr_pipe_rows": 4, "tr_scan_fit": 5,
                "tr_scan_smem": 6, "tr_bucket_rows": 3, "tr_bucket_mtw": 2, "tr_bucket_wr": 2,
                "tr_bucket_fit": 3, "tr_bucket_smem": 4, "tr_list_rows": 4, "tr_list_fit": 5,
                "tr_list_smem": 5, "tr_mha_stages": 2, "tr_mha_smem": 3}


@functools.lru_cache(maxsize=None)
def layout() -> ctypes.CDLL:
    """csrc/layout.h's kernel layouts through native/layout.cc (built with
    g++ at the first call): the byte counts and the choices made from them
    that the launch plans of ops/topk.py and ops/ivf_probe.py read."""
    lib = load("layout")
    for name, n_args in _LAYOUT_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * n_args
        fn.restype = ctypes.c_int
    return lib


# runs of characters pretokenize splits on: not a word character and not CJK
# (the CJK ranges of models/tokenizer.py's _is_cjk stay, assigned or not)
_SPLIT = re.compile(r"[^\w\u4e00-\u9fff\u3400-\u4dbf\uf900-\ufaff\u3040-\u30ff\uac00-\ud7af]+")


class NativeWordPiece:
    """Greedy longest-match WordPiece over a vocab.txt in C++ (words longer
    than 100 characters give [UNK], as WordPieceTokenizer's default)."""

    MAX_WORD_CHARS = 100

    def __init__(self, vocab_path: str) -> None:
        self._lib = _wordpiece_lib()
        self._handle = self._lib.wp_create(str(vocab_path).encode("utf-8"))
        if not self._handle:
            raise RuntimeError(f"wp_create failed for {vocab_path}")

    def tokenize_ids(self, text: str) -> list[int]:
        text = _SPLIT.sub(" ", unicodedata.normalize("NFKC", text).lower())
        # every id takes at least one character: a buffer of len(text) + 1
        # is never cut short
        cap = len(text) + 1
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.wp_tokenize(self._handle, text.encode("utf-8"), buf, cap)
        if n < 0:
            raise RuntimeError("wp_tokenize failed")
        return buf[:n]

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.wp_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
