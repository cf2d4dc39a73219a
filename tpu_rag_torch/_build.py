"""Build and bind the hand-written CUDA kernels under csrc/.

Each `csrc/<name>.cu` compiles on first use into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/tpu_rag_torch/lib<name>-<hash>.so csrc/<name>.cu

`build_all()` builds every source at once, one nvcc process each;
`load(name)` builds only the library it loads, and `prebuild(name)` starts
that build in a background thread, so that it overlaps a caller's set-up.
The file name carries a hash of the sources, the headers (csrc/*.cuh and
csrc/layout.h) and the flags, so an edited kernel or layout is rebuilt and
a stale library is never loaded.  The libraries are loaded with ctypes: pointers and
the CUDA stream pass as c_void_p, and every C entry returns
cudaGetLastError(), which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpu_rag_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: the sources the last build that compiled anything compiled
last_build: dict[str, list[str]] = {"compiled": []}
#: each source's nvcc seconds, where this process compiled it
build_seconds: dict[str, float] = {}
_prebuilt: set[str] = set()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_rag_torch "
                       "need the CUDA toolkit (set NVCC or put nvcc on PATH)")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh")), *sorted(CSRC.glob("*.h"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu without an up-to-date library, all in
    parallel; raise with nvcc's output if any fails.  Returns name -> path."""
    return _compile(sorted(CSRC.glob("*.cu")))


def _compile(sources: list[Path]) -> dict[str, Path]:
    """build_all() of these sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        out = _library_path(src)
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_seconds[src.stem] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if jobs:
        last_build["compiled"] = [src.name for src, *_ in jobs]
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {src.stem: _library_path(src) for src in sources}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built first where it is not
    up to date)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_compile([CSRC / f"{name}.cu"])[name]))
        return _libs[name]


def prebuild(name: str) -> None:
    """Start load(name) in a background thread, once a process; a later
    load() waits for it, and repeats and reports a build that failed."""
    with _lock:
        if name in _libs or name in _prebuilt:
            return
        _prebuilt.add(name)

    def run() -> None:
        try:
            load(name)
        except Exception:  # noqa: BLE001 - load() in the caller reports it
            pass

    threading.Thread(target=run, name=f"build-{name}", daemon=True).start()


def function(lib_name: str, fn_name: str, argtypes: list):
    """A C entry of a kernel library with its argtypes set; returns int."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str, lib_name: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if err != 0:
        to_str = load(lib_name).tr_error_string
        to_str.argtypes = [ctypes.c_int]
        to_str.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({to_str(err).decode(errors='replace')})")


P = ctypes.c_void_p
I = ctypes.c_int
