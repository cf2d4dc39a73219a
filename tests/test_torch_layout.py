"""The kernels' shared-memory layouts (tpu_rag_torch/csrc/layout.h), which
the CUDA kernels include and native/layout.cc builds for the host, on the
CPU: the launch plans of the main path's shapes at pinned values, every
library that includes the header named by its bytes, and nothing built
when the wrappers are imported."""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_rag_torch import _build
from tpu_rag_torch.native import binding
from tpu_rag_torch.native.binding import layout
from tpu_rag_torch.ops import ivf_probe as ip
from tpu_rag_torch.ops import topk as tk

SMS = 132  # H100 SXM
REPO = Path(__file__).resolve().parent.parent


def _scan_pins():
    """#1/#2/#3 at 1M x 384: bf16 q 1/8/64 k 20, int8 q 64 k 40 (the
    bucketed scans select nothing in the kernel: k 0)."""
    bf16 = {1: (8, 8, 7680, 131, 145664, 139520), 8: (8, 8, 7680, 131, 145664, 139520),
            64: (64, 8, 7680, 131, 228224, 186496)}
    for nq, (qc, stages, block_rows, blocks, smem, bucketed) in bf16.items():
        for mode in ("exact", "packed"):
            yield (nq, 20, torch.bfloat16, mode), (qc, stages, block_rows, blocks, smem)
        yield (nq, 0, torch.bfloat16, "bucketed"), (qc, stages, block_rows, blocks, bucketed)
    for mode in ("exact", "packed"):
        yield (64, 40, torch.int8, mode), (64, 6, 7680, 131, 222784)
    yield (64, 0, torch.int8, "bucketed"), (64, 7, 7680, 131, 212544)


@pytest.mark.parametrize("kernel", ["scan", "per_list", "batched", "attention"])
def test_main_path_plans_keep_their_values(kernel):
    """The plans of the main path's shapes, as the Python layout copies the
    header replaced computed them: every field equal."""
    lay = layout()
    if kernel == "scan":
        for (nq, k, dtype, mode), want in _scan_pins():
            assert tuple(tk._scan_plan(1_000_000, 384, nq, k, dtype, SMS, mode)) == want
        assert lay.tr_pipe_rows(384, 64, 40, tk._SCAN_MODE["exact"]) == 64
        assert lay.tr_sm_share(1) == 232_448 and lay.tr_sm_share(2) == 115_712
    elif kernel == "per_list":      # #6: q 1, nprobe 64, cap 3,968, int8, k 40
        assert tuple(ip._list_plan(1, 64, 3968, 384, torch.int8, 40, SMS)) == (
            2, 128, 4, 128, 1, 209472)
    elif kernel == "batched":       # #7: 2,048 lists of cap 3,968, int8, q 8 and 64
        assert tuple(ip._bucket_plan(2048, 31, 8, 384, torch.int8, SMS)) == (
            8, 128, 4, 132, 481, 209984)
        assert tuple(ip._bucket_plan(2048, 31, 64, 384, torch.int8, SMS)) == (
            64, 128, 4, 132, 481, 222272)
    else:                           # #5: bf16 at T 128/256/512, f32 at any T
        want = {32: ((2, 31232), (4, 52224), (8, 94208), 108288),
                64: ((2, 55808), (4, 93184), (5, 112640), 173824)}
        for d, (*tc, f32) in want.items():
            for t, (stages, smem) in zip((128, 256, 512), tc):
                assert (lay.tr_mha_stages(d, t), lay.tr_mha_smem(1, d, t)) == (stages, smem)
            assert lay.tr_mha_smem(0, d, 512) == f32


def test_a_header_edit_gives_new_library_paths(tmp_path, monkeypatch):
    """native/layout.cc's library and every kernel library are named by a
    hash that covers csrc/layout.h, so a layout edit is never served by a
    library built before it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(binding, "_HEADERS", {"layout": (csrc / "layout.h",)})

    def paths():
        return [binding.library_path("layout")] + [_build._library_path(src)
                                                   for src in sorted(csrc.glob("*.cu"))]

    before = paths()
    header = csrc / "layout.h"
    header.write_text(header.read_text() + "\n// one more line\n")
    after = paths()
    assert len(before) == 5
    assert all(a != b for a, b in zip(before, after))


def test_importing_the_wrappers_builds_nothing():
    """The train cells import ops/attention.py: the layout library builds at
    the first plan, never at import."""
    code = ("import tpu_rag_torch.ops.topk, tpu_rag_torch.ops.ivf_probe, "
            "tpu_rag_torch.ops.attention\n"
            "from tpu_rag_torch import _build\n"
            "from tpu_rag_torch.native import binding\n"
            "assert not _build._libs and not binding._libs, (_build._libs, binding._libs)\n"
            "assert binding.layout.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
