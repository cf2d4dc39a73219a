"""perfbench's own tests: `python -m pytest perfbench/tests -q` (CPU, small
widths); tests marked `card` need a CUDA card and skip without one
(`python -m pytest perfbench/tests -m card` on the chip)."""

import json
import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 128, "vocab_size": 1700, "max_position_embeddings": 256}
TINY_TRAIN = {"batch": 16, "doc_len": 64, "query_len": 24, "warmup": 2, "steps": 10}
TINY_TRAFFIC = {"docs": 300}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs on the chip")
    return torch.device("cuda:0")


def tiny_parts(workload: str):
    """(root, bench, cell, cfg, traffic) of a cell at the tests' small widths."""
    from perfbench import harness

    bench = harness.load_bench(ROOT)
    cell = harness.cell_of(bench, workload)
    cfg = json.loads((harness.PKG / "configs" / f"{cell['config']}.json").read_text())
    cfg.update(TINY)
    if "train" in cfg:
        cfg["train"].update(TINY_TRAIN)
    tr = harness.traffic_of(harness.PKG, cell["traffic"])
    tr.update(TINY_TRAFFIC)
    return ROOT, bench, cell, cfg, tr


def tiny_run(workload: str, seed: int = 2**31 + 77, seconds: float = 2.0) -> dict:
    """One run of the cell on the CPU at small widths, through the
    harness's execute() (everything but run.py's look for a card)."""
    import torch

    from perfbench import harness

    root, bench, cell, cfg, tr = tiny_parts(workload)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(bench=bench, pkg=harness.PKG, workload=workload,
                              cell=cell, cfg=cfg, traffic=tr,
                              limits=harness.limits_of(harness.PKG, workload), seed=seed,
                              seconds=seconds, trace=False, device=torch.device("cpu"),
                              tmpdir=tmp, t_start=time.monotonic(), log=lambda *a: None)
        return harness.execute(ctx)
