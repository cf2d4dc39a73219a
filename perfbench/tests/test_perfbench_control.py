"""The control (the reference in float8 in the program's place) fails the
cell's limits: at the cell's own sizes on the card, and at small widths on
the CPU it reads far above the port's own f32 run there."""

import pytest
import torch
from conftest import ROOT, tiny_parts, tiny_run

from perfbench import control, harness

CELLS = tuple(c["name"] for c in harness.load_bench(ROOT)["workloads"])


def _fails(limits: dict, readings: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items() if k in readings)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, cell):
    limits = harness.limits_of(harness.PKG, cell)
    for seed in (11, 2**31 + 11, 3_000_000_011):
        got = control.readings(ROOT, cell, seed, card)
        assert _fails(limits, got["control"]), (seed, got)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_a_sound_run_on_the_cpu(cell):
    root, _, _, cfg, tr = tiny_parts(cell)
    ctl = control.readings(root, cell, 7, torch.device("cpu"), cfg, tr)["control"]
    sound = tiny_run(cell, seed=7)["checks"]
    keys = [k for k in ctl if k in sound]
    assert keys and max(ctl[k] / max(sound[k]["value"], 1e-7) for k in keys) > 100
