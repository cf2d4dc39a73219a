"""The numbers that decide `correct`: what the timed path produced, held
against the plain reference.  Pure functions of the two sides' readings,
shared by the drivers, the control (control.py) and the tests."""

from __future__ import annotations

import math

import numpy as np


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep: list[str]) -> tuple[float, str]:
    """Worst leaf's |prog norm - ref norm| over the larger of the
    reference's norm of that leaf and the median leaf's; (gap, leaf)."""
    med = float(np.median([ref[k] for k in keep]))
    worst, at = 0.0, ""
    for name in keep:
        g = abs(prog[name] - ref[name]) / max(ref[name], med, 1e-30)
        if not math.isfinite(g):
            return float("inf"), name
        if g > worst:
            worst, at = g, name
    return worst, at


def kept_leaves(ref_grad: dict[str, float], floor: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least `floor` of the median leaf's (a key bias under softmax has none)."""
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= floor * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses": [3 floats], "grad": {leaf: norm of the
    first gradient}, "update": {leaf: norm of the change after three
    steps}}.

    loss_gap    widest |loss - ref loss| / |ref loss| over the steps;
    grad_gap    worst leaf of the first gradient's norm (leaf_gaps);
    update_gap  worst leaf of the three steps' change."""
    keep = kept_leaves(ref["grad"])
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else float("inf")
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = leaf_gaps(prog["grad"], ref["grad"], keep)
    upd_gap, upd_leaf = leaf_gaps(prog["update"], ref["update"], keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": upd_gap,
            "grad_leaf": grad_leaf, "update_leaf": upd_leaf,
            "leaves_left_out": sorted(set(ref["grad"]) - set(keep))}
