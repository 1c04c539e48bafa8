"""The comparisons that decide `correct`: the numbers a run compares with
the plain reference, each held to the limit its cell's file gives."""

from __future__ import annotations

import statistics

import torch


def leaf_gaps(prog: dict, ref: dict, leaves) -> float:
    """Worst leaf of | |prog_leaf| - |ref_leaf| | over the larger of the
    reference leaf's norm and the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    med = statistics.median(norms.values())
    worst = 0.0
    for k in leaves:
        got = float(torch.linalg.vector_norm(prog[k].double()))
        worst = max(worst, abs(got - norms[k]) / max(norms[k], med, 1e-300))
    return worst


def fit_numbers(prog: dict, ref: dict) -> dict:
    """A fit run's three numbers: the largest relative gap of the steps'
    losses, the worst leaf's gap of the first gradient's norm, and of the
    change of the scene over the steps. Leaves whose reference gradient is
    under a thousandth of the median leaf's move under Adam by round-off
    alone and are left out of the change."""
    losses = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    leaves = list(ref["grad1"])
    g_norms = {k: float(torch.linalg.vector_norm(ref["grad1"][k].double())) for k in leaves}
    med = statistics.median(g_norms.values())
    moving = [k for k in leaves if g_norms[k] >= 1e-3 * med]
    return {"loss_gap": losses,
            "grad_gap": leaf_gaps(prog["grad1"], ref["grad1"], leaves),
            "change_gap": leaf_gaps(prog["change"], ref["change"], moving)}


def late_numbers(prog: dict, ref: dict) -> dict:
    """A fit's numbers of one step followed from the state the window left:
    the relative gap of its loss, the worst leaf's gap of its gradient's
    norm, and of the change it made, under the same rules as fit_numbers."""
    g_norms = {k: float(torch.linalg.vector_norm(ref["grad"][k].double()))
               for k in ref["grad"]}
    med = statistics.median(g_norms.values())
    moving = [k for k in g_norms if g_norms[k] >= 1e-3 * med]
    return {"late_loss_gap": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
            "late_grad_gap": leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"])),
            "late_change_gap": leaf_gaps(prog["change"], ref["change"], moving)}


def sample_pixels(counts, rng, n: int, *, width: int, height: int, tiles):
    """n row-major pixel indices, each in a tile drawn by its live member
    count (the work), at a uniform place in it."""
    tx, ty = tiles
    th, tw = height // ty, width // tx
    t = rng.choice(counts.size, size=n, p=counts / counts.sum())
    r, c = rng.integers(0, th, size=n), rng.integers(0, tw, size=n)
    return ((t // tx) * th + r) * width + (t % tx) * tw + c


def pixel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest absolute gap of the checked pixels' colors."""
    return float((prog.double() - ref.double()).abs().max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    a finite reading at or under its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = float(limits[name])
        out[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, out
