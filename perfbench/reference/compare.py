"""The numbers that decide ``correct``, each held against a limit.

Serving (an answer is a (1, H, W) map a frame):
- ``rel_rms``: the RMS of the served maps' gap to the reference over every
  compared frame, over the reference's RMS;
- ``worst_row``: the largest one frame's RMS gap, over the same reference
  RMS (one frame cut from the wrong row or zeroed shows here).

Training (the first steps of the program and of the reference from one
state on the same rows, at the recipe's warm-up rates):
- ``loss_gap``: the worst step's relative gap of the loss;
- ``grad_gap``: the first gradient with its decay term, as Adam takes it;
- ``change_gap``: the parameters' change after the compared steps;
- ``stats_gap``: the BatchNorm running statistics' change after them.
The last three compare norms by leaf, worst leaf: |‖program‖ - ‖reference‖|
over the larger of the reference's norm of that leaf and of the median
leaf.  ``change_gap`` leaves out leaves whose reference gradient (without
the decay term) is under a thousandth of the median leaf's: a conv bias
ahead of a train-mode BatchNorm has a gradient of nought up to rounding.
"""

from __future__ import annotations

import math

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _worst(values) -> float:
    """The largest value; inf if any is not finite (NaN included)."""
    vals = list(values)
    return max(vals) if vals and all(math.isfinite(v) for v in vals) else math.inf


def serving_numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """``out`` and ``ref``: (N, 1, H, W) on one device; float64 sums."""
    if out.shape != ref.shape:
        return {"rel_rms": math.inf, "worst_row": math.inf}
    d = (out.double() - ref.double()).flatten(1)
    r = ref.double().flatten(1)
    ref_ms = float(r.square().mean())
    if not ref_ms > 0:  # an all-zero reference judges nothing
        return {"rel_rms": math.inf, "worst_row": math.inf}
    return {"rel_rms": _finite(math.sqrt(float(d.square().mean()) / ref_ms)),
            "worst_row": _finite(math.sqrt(float(d.square().mean(dim=1).max()) / ref_ms))}


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    names = [k for k in ref if leaves is None or k in leaves]
    if not names or set(names) - set(prog):
        return math.inf
    rn = {k: float(ref[k].double().norm()) for k in names}
    pn = {k: float(prog[k].double().norm()) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    return _worst(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad": {name: g}, "change":
    {name: dp}, "stats": {name: ds}}; ``ref`` also "raw_grad" (no decay)."""
    steps = len(ref["losses"])
    losses = (list(prog["losses"]) + [math.nan] * steps)[:steps]
    loss_gap = _worst(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref["losses"]))
    raw = {k: float(g.double().norm()) for k, g in ref["raw_grad"].items()}
    med = sorted(raw.values())[len(raw) // 2]
    moving = {k for k, n in raw.items() if n >= NEGLIGIBLE_GRAD * med}
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moving),
            "stats_gap": leaf_gap(prog["stats"], ref["stats"])}


def judge(numbers: dict, limits: dict) -> bool:
    """Every limit met (a missing or non-finite number fails)."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
