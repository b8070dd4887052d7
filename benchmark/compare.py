"""The numbers that decide ``correct``, from the program's readings and the
reference's.

A train cell compares each checked step's loss (relative gap, the largest
over the steps) and, leaf by leaf, the first step's clipped gradients and
the parameters' and the EMA's change over the checked steps, each against
the larger of the reference's norm of that leaf and of the median leaf:

- ``grad``: the gap between the program's gradient norm and the
  reference's, by the worst leaf;
- ``grad_diff``: the norm of the difference between the program's gradient
  and the reference's, by the worst leaf, which sees a gradient whose norm
  is right and whose direction is not (a step over half the batch);
- ``change_median``, ``ema_change_median``: the gap between the norms of
  the changes, by the median leaf (a leaf of a few elements whose gradient
  changes sign between steps moves under Adam by noise that a worst leaf
  would read). Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone (a key's bias under softmax)
  and are left out of the changes.

A sample cell's numbers come from the reference's step-by-step check
(:func:`benchmark.reference.steps.sample_check`). A cell's limits file
names the numbers it compares.
"""

from __future__ import annotations

import statistics

import torch

STILL = 1e-3


def _gaps(prog: dict, ref: dict, names) -> list:
    floor = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names]


def _diff_norms(prog: dict, ref: dict) -> dict:
    return {n: float(torch.linalg.vector_norm((prog[n].double() - ref[n].double()))) for n in ref}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``loss`` (a list), ``grad``, ``change`` and
    ``ema_change`` (norms by leaf), ``grads`` (the first step's clipped
    gradients by leaf, on the host)."""
    losses = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    floor = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= STILL * floor]
    diff = _diff_norms(prog["grads"], ref["grads"])
    out = {"loss": losses, "grad": max(_gaps(prog["grad"], ref["grad"], ref["grad"])),
           "grad_diff": max(diff[n] / max(g, floor) for n, g in ref["grad"].items())}
    for key in ("change", "ema_change"):
        out[f"{key}_median"] = statistics.median(_gaps(prog[key], ref[key], moving))
    return out


def compared(numbers: dict, limits: dict) -> dict:
    """The numbers a cell compares (those its limits name), each present."""
    return {k: numbers.get(k, float("nan")) for k in limits}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name at or under its limit (a number that is
    missing or not finite fails)."""
    return all(v <= limits[k] for k, v in compared(numbers, limits).items())
