"""The benchmark's cells cut to tiny widths, for runs on the CPU."""

from __future__ import annotations

import copy

from benchmark import harness

TINY_TRAFFIC = {"batch": 4, "n_train": 64, "reference_chunk": 2, "check_rows": 3}


def cell(name: str, **traffic) -> harness.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` on 8x8 images at its model
    kind's tiny sizes (``TINY``), with its traffic's sizes cut (``traffic``
    overrides them)."""
    c = harness.load_cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["data_shape"] = [8, 8, 3]
    c.config["program"]["task"]["model"].update(c.model.TINY)
    c.traffic = {**c.traffic, **{k: v for k, v in TINY_TRAFFIC.items() if k in c.traffic}, **traffic}
    if "k" in c.traffic:
        c.traffic["k"] = 3
    return c
