"""Whole runs at tiny widths on the CPU, past the harness's look for a card,
with the timed path broken underneath: each fault a cell can have turns
``correct`` false under the cell's limits; the sound run keeps it true."""

import time

import pytest
import torch

from benchmark import compare, faults, harness
from benchmark.tests import tiny

CASES = [("dit-l2-in32.train-b64", fault) for fault in faults.TRAIN] + \
    [(cell, fault) for cell in ("vdm-unet-c10.sample-k20-b128", "dit-l2-in32.sample-k20-b128")
     for fault in faults.SAMPLE]


def run(cell, monkeypatch, fault=None):
    if fault is not None:
        build = harness.build_trainer

        def broken(*args, **kw):
            trainer = build(*args, **kw)
            faults.plant(trainer, fault, cell.traffic["driver"])
            return trainer

        monkeypatch.setattr(harness, "build_trainer", broken)
    drv = harness.load_module(harness.HERE / "drivers" / f"{cell.traffic['driver']}.py")
    out = drv.run(cell, seed=1234567, seconds=0.3, trace=False, t0=time.time(), device=torch.device("cpu"))
    return compare.verdict(out.checks, cell.limits), out.checks


@pytest.mark.parametrize("name, fault", CASES)
def test_a_fault_turns_correct_false(name, fault, monkeypatch):
    torch.manual_seed(0)
    correct, checks = run(tiny.cell(name, precision="32"), monkeypatch, fault)
    assert not correct, checks


@pytest.mark.parametrize("name", ["vdm-unet-c10.sample-k20-b128", "dit-l2-in32.sample-k20-b128",
                                  "dit-l2-in32.train-b64"])
def test_the_sound_run_is_correct(name, monkeypatch):
    correct, checks = run(tiny.cell(name, precision="32"), monkeypatch)
    assert correct, checks
