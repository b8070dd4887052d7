"""The readings a cell's limits are set from, taken on the card at the
cell's own size.

    python -m benchmark.calibrate --workload <name> --seeds 12 [--first 1] [--controls 3] [--faults 3]

For each seed the program's readings, as a run takes them (a train cell's
checked steps through its set-up; one sampling call of a sample cell's
window), against the reference's: the sound numbers, whose largest over
the seeds is each number's lower reading. On the first ``--controls``
seeds the control against the reference: the reference itself in the
precision below the cell's (fp8 operands for bf16; for f32 with TF32 off,
TF32 products and the sampler's arithmetic in bf16). On the
first ``--faults`` seeds each fault of :mod:`benchmark.faults`, planted in
the program. Prints a JSON line a reading and, last, a summary: the
largest sound reading and the smallest control and fault reading of each
number.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import compare, faults, harness
from benchmark.reference.layers import Precision

DRIVERS = harness.HERE / "drivers"


def train_readings(cell, s, dev, control: bool, planted: list) -> list:
    drv = harness.load_module(DRIVERS / "train.py")
    out = []

    def program(fault=None):
        trainer, data, u8, w, _ = drv.setup(cell, s, dev)
        if fault:
            faults.plant(trainer, fault, "train")
        prog, _ = drv.check_steps(trainer, data, w, cell.traffic["check_steps"])
        del trainer, data, w
        harness.Device(dev).free()
        return prog, u8

    prog, u8 = program()
    ref = drv.reference(cell, s, u8, dev, Precision("f32"))
    out.append(("sound", compare.train_numbers(prog, ref)))
    if control:
        out.append(("control", compare.train_numbers(drv.reference(cell, s, u8, dev, Precision("fp8")), ref)))
    for fault in planted:
        out.append((fault, compare.train_numbers(program(fault)[0], ref)))
    return out


def sample_readings(cell, s, dev, control: bool, planted: list) -> list:
    drv = harness.load_module(DRIVERS / "sample.py")
    tr = cell.traffic
    j, rows = drv.pick(s, 1, tr["batch"], tr["check_rows"])
    out = []

    def program(fault=None):
        trainer, schedule, records = drv.setup(cell, s, dev)
        if fault:
            faults.plant(trainer, fault, "sample")
        gen = torch.Generator(device=dev).manual_seed(s["sample"])
        drv.call(trainer, gen, tr["batch"], schedule, records, harness.Device(dev))
        record = records.done[0]
        del trainer, records
        harness.Device(dev).free()
        return record

    record = program()
    out.append(("sound", drv.reference(cell, s, record, j, rows, dev)))
    if control:
        out.append(("control", drv.reference(cell, s, record, j, rows, dev, control=True)))
    del record
    for fault in planted:
        out.append((fault, drv.reference(cell, s, program(fault), j, rows, dev)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first", type=int, default=1)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    driver = cell.traffic["driver"]
    names = faults.TRAIN if driver == "train" else faults.SAMPLE
    readings = train_readings if driver == "train" else sample_readings
    summary: dict = {}
    for i in range(args.seeds):
        seed = args.first + i
        for what, numbers in readings(cell, harness.seeds(seed), dev, i < args.controls,
                                      list(names) if i < args.faults else []):
            print(json.dumps({"workload": cell.name, "seed": seed, "what": what, **numbers}), flush=True)
            for k, v in numbers.items():
                pick = max if what == "sound" else min
                key = f"{what}.{k}"
                summary[key] = pick(summary.get(key, v), v)
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
