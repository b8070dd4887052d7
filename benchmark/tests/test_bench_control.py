"""The control of each cell, on the card at the cell's own size: the
reference in the precision below the cell's (fp8 operands for the bf16
train cells, TF32 for the f32 sample cells) put in the program's place
comes out not correct under the cell's limits, and the program on the same
seed comes out correct. Run on the card:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""

import pytest
import torch

from benchmark import calibrate, compare, harness

CELLS = ["dit-l2-in32.train-b64", "vdm-unet-c10.sample-k20-b128",
         "dit-l2-in32.sample-k20-b128"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    cell = harness.load_cell(name)
    readings = calibrate.train_readings if cell.traffic["driver"] == "train" else calibrate.sample_readings
    got = dict(readings(cell, harness.seeds(424242), torch.device("cuda", 0), True, []))
    limits = {k: v for k, v in cell.limits.items() if k != "tf32"}
    assert compare.verdict(got["sound"], limits), got["sound"]
    assert not compare.verdict(got["control"], limits), got["control"]
